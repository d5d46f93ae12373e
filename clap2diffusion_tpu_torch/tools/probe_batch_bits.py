"""Where a batch built from stacked copies of one waveform parts from the
same batch built from one expanded row, on the card.

    python3 -m clap2diffusion_tpu_torch.tools.probe_batch_bits

``generate(waveform=w, batch=2)`` encodes ``w`` once and expands the CLAP
embedding to both lanes; ``generate(waveform=np.stack([w, w]), batch=2)``
encodes two equal rows. This probe runs the conditioning path of both
(full SD v1.5 width, bf16, random weights from seed 0, as ``chip_smoke.py``
phase 3) with every leaf module of the CLAP tower and the hierarchical
encoder hooked, and prints the first module whose input rows are equal in
the two runs and whose output rows are not, with the largest difference of
the log-mel, the CLAP embedding, the 77 tokens and the routed tokens (after
Norm-60). The log-mel is functional code (``frontend.py``: two fp32
matmuls between exact steps), so each of its matmuls is also run at both
batches on equal rows. Needs one CUDA card; prints one JSON line and the
card's name.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from clap2diffusion_tpu_torch.core.config import Config
from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline
from clap2diffusion_tpu_torch.models.clap import frontend
from clap2diffusion_tpu_torch.models.clap.frontend import log_mel_spectrogram


def _record(roots, calls):
    """Hook every leaf module of ``roots``: append (name, module type,
    input, output) of each call, in the order they run."""
    handles = []
    for prefix, root in roots:
        for name, mod in root.named_modules():
            if list(mod.children()):
                continue

            def hook(m, args, out, name=f"{prefix}.{name}"):
                x = args[0] if args and isinstance(args[0], torch.Tensor) else None
                if isinstance(out, torch.Tensor) and x is not None:
                    calls.append((name, type(m).__name__, x.detach().clone(),
                                  out.detach().clone()))
            handles.append(mod.register_forward_hook(hook))
    return handles


def _diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _frontend_matmuls(one: torch.Tensor, fe) -> dict:
    """The log-mel's two matmuls on equal rows at batch 1 and at batch 2:
    the windowed DFT of the frames, then the filterbank of the power."""
    dft, fb = frontend.mel_constants(fe, one.device)
    pad = fe.n_fft // 2
    x = torch.nn.functional.pad(one[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, fe.n_fft, fe.hop_length)  # [1, F, n_fft]
    spec1, spec2 = torch.matmul(frames, dft), torch.matmul(frames.repeat(2, 1, 1), dft)
    bins = fe.n_fft // 2 + 1
    power = spec1[..., :bins] ** 2 + spec1[..., bins:] ** 2
    mel1, mel2 = torch.matmul(power, fb), torch.matmul(power.repeat(2, 1, 1), fb)
    return {"dft_matmul": {"shape": [list(frames.shape), list(dft.shape)],
                           "bit_equal": torch.equal(spec1[0], spec2[0]),
                           "max_abs_diff": _diff(spec1[0], spec2[0])},
            "filterbank_matmul": {"shape": [list(power.shape), list(fb.shape)],
                                  "bit_equal": torch.equal(mel1[0], mel2[0]),
                                  "max_abs_diff": _diff(mel1[0], mel2[0])}}


@torch.inference_mode()
def probe(pipe) -> dict:
    cfg = pipe.cfg
    fe = cfg.clap.frontend
    t = np.arange(fe.num_samples) / fe.sample_rate
    wav = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 97 * t)).astype(np.float32)
    one = torch.as_tensor(wav[None], device=pipe.device)
    runs = {}
    for kind in ("expanded", "stacked"):
        calls = []
        handles = _record((("clap_audio", pipe.clap_audio), ("hierarchical", pipe.hierarchical)),
                          calls)
        try:
            wf = one if kind == "expanded" else one.repeat(2, 1)
            mel = log_mel_spectrogram(wf, fe)
            emb = pipe.clap_audio(mel)
            emb = emb.expand(2, -1) if kind == "expanded" else emb
            tokens77, routed = pipe._condition(emb, "hierarchical", 60.0, 0.5)
        finally:
            for h in handles:
                h.remove()
        runs[kind] = dict(mel=mel, emb=emb, tokens77=tokens77, routed=routed, calls=calls)
    a, b = runs["expanded"], runs["stacked"]
    first = None
    for (name, kind, xa, ya), (_, _, xb, yb) in zip(a["calls"], b["calls"]):
        if torch.equal(xa[:1], xb[:1]) and not torch.equal(ya[:1], yb[:1]):
            first = {"module": name, "type": kind, "in": [list(xa.shape), list(xb.shape)],
                     "max_abs_diff": _diff(ya[:1], yb[:1])}
            break
    return {
        "log_mel_equal": torch.equal(a["mel"][0], b["mel"][0]),
        "log_mel_max_abs_diff": _diff(a["mel"][0], b["mel"][0]),
        "clap_embedding_max_abs_diff": _diff(a["emb"], b["emb"]),
        "tokens77_max_abs_diff": _diff(a["tokens77"], b["tokens77"]),
        "routed_max_abs_diff": max(_diff(a["routed"][k], b["routed"][k]) for k in a["routed"]),
        "stacked_rows_equal": torch.equal(b["emb"][0], b["emb"][1]),
        "first_module_parting": first,
        "log_mel_matmuls_batch_1_vs_2": _frontend_matmuls(one, fe),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_batch_bits: needs a CUDA card")
    pipe = AudioToImagePipeline(Config(), seed=0, device="cuda", dtype=torch.bfloat16)
    print(json.dumps({"probe": "batch_bits", **probe(pipe)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
