"""Where two equal lanes of one batch part ways on the card.

    python3 -m clap2diffusion_tpu_torch.tools.probe_lane_bits [--variants default,cudnn_det]

A request with ``seeds=[5, 5]`` feeds its two lanes the same latents and
the same conditioning, yet on an H100 its two images may differ. This
probe runs the pieces of such a request (full SD v1.5 width, bf16, random
weights from seed 0, as ``chip_smoke.py`` phase 3c) with two equal lanes,
hooks every leaf module, and prints, in the order they ran, the modules
whose input lanes were equal and whose output lanes were not (the first
place a batch position changes the bits), and the first module whose input
lanes differ (functional code before it may have parted them). Each variant sets PyTorch's
backend switches before the run (``cudnn_det``: ``cudnn.deterministic``;
``no_reduced``: no reduced-precision bf16 reductions in cuBLAS). Needs one
CUDA card; prints one JSON line a variant and the card's name.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from clap2diffusion_tpu_torch.core.config import Config
from clap2diffusion_tpu_torch.diffusion.ddim import cfg_eps_fn
from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline
from clap2diffusion_tpu_torch.models.clap.frontend import log_mel_spectrogram
from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer

VARIANTS = {
    "default": {},
    "cudnn_det": {"cudnn.deterministic": True},
    "no_reduced": {"matmul.allow_bf16_reduced_precision_reduction": False},
}


def _set(switches):
    torch.backends.cudnn.deterministic = switches.get("cudnn.deterministic", False)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = switches.get(
        "matmul.allow_bf16_reduced_precision_reduction", True)


def _lanes_equal(t, pairs):
    return all(torch.equal(t[a], t[b]) for a, b in pairs)


def _hook_all(root, prefix, pairs, log):
    handles = []
    for name, mod in root.named_modules():
        if list(mod.children()):
            continue

        def hook(m, args, out, name=name):
            x = args[0] if args and isinstance(args[0], torch.Tensor) else None
            if not isinstance(out, torch.Tensor) or x is None or x.shape[0] < 2:
                return
            same_in = _lanes_equal(x, pairs)
            if not same_in and not log["unequal_input"]:
                # lanes parted in functional code between hooked modules
                log["unequal_input"].append(f"{prefix}.{name}")
            if same_in and not _lanes_equal(out, pairs):
                d = max((out[a].float() - out[b].float()).abs().max().item() for a, b in pairs)
                log["parting"].append({"module": f"{prefix}.{name}", "type": type(m).__name__,
                                       "in": list(x.shape), "out": list(out.shape),
                                       "max_abs_diff": d})
        handles.append(mod.register_forward_hook(hook))
    return handles


@torch.inference_mode()
def probe(pipe, switches):
    _set(switches)
    cfg = pipe.cfg
    tok = CLIPTokenizer(max_length=cfg.diffusion.clip_text.max_length)
    t = np.arange(int(cfg.clap.frontend.num_samples)) / cfg.clap.frontend.sample_rate
    wav = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    lat = cfg.diffusion.image_size // 8
    log = {"parting": [], "unequal_input": []}
    # the towers at batch 2 (two equal rows), then the UNet at CFG batch 4
    # ([u, u, c, c]) and the VAE decoder at batch 2
    handles = []
    for prefix, mod in (("hierarchical", pipe.hierarchical), ("clip_text", pipe.clip_text),
                        ("vae", pipe.vae)):
        handles += _hook_all(mod, prefix, [(0, 1)], log)
    handles += _hook_all(pipe.unet, "unet", [(0, 1), (2, 3)], log)
    try:
        wf = torch.as_tensor(wav[None], device=pipe.device)
        emb = pipe.clap_audio(log_mel_spectrogram(wf, cfg.clap.frontend)).expand(2, -1)
        _, routed = pipe._condition(emb.contiguous(), "hierarchical", 60.0, 0.5)
        ids = torch.as_tensor(np.concatenate([tok(["rain"] * 2), tok([""] * 2)]),
                              device=pipe.device)
        cond, uncond = pipe.clip_text(ids).chunk(2)
        eps_fn = cfg_eps_fn(pipe.unet, cond, uncond, 7.5, routed, routed)
        x = pipe.draws(5).latents((1, lat, lat, 4)).to(pipe.compute_dtype).repeat(2, 1, 1, 1)
        eps = eps_fn(x, 981)
        img = pipe.vae.decode_latent(x)
    finally:
        for h in handles:
            h.remove()
    return {"switches": switches, "eps_lanes_equal": _lanes_equal(eps, [(0, 1)]),
            "eps_max_abs_diff": (eps[0] - eps[1]).abs().max().item(),
            "decode_lanes_equal": _lanes_equal(img, [(0, 1)]),
            "modules_parting_lanes": len(log["parting"]), "first": log["parting"][:12],
            "first_module_with_unequal_input_lanes": log["unequal_input"]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="default,cudnn_det,no_reduced")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_lane_bits: needs a CUDA card")
    pipe = AudioToImagePipeline(Config(), seed=0, device="cuda", dtype=torch.bfloat16)
    for name in args.variants.split(","):
        print(json.dumps({"variant": name, **probe(pipe, VARIANTS[name])}), flush=True)
    _set({})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
