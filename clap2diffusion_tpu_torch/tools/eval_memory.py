"""Device memory of the evaluator's metric towers and of one serving
request; the counterpart of the JAX package's ``tools/eval_memory.py``.

    python -m clap2diffusion_tpu_torch.tools.eval_memory [--device cpu]

Programs, at the JAX tool's shapes (``run_evaluation``'s batch of 16), the
towers in fp32 as ``run_evaluation`` runs them (ROADMAP known delta 18):

  inception_v3   pool3 and logits of [16, 299, 299, 3] pixels (torchvision
                 variant, channels-last kernels, as ``build_inception``)
  clip_vision    CLIP ViT-L/14 image features of [16, 224, 224, 3]
  clap_audio     the log-mel and the HTSAT tower on [16, 480000] samples
  clap_text      the RoBERTa tower on [16, 77] ids
  request        one 512x512 image: 50-step DDIM, CFG 7.5, batch 1, bf16
                 weights (the CLAP audio and conditioning towers in fp32,
                 as the pipeline holds them), the JAX bench's inputs

One JSON line each on stdout: ``param_bytes`` (the weights: parameters and
buffers, the BatchNorm statistics among them, which JAX's ``params``
holds too), ``input_bytes``, and on the card
``resident_bytes`` (``torch.cuda.memory_allocated`` before the call:
weights, inputs and whatever the process already holds) and
``peak_bytes`` (``torch.cuda.max_memory_allocated`` over the call after
``reset_peak_memory_stats``). The JAX tool's args + temp + out is XLA's
plan for one program; ``peak_bytes`` is what PyTorch's allocator held at
most while the program ran. The request's peak is its first call's, which
runs the program once eagerly and captures it into a CUDA graph
(``diffusion/program.py``); the row adds ``graph_pool_bytes`` (what the
graphs' shared memory pool holds reserved from then on) and ``replay_peak_bytes``
(a second request, one replay: the pool's bytes are reserved, not
allocated, so they are not in it). Weights are random, drawn on the card from
seed 0 (their values do not change the bytes). With ``--device cpu`` the
modules are built on the meta device and only the bytes that can be
counted are given: the peaks are null.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from clap2diffusion_tpu_torch.tools import bench_common as B

EVAL_BATCH = 16  # run_evaluation's batched_features(batch_size=16)
TEXT_LENGTH = 77  # the RoBERTa tokenizer's ids a caption


def weight_bytes(modules) -> int:
    """Bytes of the parameters and buffers of ``modules``."""
    return sum(t.numel() * t.element_size() for m in modules
               for t in [*m.parameters(), *m.buffers()])


def towers(cfg) -> Dict[str, tuple]:
    """name -> (module factory, input shape, input type, forward(module, x))."""
    from clap2diffusion_tpu_torch.models.clap.frontend import log_mel_spectrogram
    from clap2diffusion_tpu_torch.models.clap.htsat import ClapAudioTower
    from clap2diffusion_tpu_torch.models.clap.text import ClapTextTower
    from clap2diffusion_tpu_torch.models.clip_vision import CLIPVisionEncoder
    from clap2diffusion_tpu_torch.models.inception_v3 import InceptionV3

    b, vision = EVAL_BATCH, cfg.diffusion.clip_vision
    return {
        "inception_v3": (lambda: InceptionV3().to(memory_format=torch.channels_last),
                         (b, 299, 299, 3), torch.float32, lambda m, x: m(x)),
        "clip_vision": (lambda: CLIPVisionEncoder(vision),
                        (b, vision.image_size, vision.image_size, 3), torch.float32,
                        lambda m, x: m(x)),
        "clap_audio": (lambda: ClapAudioTower(cfg.clap.audio),
                       (b, cfg.clap.frontend.num_samples), torch.float32,
                       lambda m, x: m(log_mel_spectrogram(x, cfg.clap.frontend))),
        "clap_text": (lambda: ClapTextTower(cfg.clap.text), (b, TEXT_LENGTH),
                      torch.int32, lambda m, x: m(x)),
    }


def measure(dev: torch.device, call: Callable[[], object]) -> Dict[str, int]:
    """The allocator's bytes before ``call`` and its peak during it."""
    torch.cuda.synchronize(dev)
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        call()
    torch.cuda.synchronize(dev)
    return {"resident_bytes": resident, "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def tower_row(name: str, spec, dev: torch.device) -> dict:
    from clap2diffusion_tpu_torch.diffusion.pipeline import random_init_

    factory, shape, dtype, forward = spec
    with torch.device("meta"):
        m = factory()
    row = {"program": name, "input_shape": list(shape), "dtype": "float32",
           "input_bytes": int(np.prod(shape)) * dtype.itemsize, "param_bytes": weight_bytes([m])}
    if dev.type != "cuda":
        return {**row, "resident_bytes": None, "peak_bytes": None}
    m.to_empty(device=dev)
    random_init_(m, torch.Generator(device=dev).manual_seed(0), {})
    m.eval().requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(1)
    if dtype == torch.int32:
        x = torch.randint(0, 1_000, shape, generator=gen, device=dev, dtype=dtype)
    else:
        x = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    t0 = time.perf_counter()
    row.update(measure(dev, lambda: forward(m, x)))
    row["seconds"] = time.perf_counter() - t0
    del m, x
    torch.cuda.empty_cache()
    return row


def request_row(cfg, dev: torch.device) -> dict:
    """One 50-step 512x512 bf16 request through ``generate``."""
    from clap2diffusion_tpu_torch.diffusion.pipeline import (
        CORE_TOWERS,
        FP32_TOWERS,
        AudioToImagePipeline,
        build_modules,
    )
    from clap2diffusion_tpu_torch.tools.bench import bench_inputs

    wav, ids = bench_inputs(cfg)
    size = cfg.diffusion.image_size
    row = {"program": "request", "input_shape": [1, size, size, 3], "dtype": "bfloat16",
           "steps": 50, "input_bytes": wav.nbytes + 2 * ids.nbytes}
    if dev.type != "cuda":
        with torch.device("meta"):
            mods = build_modules(cfg)
        for name, m in mods.items():
            m.to(torch.float32 if name in FP32_TOWERS else torch.bfloat16)
        row["param_bytes"] = weight_bytes(mods.values())
        return {**row, "resident_bytes": None, "peak_bytes": None}
    pipe = AudioToImagePipeline(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    row["param_bytes"] = weight_bytes(
        [getattr(pipe, n) for n in CORE_TOWERS if getattr(pipe, n, None) is not None])

    def request():
        return pipe.generate(waveform=wav, text_ids=ids, num_steps=50, guidance_scale=7.5,
                             seed=0)

    t0 = time.perf_counter()
    row.update(measure(dev, request))
    row["seconds"] = time.perf_counter() - t0
    row["graph_pool_bytes"] = sum(c.pool_bytes for c in pipe.programs.captured.values())
    row["replay_peak_bytes"] = measure(dev, request)["peak_bytes"]
    del pipe
    torch.cuda.empty_cache()
    return row


def run(cfg=None, device=None) -> List[dict]:
    """Every program's row, each printed as it is measured."""
    from clap2diffusion_tpu_torch.core.config import Config
    from clap2diffusion_tpu_torch.core.device import resolve_device

    cfg = cfg or Config()
    dev = resolve_device(device)
    build_s = B.build_kernels(dev)
    where = {"device": str(dev), **B.card(dev)}
    rows = []
    for name, spec in towers(cfg).items():
        rows.append({**tower_row(name, spec, dev), **where})
        B.emit(rows[-1])
    rows.append({**request_row(cfg, dev), "build_s": build_s, **where})
    B.emit(rows[-1])
    return rows


def main(argv=None) -> int:
    args = B.parser(__doc__).parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
