"""How ``correct`` is decided: the program's answers held against the plain
reference of the cell's model family (``perfbench/families``), float32
with TF32 off, on the same weights (drawn again from the seed) and the
same inputs, after the program has been freed. Each compared number has
its limit in the configuration's file, under ``limits``; the readings
they were set from are in PERF.md.

Serving: for each sampled image, the reference recomputes the request's
conditioning over the request's whole batch (Norm-60 spans the batch), its
lane's initial latents from the lane's seed, and the 50 guided DDIM steps
and the decode. The number compared is the largest, over the sample, of
the mean absolute difference between the served uint8 image and the
reference's image truncated to uint8 as the program truncates its own, in
levels of 255."""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness.common import family, log, namespace
from perfbench.reference import plain


@contextlib.contextmanager
def fp32(precision=None):
    """TF32 off for cuBLAS and cuDNN, and the reference's precision
    (``None``: float32; ``"fp8"``: the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             plain.PRECISION)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plain.PRECISION = precision
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         plain.PRECISION) = saved


def lane_latents(seed: int, shape, device) -> torch.Tensor:
    """A lane's initial latents [1, *shape] from its own seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)[None]


def reference_images(cell: Dict, seed: int, jobs: List[Dict], device,
                     precision=None) -> List[np.ndarray]:
    """The reference's float image of each job (see the module doc), by
    the cell's model family."""
    from perfbench.harness.weights import draw_weights

    cfg = cell["config"]
    fam = family(cell)
    ns, serve = namespace(cfg["model"]), cfg["serve"]
    with fp32(precision):
        w = draw_weights(fam, ns, seed, fam.SERVE_TOWERS,
                         torch.bfloat16 if serve["dtype"] == "bfloat16" else torch.float32,
                         device)
        ref = fam.Reference(ns, w, device, fam.SERVE_TOWERS)
        del w
        out = []
        for job in jobs:
            routed = ref.routed(job["waveforms"], serve["temperature"], serve["norm_target"])
            routed = {k: v[job["lane"]:job["lane"] + 1] for k, v in routed.items()}
            x = lane_latents(job["seed"], fam.latent_shape(ns), device)
            img = ref.image(x, job["text_ids"], job["uncond_ids"], routed, serve["steps"],
                            serve["guidance_scale"])
            out.append(img[0].cpu().numpy())
        del ref
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def image_gaps(served: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """Gaps between a served uint8 image and the reference's float image,
    cast as the program casts its image (truncated to uint8)."""
    d = np.abs(served.astype(np.float64) - np.floor(ref.astype(np.float64)))
    return {"mae": float(d.mean()), "p99": float(np.quantile(d, 0.99)),
            "max": float(d.max())}


def serving(cell: Dict, seed: int, jobs: List[Dict], device) -> List[Dict]:
    limit = cell["config"]["limits"]["image_mae_levels"]
    if not jobs:
        return [{"name": "images_checked", "value": 0, "limit": 1, "ok": False}]
    t0 = time.perf_counter()
    refs = reference_images(cell, seed, jobs, device)
    gaps = [image_gaps(np.asarray(j["image"]), r) for j, r in zip(jobs, refs)]
    log(phase="check", images=len(jobs), gaps=gaps, reference_s=time.perf_counter() - t0)
    worst = max(g["mae"] for g in gaps)
    return [{"name": "image_mae_levels", "value": worst, "limit": limit,
             "ok": bool(np.isfinite(worst) and worst <= limit)}]
