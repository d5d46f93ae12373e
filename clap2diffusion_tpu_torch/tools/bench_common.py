"""What the port's measurement tools share: the card a number was taken on,
the serving kernels' build, the benchmark weights, the inputs of the JAX
benches and a clock around a call.

Every tool runs on CUDA unless it is given ``--device cpu`` (``device=
"cpu"``); without CUDA and without that it raises (``core/device.py``).
A number taken on the CPU carries ``"card": "cpu"`` and no device time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the weights the benches share: cached_init_params(seed 0) keyed by geometry,
# type and device type, drawn once on a machine and read by every later run
PARAM_CACHE = os.path.join(REPO, ".cache", "params")
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# the JAX benches draw prompt ids below this bound (bench.py, tools/bench_breakdown.py)
TEXT_ID_BOUND = 49_000


def emit(obj: dict, stream=None) -> None:
    print(json.dumps(obj), file=stream or sys.stdout, flush=True)


def say(*parts) -> None:
    """A human line on stderr."""
    print(*parts, file=sys.stderr, flush=True)


def card(device: torch.device) -> Dict[str, Optional[str]]:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``{"card": "cpu", "power_limit": None}`` on the CPU."""
    if device.type != "cuda":
        return {"card": "cpu", "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"card": name, "power_limit": limit}


def build_kernels(device: torch.device) -> Optional[float]:
    """Build (one nvcc per source, in parallel) and load the serving path's
    kernel libraries, flash attention and GroupNorm, before the first
    request; seconds, or None on the CPU. A failed build raises."""
    if device.type != "cuda":
        return None
    from clap2diffusion_tpu_torch.ops import cuda_build
    from clap2diffusion_tpu_torch.ops import flash_attention as fa
    from clap2diffusion_tpu_torch.ops import groupnorm as gn

    t0 = time.perf_counter()
    cuda_build.build_all([*fa.SOURCES, gn.SOURCE])
    fa.build()
    gn.build()
    return time.perf_counter() - t0


def bench_pipeline(cfg, device: torch.device, dtype: torch.dtype,
                   cache_dir: str) -> Tuple[object, dict]:
    """(pipe, info): the pipeline of ``cached_init_params(cfg, seed=0,
    dtype)``, drawn on ``device`` and saved on the first run, then read by
    ``load_pipeline`` from ``cache_dir`` (which also applies
    ``C2D_INT8_WIRE=1``). ``info`` says whether the cache held the weights
    and how long they took: ``load_s`` on a hit, ``init_s`` (drawn, saved
    and read back) on a miss."""
    from clap2diffusion_tpu_torch.diffusion.pipeline import (
        cached_init_params,
        load_pipeline,
        params_cache_path,
    )

    path = params_cache_path(cfg, 0, dtype, cache_dir, device)
    if path is None:
        raise ValueError("the benchmark weights need a cache directory")
    hit = os.path.exists(os.path.join(path, "pipeline.json"))
    t0 = time.perf_counter()
    if not hit:  # draw and save; the drawn tensors are freed before the load
        cached_init_params(cfg, seed=0, dtype=dtype, cache_dir=cache_dir, device=device)
    pipe = load_pipeline(cfg, path, dtype=dtype, device=device)
    sync(device)
    return pipe, {"params_cache_hit": hit, "params_cache": path,
                  ("load_s" if hit else "init_s"): time.perf_counter() - t0}


def text_ids(rng: np.random.Generator, cfg) -> np.ndarray:
    """Prompt ids as the JAX benches draw them, ``integers(0, 49_000, (1,
    77))``, at the configuration's length and below its vocabulary (the
    same draw at ``Config()``)."""
    ct = cfg.diffusion.clip_text
    return rng.integers(0, min(TEXT_ID_BOUND, ct.vocab_size),
                        size=(1, ct.max_length)).astype(np.int32)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_times(fn: Callable[[], object], device: torch.device, iters: int,
               warmup: int = 1) -> List[float]:
    """Seconds of each of ``iters`` calls of ``fn`` after ``warmup``, each
    waited for: CUDA events around the call on the card (the host's pace,
    launches included), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    out = []
    for _ in range(iters):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
    return out


def process_age_s() -> float:
    """Seconds since this process started (``/proc``): the clock of a
    time-to-first-image that includes the interpreter's and torch's start."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without CUDA) or cpu")
    return ap
