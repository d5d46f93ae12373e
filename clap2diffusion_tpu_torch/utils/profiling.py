"""Tracing and timing harness (port of ``clap2diffusion_tpu/utils/profiling.py``).

``trace_annotation`` names a stage in a profiler trace
(``torch.profiler.record_function``); ``device_trace(log_dir)`` records a
trace of the CPU and, on the card, of CUDA, and writes it into ``log_dir``
as a Chrome trace (open it in Perfetto or ``chrome://tracing``); ``Timer``
times wall clock with the device synchronised: ``measure(name, sync=x)``
waits for the device that holds ``x``, and ``time_fn`` fetches one leaf of
the output to the host, as the JAX harness does. ``summary()`` gives, per
name, the p50, mean, min and count, JAX's keys.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA when the card is there) and write
    ``log_dir/trace_<pid>_<ns>.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _leaves(out: Any) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return []


def _sync(out: Any) -> None:
    """Wait for the device that holds ``out``'s first tensor."""
    leaves = _leaves(out)
    if leaves and leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)


class Timer:
    """Wall-clock timing with device synchronisation."""

    def __init__(self):
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str, sync: Optional[Any] = None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _sync(sync)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def time_fn(self, name: str, fn, *args, warmup: int = 1, iters: int = 5):
        """Record the wall time of each of ``iters`` calls (after
        ``warmup``), each fenced by a host copy of one leaf of its output."""

        def fenced(out):
            leaves = _leaves(out)
            if leaves:
                leaves[0].cpu()
            return out

        out = None
        for _ in range(warmup):
            out = fenced(fn(*args))
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fenced(fn(*args))
            self.records.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"p50": float(np.median(v)), "mean": float(np.mean(v)),
                "min": float(np.min(v)), "n": len(v)}
            for k, v in self.records.items()
        }
