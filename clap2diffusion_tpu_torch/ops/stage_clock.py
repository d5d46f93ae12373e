"""Stage marks of a request's device program.

``StageClock`` holds an int64 buffer of ``SLOTS`` stamps (ns): slot 0 at
the program's start, then one at the end of each of ``STAGES``, in order.
On CUDA a mark is ``csrc/stage_clock.cu``'s one-thread kernel, which writes
the card's global timer into its slot on the current stream: captured into
a CUDA graph, every replay writes its own stamps, so the buffer, cloned
with the program's output, says how long each stage took on the device
without a host synchronisation. On the CPU a mark is a reading of
``time.perf_counter_ns`` written straight into the buffer's memory (no
tensor operation). The marks count no launches (``ops/counters.py``).

The program marks with ``mark(slot)``, which marks the clock that
``timing(clock)`` made current in the caller's context, and does nothing
without one: the program keeps its signature and its output, and a run
outside ``timing`` (a test's, a caller's) launches no mark.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from clap2diffusion_tpu_torch.ops import cuda_build

SOURCE = "stage_clock.cu"
# the stages a request's device program is cut into, in order
STAGES = ("device.condition_audio", "device.text", "device.unet_loop", "device.vae")
SLOTS = len(STAGES) + 1


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.c2d_stage_mark
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.c2d_cuda_error_string_stage.restype = ctypes.c_char_p
        lib.c2d_cuda_error_string_stage.argtypes = [ctypes.c_int]
    return lib


class StageClock:
    """The stamps of one run of the device program (see the module doc)."""

    def __init__(self, device):
        self.stamps = torch.empty(SLOTS, dtype=torch.int64, device=device)
        self._host = None if self.stamps.is_cuda else self.stamps.numpy()

    def mark(self, slot: int) -> None:
        if self._host is not None:
            self._host[slot] = time.perf_counter_ns()
            return
        dev = self.stamps.device
        lib = _lib()
        with torch.cuda.device(dev) if dev.index != torch.cuda.current_device() \
                else contextlib.nullcontext():
            err = lib.c2d_stage_mark(self.stamps.data_ptr(), slot,
                                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"stage_mark kernel failed: "
                               f"{lib.c2d_cuda_error_string_stage(err).decode()}")


_current: contextvars.ContextVar = contextvars.ContextVar("stage_clock", default=None)


@contextlib.contextmanager
def timing(clock: StageClock) -> Iterator[StageClock]:
    """Make ``clock`` the one ``mark`` marks in this context."""
    token = _current.set(clock)
    try:
        yield clock
    finally:
        _current.reset(token)


def mark(slot: int) -> None:
    """Mark ``slot`` of the current clock, if there is one."""
    clock = _current.get()
    if clock is not None:
        clock.mark(slot)


def durations(stamps: Optional[np.ndarray]) -> Dict[str, float]:
    """Seconds of each of ``STAGES`` from a run's stamps on the host."""
    if stamps is None:
        return {}
    d = np.diff(np.asarray(stamps, np.int64))
    return {name: float(v) / 1e9 for name, v in zip(STAGES, d)}
