"""One device program per request: the JAX package's execution model
(``clap2diffusion_tpu/diffusion/pipeline.py:8-10``: everything after the
host-side audio decode is one jit-compiled function, ``_generate_jit``,
compiled once per static signature).

``AudioToImagePipeline.generate`` runs a request in two parts
(``diffusion/pipeline.py``): host preparation, which makes every copy from
the host and every random draw and leaves them in device tensors, and the
device program, which reads only those tensors. ``Signature`` is what JAX
compiles on: ``_generate_jit``'s static arguments (``static_argnums=(0, 5,
7, 9, 12, 13)``), whether per-lane seeds are given, the shape and type of
every array input (which also says which optional inputs are given), and
the opt-in routes the modules read while they run (``ROUTE_FLAGS``). The
step grid is derived from the statics and baked in, as in JAX. The dynamic
scalars (guidance scale, Norm-60 target, temperature, audio mix, CFG
rescale) are 0-dim fp32 inputs, as JAX traces them.

``Programs`` is a pipeline's cache of captured programs on CUDA. At a
signature's first request the program runs once eagerly on the capture
stream (the warm-up: it builds the constants the modules make at first use
and ``QuantCache``'s int8 weights), then is captured into a CUDA graph on
that stream. All of a pipeline's graphs share one memory pool, so a new
signature adds to the card's memory only what its pool needs beyond the
largest program captured before it, and its inputs and output. That is
safe because replays never overlap (one lock, one stream) and a replay's
output is copied into a fresh tensor before the next replay: the only
memory a graph keeps live between replays is its static inputs, made
outside the pool, and its output, which a later replay may overwrite once
copied. The cache holds at most ``CAPACITY`` graphs and drops the least
recently used one for a new signature, so the graphs' own memory stays
bounded however many signatures the clients choose: their inputs and
outputs, and each instantiated graph, which CUDA keeps outside
PyTorch's allocator (``device_bytes``; ~3 MB per 512² step on an H100). A
request copies its inputs into the graph's static buffers, replays the
graph and copies the output into fresh tensors (the images, and the
stage stamps ``ops/stage_clock.py``'s marks wrote), so that a request
still in flight (``generate_stream``) or scored on the card (best-of)
never sees the next replay's bits. A capture error fails the request:
nothing runs eagerly in its place.

The graphs read the weights by address, and the int8 weights ``QuantCache``
made from them at capture. Every request checks the storage and version
counter of each weight the graphs were captured with: ``load_state_dict``,
an in-place update or a ``.to()`` changes them, and the next request drops
every graph and captures its signature again (an update through ``.data``
bypasses the version counter and is not seen; ``clear()`` then).

Launch counters: a kernel's wrapper runs, and counts, at capture and not
at replay. The capture records what the program launched (every counter of
``ops/counters.py``) and every replay adds it once. The warm-up's and the
capture's own counts are taken back out, so that a request counts what one
eager run of it counts.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import logging
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from clap2diffusion_tpu_torch.ops.counters import COUNTERS

log = logging.getLogger(__name__)

# the environment variables the modules read while the program runs: each
# picks a route that a capture bakes in
ROUTE_FLAGS = ("C2D_INT8", "C2D_INT8_CONV", "C2D_FUSED_QKV", "C2D_PACKED_FLASH", "C2D_WINOGRAD")

# the most graphs a pipeline keeps (at least 2: the pool outlives an eviction)
CAPACITY = 16

Inputs = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Signature:
    """The static key of a request's device program."""

    num_steps: int
    model_type: str
    batch: int
    sampler: str
    init_steps: int
    per_lane_seeds: bool
    arrays: Tuple[Tuple[str, Tuple[int, ...], str], ...]  # (name, shape, dtype) per input
    routes: Tuple[Optional[str], ...]  # the values of ROUTE_FLAGS

    @classmethod
    def of(cls, inputs: Inputs, **statics) -> "Signature":
        arrays = tuple((k, tuple(v.shape), str(v.dtype)) for k, v in sorted(inputs.items()))
        return cls(**statics, arrays=arrays,
                   routes=tuple(os.environ.get(f) for f in ROUTE_FLAGS))


# a counter that joins the registry after a snapshot (its module imported
# while the program ran) was at zero then
def _snapshot() -> dict:
    return {name: copy.copy(getattr(o, a)) for name, (o, a) in COUNTERS.items()}


def _zero(value):
    return type(value)()


def _delta(before: dict, after: dict) -> dict:
    return {name: v - before.get(name, _zero(v)) for name, v in after.items()}


def _restore(snap: dict) -> None:
    for name, (o, a) in COUNTERS.items():
        current = getattr(o, a)
        value = snap.get(name, _zero(current))
        if isinstance(current, collections.Counter):
            current.clear()  # in place: callers hold the Counter
            current.update(value)
        else:
            setattr(o, a, value)


def _add(delta: dict) -> None:
    for name, d in delta.items():
        o, a = COUNTERS[name]
        if isinstance(d, collections.Counter):
            getattr(o, a).update(d)
        else:
            setattr(o, a, getattr(o, a) + d)


def _state(tensors: List[torch.Tensor]) -> tuple:
    """What a graph assumes of the weights it reads: their storage and
    version counters."""
    return tuple((t.data_ptr(), None if t.is_inference() else t._version) for t in tensors)


class Captured:
    """One signature's CUDA graph: its static input buffers, its output (a
    tensor or a tuple of tensors, each cloned at every replay) and what
    capturing it cost (``capture_s``: warm-up, capture and
    instantiation; ``pool_bytes``: what its capture added to the memory
    the card's allocator reserves, the shared pool's growth;
    ``device_bytes``: the card's memory it took in all, the instantiated
    graph included; ``replays``: the requests it served)."""

    def __init__(self, program: Callable[[Inputs], torch.Tensor], inputs: Inputs,
                 stream: torch.cuda.Stream, pool):
        dev = stream.device
        t0 = time.perf_counter()
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        stream.wait_stream(torch.cuda.current_stream(dev))
        before = _snapshot()
        with torch.cuda.stream(stream):
            program(self.inputs)
        warm = _snapshot()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        free = torch.cuda.mem_get_info(dev)[0]
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the server's fetch thread may wait on an earlier
        # request's event while this thread captures
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.output = program(self.inputs)
        self.launches = _delta(warm, _snapshot())
        _restore(before)
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.device_bytes = free - torch.cuda.mem_get_info(dev)[0]
        self.capture_s = time.perf_counter() - t0
        self.replays = 0

    def __call__(self, inputs: Inputs):
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        self.graph.replay()
        self.replays += 1
        _add(self.launches)
        if isinstance(self.output, tuple):  # the images and the stage stamps
            return tuple(t.clone() for t in self.output)
        return self.output.clone()


class Programs:
    """A pipeline's captured programs, one per ``Signature``, the least
    recently used first. ``weights()`` gives the tensors the programs read
    by address (the pipeline's parameters and buffers). A lock keeps two
    threads from writing one graph's static buffers at once, and puts the
    replays in one order."""

    def __init__(self, weights: Callable[[], Iterable[torch.Tensor]]):
        self.weights = weights
        self.captured: "collections.OrderedDict[Signature, Captured]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self._stream = None  # the capture stream, from the first capture
        self._pool = None  # the graphs' shared pool
        self._held: List[torch.Tensor] = []  # the weights as the graphs were captured
        self._held_state: tuple = ()

    def _capture(self, program: Callable[[Inputs], torch.Tensor], inputs: Inputs) -> Captured:
        if self._stream is None:
            self._stream = torch.cuda.Stream(next(iter(inputs.values())).device)
        if not self.captured:  # a pool no graph uses is released: start another
            self._pool = torch.cuda.graph_pool_handle()
        return Captured(program, inputs, self._stream, self._pool)

    def run(self, sig: Signature, inputs: Inputs,
            program: Callable[[Inputs], torch.Tensor]) -> torch.Tensor:
        """``program(inputs)`` as one replay of ``sig``'s graph, captured
        first if this is the signature's first request or the weights
        changed since the graphs were captured."""
        with self._lock:
            if self.captured and _state(self._held) != self._held_state:
                log.info("the weights changed: %d programs dropped", len(self.captured))
                self._drop_all()
            cap = self.captured.get(sig)
            if cap is not None:
                self.captured.move_to_end(sig)
                return cap(inputs)
            if not self.captured:
                self._held = list(self.weights())
                self._held_state = _state(self._held)
            if len(self.captured) >= CAPACITY:
                self.captured.popitem(last=False)
            cap = self._capture(program, inputs)
            self.captured[sig] = cap
            log.info("captured %s (batch %d, %d steps, %s) in %.2f s, pool +%d bytes, "
                     "%d bytes in all, launches %s", sig.model_type, sig.batch, sig.num_steps,
                     sig.sampler, cap.capture_s, cap.pool_bytes, cap.device_bytes,
                     {k: v for k, v in cap.launches.items() if isinstance(v, int) and v})
            return cap(inputs)

    def _drop_all(self) -> None:
        self.captured.clear()
        self._held, self._held_state = [], ()

    def clear(self) -> None:
        """Drop every graph (the shared pool goes with the last)."""
        with self._lock:
            self._drop_all()
