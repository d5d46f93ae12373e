"""Tracing and timing harness (port of ``clap2diffusion_tpu/utils/profiling.py``).

Spans: ``span(name, id=..., parent=...)`` marks a stage of the program on
the host clock (``time.perf_counter_ns``) from whatever thread runs it, and
``record(name, t0_ns, t1_ns, ...)`` keeps one timed elsewhere. They are
kept only while ``recording()`` (or ``device_trace``) is open; otherwise a
span costs one check of a module-level flag. Each kept span is a ``Span``:
name, ``id`` (the unit of work it belongs to: a request, a coalesced
dispatch, a micro-step; ``new_id()`` makes one), ``parent`` (the unit it is
a stage of, None for a unit's whole span), the thread's native id, start
and end in ns, and its attributes. A span whose ``clock`` attribute is
``"device"`` (the ``device.*`` stages of a request's device program,
``ops/stage_clock.py``) holds the device's own times: only its duration
compares with the host's spans.

``device_trace(log_dir)`` records a trace of the CPU and, on the card, of
CUDA, and writes it into ``log_dir`` as a Chrome trace (open it in Perfetto
or ``chrome://tracing``), the spans recorded meanwhile on any thread
merged into it on the trace's clock (the profiler itself keeps only the
``record_function`` ranges of the thread that started it). ``Timer`` times
wall clock with the device synchronised: ``measure(name, sync=x)`` waits
for the device that holds ``x``, and ``time_fn`` fetches one leaf of the
output to the host, as the JAX harness does. ``summary()`` gives, per name,
the p50, mean, min and count, JAX's keys.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

now = time.perf_counter_ns  # the spans' clock

_ids = itertools.count(1)
_lock = threading.Lock()
_active: tuple = ()  # the open recorders; empty: spans are not kept
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    id: Optional[int]
    parent: Optional[int]
    thread: int
    t_start_ns: int
    t_end_ns: int
    attrs: Dict[str, Any]

    @property
    def seconds(self) -> float:
        return (self.t_end_ns - self.t_start_ns) / 1e9


class Recorder:
    """The spans kept while one ``recording()`` was open, in the order they
    ended."""

    def __init__(self):
        self.spans: List[Span] = []


def new_id() -> int:
    """A fresh identifier for a unit of work (unique in the process)."""
    return next(_ids)


def record(name: str, t_start_ns: int, t_end_ns: int, *, id: Optional[int] = None,
           parent: Optional[int] = None, **attrs) -> None:
    """Keep a span timed by the caller (``now()`` readings), if recording."""
    if not _active:
        return
    s = Span(name, id, parent, threading.get_native_id(), t_start_ns, t_end_ns, attrs)
    with _lock:
        for r in _active:
            r.spans.append(s)


class _Open:
    __slots__ = ("name", "id", "parent", "attrs", "t0")

    def __init__(self, name, id, parent, attrs):
        self.name, self.id, self.parent, self.attrs = name, id, parent, attrs

    def __enter__(self):
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        record(self.name, self.t0, now(), id=self.id, parent=self.parent, **self.attrs)
        return False


def span(name: str, *, id: Optional[int] = None, parent: Optional[int] = None, **attrs):
    """A context manager that keeps the block as span ``name`` if recording
    (see the module doc); otherwise it does nothing."""
    if not _active:
        return _NULL
    return _Open(name, id, parent, attrs)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Keep the spans that end inside the block, from every thread; yields
    the ``Recorder`` whose ``spans`` hold them. Recordings may nest."""
    global _active
    rec = Recorder()
    with _lock:
        _active = _active + (rec,)
    try:
        yield rec
    finally:
        with _lock:
            _active = tuple(r for r in _active if r is not rec)


ANCHOR = "c2d/clock_anchor"


def merge_spans(events: List[dict], spans: List[Span], anchor_ns: int) -> List[dict]:
    """Chrome trace events of the host-clock ``spans``, placed by the
    last ``ANCHOR`` event of ``events``, whose middle is ``anchor_ns`` on
    the spans' clock (no anchor: none)."""
    marks = [e["ts"] + e.get("dur", 0) / 2 for e in events
             if e.get("name") == ANCHOR and "ts" in e]
    if not marks:
        return []
    ts = max(marks)
    pid = os.getpid()
    return [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.thread,
             "ts": ts + (s.t_start_ns - anchor_ns) / 1e3,
             "dur": (s.t_end_ns - s.t_start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent, **s.attrs}}
            for s in spans if s.attrs.get("clock") != "device"]


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA when the card is there) and write
    ``log_dir/trace_<pid>_<ns>.json`` with the spans recorded meanwhile, on
    every thread, merged in (``cat`` ``program_span``); yields the
    profiler. The two clocks are tied by a ``record_function``
    (``ANCHOR``) between two readings of the spans' clock: its middle is
    theirs."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording() as rec:
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(2):  # the first is slow to open: the last one counts
                before = now()
                with torch.profiler.record_function(ANCHOR):
                    pass
                anchor_ns = (before + now()) // 2
            yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    events.extend(merge_spans(events, rec.spans, anchor_ns))
    with open(path, "w") as f:
        json.dump(trace, f)


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
