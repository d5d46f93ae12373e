"""From a ``torch.profiler`` run to numbers: the device's busy time (the
union of its kernel, memcpy and memset intervals), its idle gaps named by
the benchmark span open at the time, the device operations that took most
time, and the device time of kernels whose names match a metric's
patterns. The categories follow the arithmetic of the program's
``tools/trace_request.py`` (copied, not imported)."""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CATEGORIES = (
    ("flash_attention", ("flash_fwd",)),
    ("groupnorm", ("group_norm_fwd",)),
    ("convolution", ("fprop", "conv", "implicit", "nhwc")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
    ("layer_norm", ("layer_norm",)),
    ("elementwise_reduce", ("elementwise", "vectorized", "reduce")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other"


def chrome_events(prof) -> List[dict]:
    """The trace events of a finished profiler run (through a temporary
    file under ``TMPDIR``, deleted at once)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short_name(name: str) -> str:
    """A kernel's name cut to at most 100 characters, keeping its head and
    its tail (template arguments tell instances apart)."""
    return name if len(name) <= 100 else name[:62] + "..." + name[-35:]


def distinct(pairs: List[Tuple[str, float]]) -> List[List]:
    """[name, value] pairs with names made distinct: two different names
    that shorten alike get ``#2``, ``#3``... appended."""
    seen: Dict[str, int] = {}
    out = []
    for name, v in pairs:
        s = short_name(name)
        seen[s] = seen.get(s, 0) + 1
        out.append([s if seen[s] == 1 else f"{s}#{seen[s]}", v])
    return out


class Trace:
    """The reduced trace of one traced window: the benchmark's span
    ``bench/window`` bounds it. ``host_spans`` are spans kept on the host
    clock (name, start, end in ``time.perf_counter`` seconds, such as the
    open loop's requests, which live on threads of their own); ``host_t0``
    is the host time at which the window span opened, which places them on
    the trace's clock."""

    def __init__(self, events: List[dict], host_spans=(), host_t0: Optional[float] = None):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.spans = [e for e in events if e.get("cat") == "user_annotation"
                      and str(e.get("name", "")).startswith("bench/") and "dur" in e]
        win = [e for e in self.spans if e["name"] == "bench/window"]
        if win:
            self.t0 = min(e["ts"] for e in win)
            self.t1 = max(e["ts"] + e["dur"] for e in win)
        else:
            self.t0 = min((e["ts"] for e in self.device), default=0.0)
            self.t1 = max((e["ts"] + e["dur"] for e in self.device), default=0.0)
        if host_t0 is not None:
            self.spans += [{"name": "bench/" + name, "ts": self.t0 + (a - host_t0) * 1e6,
                            "dur": (b - a) * 1e6} for name, a, b in host_spans]
        inside = [(max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                  for e in self.device]
        self.busy = union((a, b) for a, b in inside if b > a)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernel_seconds(self, patterns: Iterable[str]) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name matches one
        of the regular expressions ``patterns`` (case-insensitive)."""
        rx = re.compile("|".join(f"(?:{p})" for p in patterns), re.IGNORECASE)
        hits = [e for e in self.device if e.get("cat") == "kernel" and rx.search(e["name"])]
        return sum(e["dur"] for e in hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] / 1e6
        return distinct(sorted(by.items(), key=lambda kv: -kv[1])[:n])

    def by_category(self) -> Dict[str, float]:
        by: Dict[str, float] = {}
        for e in self.device:
            c = category(e["name"])
            by[c] = by.get(c, 0.0) + e["dur"] / 1e6
        return by

    def _span_at(self, t: float) -> str:
        open_ = [e for e in self.spans if e["ts"] <= t <= e["ts"] + e["dur"]
                 and e["name"] != "bench/window"]
        if not open_:
            return "no_span"
        return min(open_, key=lambda e: e["dur"])["name"][len("bench/"):]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest intervals of the window in which the device ran
        nothing, each named by the innermost benchmark span open at its
        middle."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._span_at((a + b) / 2), (b - a) / 1e6] for a, b in gaps[:n]]

    def breakdown(self) -> Dict[str, List]:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def profile():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def roofline(ops: float, nbytes: float, seconds: float, peaks: Dict) -> Optional[float]:
    """The least time the chip could take (the larger of ops over the peak
    rate and bytes over the peak bandwidth) over ``seconds``, in %; None
    when no kernel time was found."""
    if seconds <= 0 or (ops <= 0 and nbytes <= 0):
        return None
    return 100.0 * max(ops / peaks["flops_bf16"], nbytes / peaks["bytes_per_s"]) / seconds
