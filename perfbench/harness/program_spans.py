"""Readings of the program's own stage marks and spans.

Device stages: each run of the port's device program launches
``stage_mark<k>`` (``csrc/stage_clock.cu``) at its start (k = 0) and at the
end of each of its four stages (k = 1..4): the audio conditioning, CLIP
text, the sampler loop and the VAE decode. In a traced window each run's
five launches follow one another on the device, so the gap between the
starts of marks k and k + 1 is stage k's device time. A program without the
marks (an older one) gives no run, and the readers then give None.

Program spans (``utils/profiling.py``'s ``Span``: name, id, parent,
thread, start and end ns on ``time.perf_counter_ns``, attributes): the
arithmetic ``perfbench/recorded.py`` applies to the spans a recorded run
kept: a span's mean per unit, a nearest-rank percentile, the device's idle
time while a request waited in the coalescer's queue, and the idle time
split by the innermost span open at the time.
"""

from __future__ import annotations

import bisect
import math
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from perfbench.harness.reduce import union

STAGES = ("condition_audio", "text", "unet_loop", "vae")
_MARK = re.compile(r"stage_mark(?:<|ILi)(\d+)")


def device_runs(trace) -> List[Dict[str, float]]:
    """Each complete run's device seconds by stage, in the order run: a
    run is marks 0 to 4 in a row in start order (a run the window cut is
    left out)."""
    if trace is None:
        return []
    marks = []
    for e in trace.device:
        m = _MARK.search(str(e.get("name", ""))) if e.get("cat") == "kernel" else None
        if m is not None:
            marks.append((e["ts"], int(m.group(1))))
    marks.sort()
    runs, i = [], 0
    while i + len(STAGES) < len(marks):
        slots = [k for _, k in marks[i:i + len(STAGES) + 1]]
        if slots == list(range(len(STAGES) + 1)):
            ts = [t for t, _ in marks[i:i + len(STAGES) + 1]]
            runs.append({s: (ts[j + 1] - ts[j]) / 1e6 for j, s in enumerate(STAGES)})
            i += len(STAGES) + 1
        else:
            i += 1
    return runs


def mean_device_s(ctx: Dict, stages: Sequence[str]) -> Optional[float]:
    """The mean over the traced window's complete runs of the device
    seconds of ``stages`` together; None without a run."""
    runs = device_runs(ctx.get("trace"))
    if not runs:
        return None
    return sum(sum(r[s] for s in stages) for r in runs) / len(runs)


# -- program spans -----------------------------------------------------------------

def named(spans: Iterable, name: str) -> List:
    return [s for s in spans if s.name == name]


def mean_per_unit(spans: Iterable, name: str, units: int) -> Optional[float]:
    """The seconds of spans ``name`` summed, over ``units`` (requests or
    micro-steps); None when there are none."""
    got = named(spans, name)
    if not got or units <= 0:
        return None
    return sum(s.seconds for s in got) / units


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q`` quantile (0 < q <= 1); None when empty."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def on_trace(trace, spans: Iterable, host_t0: float) -> List[Tuple[str, float, float]]:
    """Host-clock spans as (name, start, end) on the trace's clock (us),
    placed as the harness places its own host spans: the window span
    opened at ``host_t0`` (``time.perf_counter`` seconds)."""
    out = []
    for s in spans:
        if s.attrs.get("clock") == "device":
            continue
        a = trace.t0 + (s.t_start_ns / 1e9 - host_t0) * 1e6
        b = trace.t0 + (s.t_end_ns / 1e9 - host_t0) * 1e6
        out.append((s.name, a, b))
    return out


def _idle(trace) -> List[Tuple[float, float]]:
    edges = [trace.t0] + [x for iv in trace.busy for x in iv] + [trace.t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def _overlap(xs, ys) -> float:
    """The measure of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_while_queued_share(trace, spans: Iterable, host_t0: float) -> Optional[float]:
    """% of the traced window in which the device ran nothing while at
    least one request was in ``service.queue``."""
    if trace is None or trace.window_s <= 0:
        return None
    queued = [(max(a, trace.t0), min(b, trace.t1))
              for n, a, b in on_trace(trace, spans, host_t0) if n == "service.queue"]
    queued = union((a, b) for a, b in queued if b > a)
    if not queued:
        return None
    return 100.0 * _overlap(_idle(trace), queued) / 1e6 / trace.window_s


def idle_split(trace, spans: Iterable, host_t0: float) -> Dict[str, float]:
    """The window's idle seconds by the innermost (shortest) span open at
    each moment (``no_span`` where none is)."""
    placed = [(n, max(a, trace.t0), min(b, trace.t1))
              for n, a, b in on_trace(trace, spans, host_t0)]
    placed = [p for p in placed if p[2] > p[1]]
    cuts = sorted({trace.t0, trace.t1} | {x for _, a, b in placed for x in (a, b)})
    labels = []  # the innermost span over each piece between two cuts
    for x, y in zip(cuts, cuts[1:]):
        mid = (x + y) / 2
        open_ = [p for p in placed if p[1] <= mid <= p[2]]
        labels.append(min(open_, key=lambda p: p[2] - p[1])[0] if open_ else "no_span")
    out: Dict[str, float] = {}
    for a, b in _idle(trace):
        k = max(0, bisect.bisect_right(cuts, a) - 1)
        while k < len(labels) and cuts[k] < b:
            x, y = max(a, cuts[k]), min(b, cuts[k + 1])
            if y > x:
                out[labels[k]] = out.get(labels[k], 0.0) + (y - x) / 1e6
            k += 1
    return out
