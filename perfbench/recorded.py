"""Run one cell of BENCHMARK.json once, as ``perfbench/run.py`` does, with
the program's span recorder (``clap2diffusion_tpu_torch/utils/profiling.py``)
on, and log what its spans say.

    python3 perfbench/recorded.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The result line is ``run.py``'s. With ``--trace 0`` the recorder is on for
the whole run (what recording costs the end-to-end metrics); a
``{"phase": "program_spans"}`` line on standard error gives each span's
count and mean. With ``--trace 1`` it is on from the profiler's start to
the per-layer readings, and the line adds, from the spans of the traced
window's requests or micro-steps: each span's mean per request or
micro-step; in serving, the device stages read from the stamps beside
those read from the trace's ``stage_mark`` launches and the trace's busy
time a request; in the open loop, the nearest-rank p90 of
``service.queue``, the share of the window in which the device ran nothing
while a request was queued, the window's idle time by the innermost span
open at the time, and whether every completed request has its spans.
The recorder's spans are kept in memory only; nothing here changes what
``run.py`` measures.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench import run as R  # noqa: E402  (the environment run.py sets)
from perfbench.harness import common, reduce, runner  # noqa: E402
from perfbench.harness import program_spans as PS  # noqa: E402

DEVICE = tuple("device." + s for s in PS.STAGES)


def span_means(spans, units: int) -> dict:
    names = sorted({s.name for s in spans})
    return {n: {"count": len(PS.named(spans, n)), "mean_s": PS.mean_per_unit(spans, n, units)}
            for n in names}


def requests_complete(spans, responses) -> dict:
    """Whether each completed request has its ``service.request``,
    ``service.queue`` and ``service.encode``, and a dispatch with four
    device stages, and its queue wait is no longer than its latency
    (from its due time to its image)."""
    reqs = sorted(PS.named(spans, "service.request"), key=lambda s: s.t_start_ns)
    by_id = {}
    for s in spans:
        by_id.setdefault(s.id, []).append(s)
    missing, longer = 0, 0
    for d in sorted(responses, key=lambda d: d["t_send"]):
        req = min(reqs, key=lambda s: abs(s.t_start_ns / 1e9 - d["t_send"]), default=None)
        if req is None:
            missing += 1
            continue
        mine = {s.name: s for s in by_id.get(req.id, ())}
        queue = mine.get("service.queue")
        did = queue.attrs.get("dispatch") if queue is not None else None
        dispatch = {s.name for s in by_id.get(did, ())} if did is not None else set()
        if not ({"service.queue", "service.encode"} <= set(mine) and set(DEVICE) <= dispatch):
            missing += 1
        elif queue.seconds > d["latency"]:
            longer += 1
    return {"responses": len(responses), "request_spans": len(reqs), "incomplete": missing,
            "queue_longer_than_latency": longer}


def traced_readings(cell, ctx: dict, trace, spans) -> dict:
    units = ctx.get("requests", ctx.get("micro_steps", 0))
    out = {"units": units, "spans": span_means(spans, units)}
    if trace is None:
        return out
    out["busy_s_per_unit"] = trace.busy_s / units if units else None
    if cell["traffic"]["driver"] == "train":
        return out
    runs = PS.device_runs(trace)
    out["trace_marks"] = {"runs": len(runs), **{
        s: sum(r[s] for r in runs) / len(runs) for s in PS.STAGES}} if runs else None
    stamped = [sum(x.seconds for x in PS.named(spans, n)) for n in DEVICE]
    dispatches = len(PS.named(spans, DEVICE[0]))
    out["stamps_per_dispatch_s"] = (sum(stamped) / dispatches) if dispatches else None
    if cell["traffic"]["driver"] == "serve_open":
        t0 = ctx.get("host_t0")
        queue = [s.seconds for s in PS.named(spans, "service.queue")]
        out["queue_wait_p90_s"] = PS.nearest_rank(queue, 0.9)
        out["idle_coalesce_wait_share"] = PS.idle_while_queued_share(trace, spans, t0)
        out["idle_split_s"] = PS.idle_split(trace, spans, t0)
        out["idle_s"] = trace.window_s - trace.busy_s
        out["completeness"] = requests_complete(spans, ctx.get("responses") or [])
    return out


def recorded(call, trace: bool):
    """``call()`` (one run of a cell) with the recorder on, as the module
    doc says; returns what it returns."""
    from clap2diffusion_tpu_torch.utils import profiling

    if not trace:
        with profiling.recording() as rec:
            out = call()
        common.log(phase="program_spans", recording="whole run",
                   spans=span_means(rec.spans, 1))
        return out
    state = {}
    real_profile, real_per_layer = reduce.profile, runner.per_layer

    class Profile:
        """The harness's profiler, the recorder opened with it."""

        def __init__(self):
            self.prof = real_profile()

        def start(self):
            state["cm"] = profiling.recording()
            state["rec"] = state["cm"].__enter__()
            self.prof.start()

        def __getattr__(self, name):
            return getattr(self.prof, name)

    def per_layer(cell, res, device):
        state["cm"].__exit__(None, None, None)
        metrics, trace = real_per_layer(cell, res, device)
        common.log(phase="program_spans", recording="traced window",
                   **traced_readings(cell, res["ctx"], trace, state["rec"].spans))
        return metrics, trace

    reduce.profile, runner.per_layer = Profile, per_layer
    try:
        return call()
    finally:
        reduce.profile, runner.per_layer = real_profile, real_per_layer


def main() -> int:
    return recorded(R.main, bool(common.parse_args().trace))


if __name__ == "__main__":
    sys.exit(main())
