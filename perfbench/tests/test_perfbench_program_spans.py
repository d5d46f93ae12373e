"""The readers of the program's stage marks and spans
(``harness/program_spans.py``, ``metrics/*_device_s.*``) on synthetic
traces and spans with known answers, and ``recorded.py`` around tiny CPU
runs of the serving and training cells."""

from __future__ import annotations

import contextlib
import io
import json
import math

import pytest
import torch

from clap2diffusion_tpu_torch.utils.profiling import Span
from perfbench import recorded
from perfbench.harness import common, reduce
from perfbench.harness import program_spans as PS
from perfbench.harness.runner import run_cell
from perfbench.tests import tiny

MARK = "void (anonymous namespace)::stage_mark<{}>(long long*)"


def _kernel(name, ts, dur=2.0):
    return {"cat": "kernel", "name": name, "ts": float(ts), "dur": dur}


def _run(t0, gaps):
    """Marks 0..4 from ``t0`` (us) with the stages' ``gaps`` between them,
    a UNet kernel inside the loop."""
    ts = [t0]
    for g in gaps:
        ts.append(ts[-1] + g)
    return [_kernel(MARK.format(k), t) for k, t in enumerate(ts)] + [
        _kernel("gemm", ts[2] + 1, gaps[2] - 2)]


def test_device_stages_from_the_marks_of_complete_runs():
    events = [{"cat": "user_annotation", "name": "bench/window", "ts": 0.0, "dur": 1e6}]
    events += _run(100, [10, 20, 300, 40]) + _run(1000, [30, 40, 500, 60])
    events += [_kernel(MARK.format(k), 5000 + k) for k in range(3)]  # cut by the window
    events.append(_kernel("_Z10stage_markILi4EEvPx", 9000))  # a lone mangled mark
    trace = reduce.Trace(events)
    runs = PS.device_runs(trace)
    assert len(runs) == 2
    assert runs[0] == pytest.approx({"condition_audio": 10e-6, "text": 20e-6,
                                     "unet_loop": 300e-6, "vae": 40e-6})
    ctx = {"trace": trace}
    want = {"condition_device_s": 50e-6, "unet_loop_device_s": 400e-6, "vae_device_s": 50e-6}
    for stem, value in want.items():
        for suffix in ("b8", "b1"):
            assert math.isclose(common.metric_reader(f"{stem}.{suffix}").read(ctx), value)
    # a program without the marks, or no trace: nothing to read
    bare = reduce.Trace([e for e in events if "stage_mark" not in e["name"]])
    for c in ({"trace": bare}, {"trace": None}, {}):
        assert common.metric_reader("vae_device_s.b1").read(c) is None


def _span(name, a, b, id=None, **attrs):
    return Span(name, id, id, 1, int(a * 1e9), int(b * 1e9), attrs)


def test_queue_waits_idle_while_queued_and_the_idle_split():
    # a 10 s window opened at host time 100 s; the device busy over [2, 5) and [7, 8) s
    events = [{"cat": "user_annotation", "name": "bench/window", "ts": 0.0, "dur": 10e6},
              _kernel("gemm", 2e6, 3e6), _kernel("gemm", 7e6, 1e6)]
    trace = reduce.Trace(events)
    spans = [_span("service.request", 101.0, 106.0, 1), _span("service.queue", 101.5, 102.5, 1),
             _span("service.request", 106.5, 109.0, 2), _span("service.queue", 106.5, 107.5, 2),
             _span("service.window", 101.8, 102.5, 9),
             _span("device.vae", 0.0, 0.5, 9, clock="device")]
    # idle and queued: [1.5, 2) and [6.5, 7) s
    assert math.isclose(PS.idle_while_queued_share(trace, spans, 100.0), 10.0)
    split = PS.idle_split(trace, spans, 100.0)
    assert split == pytest.approx({"no_span": 1.0 + 0.5 + 1.0,
                                   "service.request": 0.5 + 1.0 + 1.0,
                                   "service.queue": 0.3 + 0.5, "service.window": 0.2})
    assert math.isclose(sum(split.values()), trace.window_s - trace.busy_s)
    assert PS.idle_while_queued_share(trace, spans[:1], 100.0) is None
    assert PS.nearest_rank([3.0, 1.0, 2.0], 0.9) == 3.0
    assert PS.nearest_rank([float(i) for i in range(1, 11)], 0.9) == 9.0
    assert PS.nearest_rank([], 0.9) is None
    assert math.isclose(PS.mean_per_unit(spans, "service.queue", 2), 1.0)
    assert PS.mean_per_unit(spans, "train.loss", 2) is None


def _recorded_run(root, name, seconds, trace):
    cell = common.cell(common.load_benchmark(root), name, root)
    args = common.parse_args(["--workload", name, "--seed", "2147483659", "--seconds",
                              str(seconds), "--trace", str(int(trace))])
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        out = recorded.recorded(lambda: run_cell(cell, args, torch.device("cpu"), 0.0), trace)
    logs = [json.loads(x) for x in err.getvalue().splitlines() if x.startswith("{")]
    return out, next(x for x in logs if x.get("phase") == "program_spans")


def test_recorded_runs_on_the_cpu(tmp_path):
    root = tiny.make_root(str(tmp_path))
    out, log = _recorded_run(root, "serve-open", 2.0, True)
    assert out["correct"] and log["completeness"]["incomplete"] == 0
    assert log["completeness"]["request_spans"] == log["completeness"]["responses"] > 0
    assert log["completeness"]["queue_longer_than_latency"] == 0
    assert log["queue_wait_p90_s"] is not None and log["stamps_per_dispatch_s"] > 0
    assert set(log["idle_split_s"]) <= {"no_span", "service.request", "service.decode",
                                        "service.queue", "service.window", "pipeline.prepare",
                                        "program.replay", "pipeline.fetch", "service.encode"}
    out, log = _recorded_run(root, "serve-b1", 1.0, True)
    assert log["spans"]["pipeline.prepare"]["count"] == log["units"] > 0
    out, log = _recorded_run(root, "train-s2", 1.0, True)
    for name in ("train.feed", "train.loss", "train.backward", "train.update"):
        assert log["spans"][name]["count"] == log["units"] > 0
    out, log = _recorded_run(root, "serve-b1", 1.0, False)
    assert out["correct"] and log["spans"]["program.replay"]["count"] > 0
    # the harness is as it was after the run
    assert reduce.profile.__module__ == "perfbench.harness.reduce"
