"""The port's span recorder (``utils/profiling.py``), the spans of serving
and training, and the device program's stage stamps (``ops/stage_clock.py``),
on the CPU at ``tests/test_pipeline.py::tiny_config``:

- recording off keeps nothing; spans nest with their unit's id and parent;
  recordings nest; many threads recording at once lose no span;
- spans opened on the coalescer's worker and fetcher threads are kept, and
  ``device_trace`` writes them into its Chrome trace;
- a coalesced request's stages, each present once, in order, inside its
  ``service.request``, and the service's ``/metrics`` stages;
- the stage stamps are monotone and their sum is no more than the
  request's wall time; two requests in flight, and two replays of one
  captured program, each carry their own stamps;
- ``train_step`` and ``embed_batch`` record the micro-step's four phases.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from clap2diffusion_tpu_torch.apps.server import STAGES, InferenceService
from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.diffusion import program as prog
from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline, init_params
from clap2diffusion_tpu_torch.ops import stage_clock
from clap2diffusion_tpu_torch.parallel.sharding import make_train_mesh
from clap2diffusion_tpu_torch.train.stages import BATCH_KEYS, train_step
from clap2diffusion_tpu_torch.train.trainer import EmbeddingFrontend, stage_state
from clap2diffusion_tpu_torch.utils import profiling
from tests.test_pipeline import tiny_config
from tests.test_torch_models import port_cfg
from tests.test_torch_trainer import OVERRIDES

torch.set_num_threads(2)

MAX_LEN = 7  # tiny_config's CLIP length
REQUEST = ("service.decode", "service.queue", "service.encode")
DISPATCH = ("service.window", "pipeline.prepare", "program.replay", "pipeline.fetch")


@pytest.fixture(scope="module")
def pipe():
    return AudioToImagePipeline(port_cfg(tiny_config()), seed=0, device="cpu")


def _ids(seed):
    return (np.random.default_rng(seed).integers(1, 97, size=(1, MAX_LEN))).astype(np.int32)


def test_recording_off_keeps_nothing():
    assert profiling.span("x") is profiling.span("y", id=1, a=2)  # one shared no-op
    with profiling.span("before"):
        pass
    profiling.record("before", 0, 1)
    with profiling.recording() as rec:
        pass
    with profiling.span("after"):
        pass
    assert rec.spans == []


def test_spans_nest_with_their_unit_and_recordings_nest():
    with profiling.recording() as outer:
        with profiling.span("unit", id=3, kind="request"):
            with profiling.recording() as inner:
                with profiling.span("stage", id=3, parent=3):
                    time.sleep(0.001)
    stage, unit = outer.spans
    assert inner.spans == [stage]
    assert (unit.name, unit.id, unit.parent, unit.attrs) == ("unit", 3, None,
                                                             {"kind": "request"})
    assert (stage.name, stage.id, stage.parent) == ("stage", 3, 3)
    assert unit.t_start_ns <= stage.t_start_ns < stage.t_end_ns <= unit.t_end_ns
    assert stage.seconds >= 0.001 and stage.thread == unit.thread == threading.get_native_id()


def test_threads_recording_at_once_lose_no_span():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, n_spans = 2 * (os.cpu_count() or 2), 200

    def work(k):
        for i in range(n_spans):
            with profiling.span("w", id=k, parent=i):
                pass

    try:
        with profiling.recording() as rec:
            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(rec.spans) == n_threads * n_spans
    assert {(s.id, s.parent) for s in rec.spans} == {
        (k, i) for k in range(n_threads) for i in range(n_spans)}


def _request(seed, text="rain"):
    return {"text": text, "steps": 2, "seed": seed}


def _serve_concurrently(service, reqs):
    out = [None] * len(reqs)

    def go(i):
        out[i] = service.generate(reqs[i])

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
        time.sleep(0.05)
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return out


def test_a_coalesced_requests_stages_in_order_inside_it(pipe):
    service = InferenceService(pipe=pipe, coalesce_ms=2000, coalesce_max_batch=2)
    service.generate(_request(9))  # a group of one: every stage once more
    with profiling.recording() as rec:
        t0 = time.perf_counter_ns()
        outs = _serve_concurrently(service, [_request(3), _request(5, "wind")])
        wall = time.perf_counter_ns() - t0
    assert [o["info"]["coalesced_batch"] for o in outs] == [2, 2]
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append(s)
    assert len(by["service.request"]) == 2 and len(by["service.window"]) == 1
    did = by["service.window"][0].id
    assert sorted(by["service.window"][0].attrs["requests"]) == sorted(
        r.id for r in by["service.request"])
    for name in DISPATCH + stage_clock.STAGES:
        assert [(s.id, s.parent) for s in by[name]] == [(did, did)], name
    prep, replay, fetch = (by[n][0] for n in DISPATCH[1:])
    window = by["service.window"][0]
    for req in by["service.request"]:
        rid = req.id
        decode, queue, encode = (next(s for s in by[n] if s.id == rid) for n in REQUEST)
        assert (queue.parent, queue.attrs["dispatch"]) == (rid, did)
        ordered = [req.t_start_ns, decode.t_start_ns, decode.t_end_ns, queue.t_start_ns,
                   queue.t_end_ns, prep.t_start_ns, prep.t_end_ns, replay.t_start_ns,
                   replay.t_end_ns, fetch.t_end_ns, encode.t_start_ns, encode.t_end_ns,
                   req.t_end_ns]
        assert ordered == sorted(ordered)
        assert queue.t_end_ns == window.t_end_ns <= prep.t_start_ns
    # the window opens at the group's first arrival
    assert window.t_start_ns >= min(q.t_start_ns for q in by["service.queue"])
    # the device stages: stamps in order, their sum within the requests' wall time
    device = [by[n][0] for n in stage_clock.STAGES]
    assert all(s.attrs["clock"] == "device" and s.t_end_ns >= s.t_start_ns for s in device)
    assert all(a.t_end_ns == b.t_start_ns for a, b in zip(device, device[1:]))
    assert sum(s.t_end_ns - s.t_start_ns for s in device) <= min(
        r.t_end_ns - r.t_start_ns for r in by["service.request"]) <= wall
    stages = service.metrics()["stages"]
    assert set(stages) == set(STAGES)
    assert all(v["count"] == 3 and 0 <= v["p50"] <= v["p90"] for v in stages.values())


def test_coalescer_threads_spans_reach_the_chrome_trace(pipe, tmp_path):
    service = InferenceService(pipe=pipe, coalesce_ms=1, coalesce_max_batch=2)
    with profiling.device_trace(str(tmp_path)):
        service.generate(_request(4))
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "program_span"]
    tids = {e["name"]: e["tid"] for e in events}
    main = threading.get_native_id()
    assert tids["service.request"] == tids["service.queue"] == main
    worker = service.coalescer._thread.native_id
    fetcher = service.coalescer._fetch_thread.native_id
    assert tids["service.window"] == tids["pipeline.prepare"] == worker != main
    assert tids["pipeline.fetch"] == fetcher not in (worker, main)
    assert not any(e["name"].startswith("device.") for e in events)  # the device's clock
    req = next(e for e in events if e["name"] == "service.request")
    fetch = next(e for e in events if e["name"] == "pipeline.fetch")
    assert req["ts"] <= fetch["ts"] and fetch["ts"] + fetch["dur"] <= req["ts"] + req["dur"]


def test_each_request_in_flight_carries_its_own_stamps(pipe):
    kw = dict(text_ids=_ids(1), num_steps=2)
    t0 = time.perf_counter_ns()
    first = pipe._dispatch_generate(seed=1, **kw)
    second = pipe._dispatch_generate(seed=2, **kw)
    first.numpy(), second.numpy()
    wall = time.perf_counter_ns() - t0
    a, b = first.host_stamps.numpy(), second.host_stamps.numpy()
    for s in (a, b):
        assert s.shape == (stage_clock.SLOTS,) and (np.diff(s) >= 0).all()
    assert a[-1] <= b[0] and (b[-1] - b[0]) + (a[-1] - a[0]) <= wall
    assert first.dispatch_id != second.dispatch_id
    assert set(first.stages) == {"prepare", "replay", "fetch", *stage_clock.STAGES}
    assert first.stages["device.unet_loop"] == pytest.approx((a[3] - a[2]) / 1e9)


def test_two_replays_of_one_graph_each_keep_their_stamps():
    """A replay writes the graph's one output buffer: the clone taken at
    each replay keeps that replay's images and stamps."""
    cap = object.__new__(prog.Captured)
    cap.inputs, cap.launches, cap.replays = {"a": torch.zeros(1)}, {}, 0
    cap.output = (torch.zeros(2, dtype=torch.uint8), torch.zeros(5, dtype=torch.int64))

    class Graph:
        def replay(self):  # what the captured program writes
            cap.output[0].fill_(int(cap.inputs["a"]))
            cap.output[1].copy_(torch.arange(5) + 10 * int(cap.inputs["a"]))

    cap.graph = Graph()
    one = cap({"a": torch.ones(1)})
    two = cap({"a": torch.full((1,), 2.0)})
    assert one[0].tolist() == [1, 1] and one[1].tolist() == [10, 11, 12, 13, 14]
    assert two[0].tolist() == [2, 2] and two[1].tolist() == [20, 21, 22, 23, 24]
    assert cap.replays == 2


def test_train_step_records_the_micro_steps_phases():
    cfg = C.apply_overrides(port_cfg(tiny_config()), OVERRIDES)
    params = init_params(cfg, seed=0, device="cpu")
    st, state, _ = stage_state(cfg, 2, params, make_train_mesh(1), torch.device("cpu"), 0)
    frontend = EmbeddingFrontend(cfg, params, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"audio": rng.normal(size=(2, 8_000)).astype(np.float32) * 0.1,
             "caption": ["a dog", "rain"], "latent": rng.normal(size=(2, 8, 8, 4))}
    gen = torch.Generator().manual_seed(0)
    with profiling.recording() as rec:
        for _ in range(2):
            step = state.step
            emb = frontend.embed_batch(batch, step=step)
            train_step(st, state, {k: emb[k] for k in BATCH_KEYS[2]}, gen)
    names = ["train.feed", "train.loss", "train.backward", "train.update"]
    assert [s.name for s in rec.spans] == names * 2
    assert [(s.id, s.parent) for s in rec.spans] == [(0, 0)] * 4 + [(1, 1)] * 4
    ends = [t for s in rec.spans for t in (s.t_start_ns, s.t_end_ns)]
    assert ends == sorted(ends)
