"""The harness on the CPU at a tiny size: cells found by name, a cell made
only of new files, the open loop's schedule and counts, the roofline and
mfu arithmetic, the result line's keys and the JAX guard."""

from __future__ import annotations

import io
import json
import math
import os
import subprocess
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import torch

from perfbench.harness import common, reduce, serve, traffic, work
from perfbench.harness.runner import run_cell
from perfbench.tests import tiny

CPU = torch.device("cpu")


def run(root, name, seed=3_000_000_017, seconds=1.0, trace=0):
    cell = common.cell(common.load_benchmark(root), name, root)
    args = common.parse_args(["--workload", name, "--seed", str(seed), "--seconds",
                              str(seconds), "--trace", str(trace)])
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = run_cell(cell, args, CPU, 0.0)
    return out, buf.getvalue().strip().splitlines()[-1]


def test_every_cell_finds_its_files_by_name():
    bench = common.load_benchmark()
    for w in bench["workloads"]:
        c = common.cell(bench, w["name"])
        assert c["config"]["name"] == w["config"]
        assert c["traffic"]["driver"] in ("serve_closed", "serve_open", "train")
        assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}
        assert c["per_layer"]
        for m in c["per_layer"]:
            assert callable(common.metric_reader(m["name"]).read)


def test_a_cell_of_new_files_only_runs_on_the_cpu(tmp_path):
    root = tiny.make_root(str(tmp_path))
    bench = common.load_benchmark(root)
    # a new traffic mix, a new configuration, a new per-layer metric: files and entries only
    with open(os.path.join(root, "perfbench/traffic/batch1-closed.json")) as f:
        mix = json.load(f)
    mix.update(batch=2, check_images=1)
    tiny.write(root, "perfbench/traffic/batch2-closed.json", mix)
    with open(os.path.join(root, "perfbench/configs/sd15-clap-hier-serve.json")) as f:
        cfg = json.load(f)
    cfg["serve"]["steps"] = 2
    tiny.write(root, "perfbench/configs/tiny-two-steps.json", cfg)
    with open(os.path.join(root, "perfbench/metrics/requests_in_window.new.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['requests']\n")
    bench["configs"].append({"name": "tiny-two-steps", "source": "test", "reduced": [],
                             "file": "perfbench/configs/tiny-two-steps.json", "why": "test"})
    bench["workloads"].append({"name": "new-b2", "config": "tiny-two-steps",
                               "traffic": "batch2-closed", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "images_per_s.new", "unit": "images/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["new-b2"]})
    bench["per_layer"].append({"name": "requests_in_window.new", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "service", "moves": "setup_s", "workloads": ["new-b2"]})
    tiny.write(root, "BENCHMARK.json", bench)
    cell = common.cell(common.load_benchmark(root), "new-b2", root)
    cell["end_to_end"] = [m for m in cell["end_to_end"] if m["name"] != "images_per_s.new"]
    args = common.parse_args(["--workload", "new-b2", "--seed", "5", "--seconds", "1",
                              "--trace", "1"])
    with redirect_stdout(io.StringIO()):
        out = run_cell(cell, args, CPU, 0.0)
    assert out["correct"], out
    assert out["metrics"]["requests_in_window.new"]["value"] >= 1
    assert out["attempted"] % 2 == 0


def test_result_line_has_the_contract_keys_and_checks_last(tmp_path):
    root = tiny.make_root(str(tmp_path))
    out, line = run(root, "serve-b1")
    parsed = json.loads(line)
    assert list(parsed) == list(common.RESULT_KEYS) + ["checks"]
    assert parsed["correct"] is True
    assert set(parsed["metrics"]) == {"latency_p50_s", "setup_s"}
    assert set(parsed["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in parsed["checks"].values():
        assert set(c) == {"value", "limit"}


def test_open_loop_offers_exactly_n_and_counts_every_request(tmp_path, monkeypatch):
    due = traffic.due_times(2.5, 4.0)
    assert len(due) == 10 and np.all(np.diff(due) >= 0) and 0 <= due[0] and due[-1] < 4.0
    assert np.array_equal(due, traffic.due_times(2.5, 4.0))
    assert not np.array_equal(due, traffic.due_times(2.5, 4.0, trace_seed=2))
    root = tiny.make_root(str(tmp_path))
    with open(os.path.join(root, "perfbench/traffic/open-coalesced.json")) as f:
        mix = json.load(f)
    mix["rate_per_s"] = 3.0
    tiny.write(root, "perfbench/traffic/open-coalesced.json", mix)
    from clap2diffusion_tpu_torch.apps import server

    slow = server.InferenceService.generate

    def generate(self, req):  # every answer 0.3 s late: latency counts from the due time
        import time
        time.sleep(0.3)
        return slow(self, req)

    monkeypatch.setattr(server.InferenceService, "generate", generate)
    out, _ = run(root, "serve-open", seconds=2.0)
    assert out["attempted"] == 6 and out["failed"] == 0
    assert out["metrics"]["latency_p90_s"]["value"] >= 0.3
    assert out["correct"]


def test_open_loop_traces_its_whole_window(tmp_path):
    root = tiny.make_root(str(tmp_path))
    cell = common.cell(common.load_benchmark(root), "serve-open", root)
    args = common.parse_args(["--workload", "serve-open", "--seed", "41", "--seconds", "2",
                              "--trace", "1"])
    res = serve.open_loop(cell, args, CPU, 0.0, True)
    assert res["checks"] and all(c["ok"] for c in res["checks"])
    assert 2.0 <= res["ctx"]["traced_window_s"] < 2.5


def test_closed_loop_checks_distinct_lanes_both_ends_among_them():
    for seed in (1, 2**31 + 7, 99):
        picks = serve.image_sample(seed, requests=20, batch=8, k=3)
        lanes = [lane for _, lane in picks]
        assert len(set(lanes)) == 3 and {0, 7} <= set(lanes)
        assert len({r for r, _ in picks}) == 3 and all(0 <= r < 20 for r, _ in picks)
    assert [lane for _, lane in serve.image_sample(5, 9, 1, 3)] == [0, 0, 0]
    assert len(serve.image_sample(5, 2, 1, 3)) == 2
    assert sorted(lane for _, lane in serve.image_sample(5, 9, 2, 2)) == [0, 1]


def test_serving_inputs_exist_for_any_request_and_repeat_by_seed():
    mix = json.load(open(os.path.join(common.ROOT, "perfbench/traffic/batch8-closed.json")))
    mix["audio"].update(seconds=0.1, pool=8)
    mix["prompts"]["pool"] = 8
    a, b = (serve.Inputs(mix, 2**31 + 3, 8, 7) for _ in range(2))
    for i in (0, 1, 12345, serve.Inputs.WARMUP):
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra["seeds"], rb["seeds"]) and len(set(ra["seeds"])) == 8
        assert np.array_equal(ra["waveform"], rb["waveform"])
        assert len({w.tobytes() for w in ra["waveform"]}) == 8
    assert not np.array_equal(a.request(0)["seeds"], a.request(1)["seeds"])


def test_roofline_and_mfu_on_hand_counted_shapes():
    rec = work.Recorder()
    rec.attention = [(2, 8, 4096, 4096, 40)]
    w = work.attention_work(rec, 2)
    assert w["attn_fwd_flops"] == 4 * 2 * 8 * 4096 * 4096 * 40
    assert w["attn_fwd_bytes"] == 2 * 8 * (4 * 4096 * 40) * 2
    assert w["attn_bwd_flops"] == 8 * 2 * 8 * 4096 * 4096 * 40
    assert w["attn_bwd_bytes"] == 2 * 8 * (8 * 4096 * 40) * 2
    peaks = {"flops_bf16": 989e12, "bytes_per_s": 3.35e12}
    # compute-bound: 42.9 GFLOP in 0.1 ms of kernel time
    share = reduce.roofline(w["attn_fwd_flops"], w["attn_fwd_bytes"], 1e-4, peaks)
    assert math.isclose(share, 100 * (w["attn_fwd_flops"] / 989e12) / 1e-4)
    # bandwidth-bound: 1 GB moved, no operations, in 1 ms
    assert math.isclose(reduce.roofline(0.0, 1e9, 1e-3, peaks), 100 * (1e9 / 3.35e12) / 1e-3)
    assert reduce.roofline(1.0, 1.0, 0.0, peaks) is None
    from perfbench.harness import readers

    trace = types.SimpleNamespace(window_s=2.0, busy_s=1.5)
    ctx = {"trace": trace, "peaks": peaks, "requests": 4, "work": {"flops": 1e14}}
    assert math.isclose(readers.mfu(ctx), 100 * 4e14 / (2.0 * 989e12))
    assert math.isclose(readers.idle_share(ctx), 25.0)


def test_work_counts_the_unet_and_its_long_attention():
    cell = common.cell(common.load_benchmark(), "serve-b1")
    fam = common.family(cell)
    ns = common.namespace(tiny.tiny_model())
    w = fam.request_work(ns, batch=2, steps=3, itemsize=2)
    assert w["flops"] > 0 and w["gn_calls"] > 0 and w["gn_bytes"] > 0
    # the tiny UNet's longest attention is 64 tokens: none reaches 256 queries
    assert w["attn_calls"] == 0
    full = common.namespace(cell["config"]["model"])
    w1 = fam.request_work(full, batch=1, steps=1, itemsize=2)
    # one UNet forward at CFG batch 2: 5 self-attentions each at 4096, 1024 and 256 tokens
    # (the 64-token middle block is not counted), and the VAE's one at 4096 tokens
    assert w1["attn_calls"] == 16
    d = 40
    assert w1["attn_fwd_flops"] >= 5 * 4 * 2 * 8 * 4096 * 4096 * d


def test_trace_reduction_names_gaps_and_keeps_kernel_names_apart():
    k = "at::native::elementwise_kernel_128__4__at::native::gpu_kernel_impl<"
    events = [
        {"cat": "user_annotation", "name": "bench/window", "ts": 0.0, "dur": 100.0},
        {"cat": "user_annotation", "name": "bench/fetch", "ts": 40.0, "dur": 30.0},
        {"cat": "kernel", "name": k + "A>(...)::{lambda}" + "x" * 60, "ts": 0.0, "dur": 20.0},
        {"cat": "kernel", "name": k + "B>(...)::{lambda}" + "x" * 60, "ts": 30.0, "dur": 10.0},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 80.0, "dur": 10.0},
    ]
    t = reduce.Trace(events)
    assert math.isclose(t.busy_s, 40e-6) and math.isclose(t.window_s, 100e-6)
    names = [n for n, _ in t.top_ops()]
    assert len(set(names)) == len(names) == 3
    gaps = dict((n, s) for n, s in t.idle_gaps())
    assert math.isclose(gaps["fetch"], 40e-6)
    assert "no_span" in gaps


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert "clap2diffusion_tpu_torch" not in common.FORBIDDEN
    monkeypatch.setitem(sys.modules, "jaxlike_package", types.ModuleType("jaxlike_package"))
    assert common.forbidden_modules() == [] or all(
        m.split(".")[0] in common.FORBIDDEN for m in common.forbidden_modules())
    monkeypatch.setitem(sys.modules, "clap2diffusion_tpu.ops", types.ModuleType("x"))
    assert "clap2diffusion_tpu.ops" in common.forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    root = tiny.make_root(str(tmp_path))
    code = (
        "import sys, io, contextlib\n"
        f"sys.path.insert(0, {common.ROOT!r})\n"
        "import torch\n"
        "from perfbench.harness import common\n"
        "from perfbench.harness.runner import run_cell\n"
        f"root = {root!r}\n"
        "for name in ('serve-b1', 'train-s2', 'serve-open'):\n"
        "    cell = common.cell(common.load_benchmark(root), name, root)\n"
        "    args = common.parse_args(['--workload', name, '--seed', '9', '--seconds', '1',"
        " '--trace', '0'])\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        assert run_cell(cell, args, torch.device('cpu'), 0.0)['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = dict(os.environ, C2D_SILENCE_TOKENIZER_WARNING="1")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(common.FORBIDDEN)
    assert "clap2diffusion_tpu_torch" in loaded


def test_run_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(common.ROOT, "perfbench", "run.py"),
                          "--workload", "serve-b1", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, env=env,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
