"""The port's measurement tools on the CPU, against the JAX package's.

- Each of ``clap2diffusion_tpu_torch/tools/{bench,bench_breakdown,
  bench_serving,bench_train}.py`` (and ``bench_common.py``) imports neither
  ``jax`` nor ``clap2diffusion_tpu`` (a fresh interpreter), and its CLI
  raises without CUDA unless given ``--device cpu``.
- At ``tests/test_pipeline.py::tiny_config`` with 2 steps, each tool's
  ``run(...)`` returns and prints its contract: the headline's four keys
  and metric string with ``vs_baseline == round(2.0 / value, 3)`` as the
  last stdout line and the diag line on stderr; one JSON line per
  component and batch; one line per serving mode and the speedup; the
  stage-1 line.
- The bench's inputs equal the draws of the root ``bench.py`` (its lines
  re-run here as written), and its seed-i images equal ``generate`` of the
  same inputs bit for bit, with and without ``C2D_INT8_WIRE=1`` (the
  weights always come through ``load_pipeline``). ``bench_serving``'s
  request equals the JAX tool's ``build_request`` (loaded from its path:
  the root ``tools/`` is no package). ``bench_train``'s first 3 stage-1 losses equal the JAX
  ``make_stage1_step``'s on the same weights (``from_flax``) and batch
  within 1e-5 of the loss, dropout off on both sides as
  ``tests/test_torch_train.py`` runs stages 2 and 3 (known delta 5).
- ``tools/trace_request.py::summarise_trace``, which the bench reads the
  device's busy time with, sums device events by category.
"""

import base64
import importlib.util
import io
import json
import os
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.core import config as jconfig
from clap2diffusion_tpu.train import stages as jstages
from clap2diffusion_tpu_torch import convert
from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.diffusion.pipeline import (
    AudioToImagePipeline,
    cached_init_params,
    load_pipeline,
)
from clap2diffusion_tpu_torch.tools import bench, bench_breakdown, bench_serving, bench_train
from clap2diffusion_tpu_torch.tools.trace_request import summarise_trace
from clap2diffusion_tpu_torch.train import stages as pstages
from clap2diffusion_tpu_torch.utils import wire
from tests.test_pipeline import tiny_config
from tests.test_torch_models import port_cfg

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"bench": bench, "bench_breakdown": bench_breakdown, "bench_serving": bench_serving,
         "bench_train": bench_train}
STEPS = 2


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("name", [*TOOLS, "bench_common"])
def test_tool_import_loads_neither_jax_nor_the_jax_package(name):
    code = (f"import sys; import clap2diffusion_tpu_torch.tools.{name}; "
            "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'clap2diffusion_tpu')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name", TOOLS)
def test_tool_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TOOLS[name].main([])


def test_bench_inputs_are_the_jax_bench_draws():
    cfg = jconfig.Config()
    # bench.py:217-224, as written there
    rng = np.random.default_rng(0)
    wav = (rng.normal(size=cfg.clap.frontend.num_samples) * 0.1 * 32767.0).clip(
        -32768, 32767
    ).astype(np.int16)
    text_ids = rng.integers(0, 49_000, size=(1, 77)).astype(np.int32)
    ours_wav, ours_ids = bench.bench_inputs(C.Config())
    assert ours_wav.dtype == np.int16 and ours_ids.dtype == np.int32
    np.testing.assert_array_equal(ours_wav, wav)
    np.testing.assert_array_equal(ours_ids, text_ids)


def test_bench_contract_and_images_on_cpu(tmp_path, capsys):
    cfg = port_cfg(tiny_config())
    res = bench.run(cfg=cfg, device="cpu", steps=STEPS, iters=2, cache_dir=str(tmp_path))
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last) == ["metric", "value", "unit", "vs_baseline"]
    assert last["metric"] == "p50 audio+text->512px image latency, 50-step DDIM+CFG, 1 chip"
    assert last["unit"] == "s/image" and last["value"] > 0
    assert last["vs_baseline"] == round(2.0 / last["value"], 3)
    assert last == res["headline"]
    diag = json.loads(err.strip().splitlines()[-1])
    assert diag["diag"] == "bench" and diag == res["diag"]
    for key in ("wall_p50_s", "times", "warmup_s", "ttfi_s", "init_s", "params_cache_hit",
                "device_busy_s", "idle_share", "launches", "card", "power_limit", "int8_wire"):
        assert key in diag, key
    assert diag["card"] == "cpu" and diag["device_busy_s"] is None and not diag["int8_wire"]
    assert len(diag["times"]) == 2 and diag["wall_p50_s"] == pytest.approx(
        float(np.median(diag["times"])))
    assert set(diag["launches"]) == {"flash_attention", "group_norm_silu", "group_norm"}
    # the timed requests are generate's images of the same inputs, seeds 0 and 1
    params = cached_init_params(cfg, 0, torch.bfloat16, str(tmp_path), "cpu")
    pipe = AudioToImagePipeline(cfg, params=params, device="cpu")
    wav, ids = bench.bench_inputs(cfg)
    for i, img in enumerate(res["images"]):
        np.testing.assert_array_equal(
            img, pipe.generate(waveform=wav, text_ids=ids, num_steps=STEPS, seed=i))
    # a second run reads the weights from the cache
    again = bench.run(cfg=cfg, device="cpu", steps=STEPS, iters=1, cache_dir=str(tmp_path))
    assert again["diag"]["params_cache_hit"] and "load_s" in again["diag"]
    np.testing.assert_array_equal(again["images"][0], res["images"][0])


def test_bench_int8_wire_loads_through_load_pipeline(tmp_path, monkeypatch, capsys):
    cfg = port_cfg(tiny_config())
    monkeypatch.setattr(wire, "MIN_WIRE_QUANT_SIZE", 256)  # the tiny towers' leaves are small
    monkeypatch.setenv("C2D_INT8_WIRE", "1")
    res = bench.run(cfg=cfg, device="cpu", steps=STEPS, iters=1, cache_dir=str(tmp_path))
    diag = res["diag"]
    assert diag["int8_wire"] and "init_s" in diag and not diag["params_cache_hit"]
    assert diag["wire_bytes"]["wire_bytes"] < diag["wire_bytes"]["raw_bytes"]
    # the image is the wire pipeline's: the cached weights, quantised on the way in
    pipe = load_pipeline(cfg, diag["params_cache"], dtype=torch.bfloat16, device="cpu")
    wav, ids = bench.bench_inputs(cfg)
    np.testing.assert_array_equal(
        res["images"][0], pipe.generate(waveform=wav, text_ids=ids, num_steps=STEPS, seed=0))
    monkeypatch.delenv("C2D_INT8_WIRE")
    plain = bench.run(cfg=cfg, device="cpu", steps=STEPS, iters=1, cache_dir=str(tmp_path))
    assert plain["diag"]["params_cache_hit"] and plain["diag"]["wire_bytes"] is None
    assert not np.array_equal(plain["images"][0], res["images"][0])


def test_breakdown_prints_a_line_per_component_on_cpu(tmp_path, capsys):
    rows = bench_breakdown.run(cfg=port_cfg(tiny_config()), device="cpu", steps=STEPS,
                               iters=2, batches=(1, 2), dtype=torch.float32,
                               cache_dir=str(tmp_path))
    assert _json_lines(capsys.readouterr().out) == rows
    got = [(r["component"], r["batch"]) for r in rows]
    assert got == [("clap_encode", 1), ("unet_step_cfg", 1), ("vae_decode_512", 1),
                   ("full_2step_b1", 1), ("clap_encode", 2), ("unet_step_cfg", 2),
                   ("vae_decode_512", 2), ("full_2step_b2", 2), ("unet_step_256", 1)]
    for r in rows:
        assert r["card"] == "cpu" and 0 < r["min_ms"] <= r["p50_ms"], r
        assert r.get("device_ms") is None
    by = {(r["component"], r["batch"]): r for r in rows}
    assert by[("unet_step_cfg", 2)]["cfg_batch"] == 4 and by[("unet_step_256", 1)]["latent"] == 32
    full = by[("full_2step_b2", 2)]
    assert full["images_per_s"] == pytest.approx(2e3 / full["p50_ms"])
    only = bench_breakdown.run(cfg=port_cfg(tiny_config()), device="cpu", iters=1,
                               batches=(1,), only=["clap_encode"], dtype=torch.float32,
                               cache_dir=str(tmp_path))
    assert [r["component"] for r in only] == ["clap_encode"]
    with pytest.raises(ValueError, match="unknown components"):
        bench_breakdown.run(cfg=port_cfg(tiny_config()), device="cpu", only=["vae"],
                            cache_dir=str(tmp_path))


def test_serving_request_is_the_jax_tools():
    spec = importlib.util.spec_from_file_location("jax_bench_serving",
                                                  os.path.join(ROOT, "tools", "bench_serving.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    theirs = jax_tool.build_request(jconfig.Config())
    ours = bench_serving.build_request(C.Config())

    def decoded(req):
        with wave.open(io.BytesIO(base64.b64decode(req["audio_b64"]))) as w:
            return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), "<i2")

    (sr_t, pcm_t), (sr_o, pcm_o) = decoded(theirs), decoded(ours)
    assert sr_o == sr_t == 48_000 and pcm_o.size == 480_000
    np.testing.assert_array_equal(pcm_o, pcm_t)
    assert ours == theirs


def test_serving_modes_on_cpu(tmp_path, capsys):
    lines = bench_serving.run(cfg=port_cfg(tiny_config()), device="cpu", steps=STEPS, n=3,
                              window_ms=50.0, max_batch=2, cache_dir=str(tmp_path))
    assert _json_lines(capsys.readouterr().out) == lines
    pipelined, coalesced, speedup = lines
    assert (pipelined["mode"], coalesced["mode"]) == ("pipelined", "coalesced")
    for line in (pipelined, coalesced):
        assert line["served"] == line["requested"] == 3
        assert line["png_shapes"] == [[64, 64, 3]] and line["repeat_equal"]
        assert line["img_s"] == pytest.approx(3 / line["wall_s"])
    assert pipelined["distinct_images"] == 1 and pipelined["max_coalesced_batch"] == 1
    assert pipelined["coalesce"]["batches"] == 0
    assert 1 <= coalesced["max_coalesced_batch"] <= 2 and coalesced["coalesce"]["batches"] >= 2
    assert speedup["speedup"] == pytest.approx(pipelined["wall_s"] / coalesced["wall_s"])


def test_bench_train_losses_match_jax_stage1(monkeypatch, capsys):
    jcfg = jconfig.apply_overrides(tiny_config(), ["train.stage1.grad_accum=1"])
    real_adapter = jstages.AudioAdapter

    class Deterministic:
        def __init__(self, cfg):
            self.module = real_adapter(cfg=cfg)

        def init(self, *args, **kw):
            return self.module.init(*args, **kw)

        def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
            return self.module.apply(variables, *args, deterministic=True, **kw)

    monkeypatch.setattr(jstages, "AudioAdapter", lambda cfg: Deterministic(cfg))
    step_fn, init_tx, adapter = jstages.make_stage1_step(jcfg)
    params = jax.jit(lambda k: adapter.init(k, jnp.ones((1, jcfg.condition.clap_dim))))(
        jax.random.key(0))["params"]
    tx = init_tx(params)
    state = jstages.TrainState.create(params, tx)
    bs = jcfg.train.stage1.batch_size
    batch = {"clap": np.random.default_rng(0).normal(
                 size=(bs, jcfg.condition.clap_dim)).astype(np.float32),
             "text_emb": np.random.default_rng(1).normal(
                 size=(bs, jcfg.condition.token_dim)).astype(np.float32)}
    step = jax.jit(lambda s, b, r: step_fn(s, b, r, tx))
    ref = []
    for i in range(3):
        state, metrics = step(state, batch, jax.random.key(i))
        ref.append(float(metrics["total"]))

    real_loss = pstages._stage1_loss
    monkeypatch.setattr(pstages, "_stage1_loss",
                        lambda stage, st, b, gen, noising, det: real_loss(stage, st, b, gen,
                                                                          noising, True))
    sd = convert.adapter_from_flax(jax.tree.map(np.asarray, params))
    out = bench_train.run(cfg=port_cfg(tiny_config()), device="cpu", steps=2, iters=2,
                          params={"adapter": sd})
    line = _json_lines(capsys.readouterr().out)[-1]
    assert line == {k: v for k, v in out.items() if k != "losses"}
    assert line["batch"] == bs and line["steps_per_chunk"] == 2 and line["timed_chunks"] == 2
    assert line["finite"] and line["steps_per_s"] > 0 and line["card"] == "cpu"
    assert line["samples_per_s"] == pytest.approx(line["steps_per_s"] * bs)
    assert len(out["losses"]) == 6 and line["last_loss"] == out["losses"][-1]
    for i, (ours, want) in enumerate(zip(out["losses"][:3], ref)):
        assert abs(ours - want) <= 1e-5 * max(1.0, abs(want)), (i, ours, want)
    assert ref[2] < ref[0]  # the updates move the loss


def test_summarise_trace_sums_device_events_by_category():
    events = [
        {"cat": "kernel", "name": "void flash_fwd_bf16<40>(...)", "dur": 200.0},
        {"cat": "kernel", "name": "void flash_fwd_bf16<80>(...)", "dur": 100.0},
        {"cat": "kernel", "name": "group_norm_fwd<bf16,bf16>", "dur": 50.0},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "dur": 10.0},
        {"cat": "cpu_op", "name": "aten::mm", "dur": 999.0},
    ]
    s = summarise_trace(events)
    assert s["launches"] == 4
    assert s["device_kernel_s"] == pytest.approx(360e-6)
    assert s["by_category_s"] == pytest.approx({"flash_attention": 300e-6, "groupnorm": 50e-6,
                                                "other": 10e-6})
    assert s["launches_by_category"] == {"flash_attention": 2, "groupnorm": 1, "other": 1}
    assert s["top_kernels"][0] == ("void flash_fwd_bf16<40>(...)", pytest.approx(200e-6))
    assert s["calls_by_kernel"] == {"void flash_fwd_bf16<40>(...)": 1,
                                    "void flash_fwd_bf16<80>(...)": 1,
                                    "group_norm_fwd<bf16,bf16>": 1}
