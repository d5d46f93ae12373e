"""The port's tools and profiling harness on the CPU, against the JAX
package's where it has the same one.

- ``tools/run_lifecycle.py::loss_curve``: the four cases of
  ``tests/test_lifecycle_tool.py``, run against the port's function.
- ``utils/profiling.py``: ``Timer``'s summary keys (JAX's), ``measure`` and
  ``time_fn``; ``device_trace`` writes a Chrome trace that holds a
  ``trace_annotation``.
- ``tools/precompute_embeddings.py`` against the JAX tool on one fixture
  set with the same towers (``from_flax``): ``clap`` and ``text_emb``
  within the slice tests' fp32 tolerance (1e-4), ``text_ctx`` within one
  fp16 rounding; and ``run_stage`` gives the same first loss from either
  cache, which differs from the towers' loss by no more than the cache's
  fp16 rounding moves it.
- ``tools/run_lifecycle.py::run`` at ``tests/test_pipeline.py::tiny_config``
  with the smallest budgets (each stage at its ``steps_per_call``) and a
  dataset of 4 / 2 / 2 samples: it reaches ``lifecycle_summary.json``,
  each stage starts from the weights the one before saved, and the served
  image is the one stage 3's checkpoint gives through the chain; with
  ``resume`` it takes the stages from disk and evaluates (a tiny CLIP
  vision tower, ``tests/test_torch_eval.py::eval_config``).
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

import tests.test_lifecycle_tool as jax_lifecycle_tests
from clap2diffusion_tpu.diffusion.pipeline import init_params as jax_init_params
from clap2diffusion_tpu_torch import convert as bridge
from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset
from clap2diffusion_tpu_torch.tools import precompute_embeddings as ptool
from clap2diffusion_tpu_torch.tools import run_lifecycle as L
from clap2diffusion_tpu_torch.utils import profiling
from tests.test_pipeline import tiny_config
from tests.test_torch_models import port_cfg
from tests.test_torch_trainer import OVERRIDES

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("case", ["test_loss_curve_plain",
                                  "test_loss_curve_preempted_rerun_appends_low_steps",
                                  "test_loss_curve_smoke_rows_before_budget_run",
                                  "test_loss_curve_no_val_rows"])
def test_loss_curve_cases_of_the_jax_tool(case, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_lifecycle_tests, "loss_curve", L.loss_curve)
    getattr(jax_lifecycle_tests, case)(tmp_path)


# -- profiling ---------------------------------------------------------------------

def test_timer_summary_keys_and_fences():
    t = profiling.Timer()
    x = torch.ones(3)
    with t.measure("a", sync=x):
        x = x * 2
    with t.measure("a"):
        pass
    out = t.time_fn("f", lambda v: {"y": v + 1}, x, warmup=1, iters=3)
    assert torch.equal(out["y"], torch.full((3,), 3.0))
    s = t.summary()
    assert sorted(s) == ["a", "f"]
    for row in s.values():
        assert sorted(row) == ["mean", "min", "n", "p50"]
    assert s["a"]["n"] == 2 and s["f"]["n"] == 3
    assert s["f"]["min"] <= s["f"]["p50"] and s["f"]["min"] <= s["f"]["mean"]


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        with profiling.trace_annotation("c2d_stage"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "c2d_stage" for e in events)


# -- precompute_embeddings ---------------------------------------------------------

def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_precompute_embeddings", os.path.join(ROOT, "tools", "precompute_embeddings.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_cfg(cfg):
    """The JAX config of ``OVERRIDES``' data section."""
    import dataclasses

    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, duration_s=0.5,
                                                             latent_shape=(4, 8, 8)))


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The same fixture set twice, one cache written by each tool from the
    same towers (``init_params(cfg, seed=cfg.train.seed)``, as both tools
    draw them)."""
    cfg = tiny_config()
    pcfg = C.apply_overrides(port_cfg(cfg), OVERRIDES + ["train.stage2.steps_per_call=1"])
    jcfg = _jax_cfg(cfg)
    jparams = jax.tree.map(np.asarray, jax_init_params(cfg, seed=cfg.train.seed))
    params = bridge.from_flax(jparams)
    roots = {}
    for who in ("jax", "port", "none"):
        roots[who] = str(tmp_path_factory.mktemp(who))
        make_fixture_dataset(roots[who], n_train=4, n_val=2, n_test=1, duration_s=0.5,
                             latent_hw=8)
    n_j = _jax_tool().precompute(jcfg, jparams, roots["jax"], batch_size=3)
    n_p = ptool.precompute(pcfg, params, roots["port"], batch_size=3, device="cpu")
    return pcfg, params, roots, (n_j, n_p)


def test_precompute_embeddings_matches_the_jax_tool(caches):
    _, _, roots, (n_j, n_p) = caches
    assert n_j == n_p == 7
    names = sorted(os.listdir(os.path.join(roots["jax"], "emb")))
    assert names == sorted(os.listdir(os.path.join(roots["port"], "emb"))) and len(names) == 7
    for name in names:
        with np.load(os.path.join(roots["jax"], "emb", name)) as j, \
                np.load(os.path.join(roots["port"], "emb", name)) as p:
            assert sorted(p.files) == sorted(j.files) == ["clap", "text_ctx", "text_emb"]
            for k in j.files:
                assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape, (name, k)
            np.testing.assert_allclose(p["clap"], j["clap"], atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(p["text_emb"], j["text_emb"], atol=1e-4, rtol=1e-4)
            ctx_p, ctx_j = p["text_ctx"].astype(np.float32), j["text_ctx"].astype(np.float32)
            assert (np.abs(ctx_p - ctx_j) <= 2.0 ** -10 * np.abs(ctx_j) + 1e-6).all(), name


def _first_loss(cfg, params, root, log_dir):
    from clap2diffusion_tpu_torch.train.trainer import run_stage

    run_stage(cfg, 2, params, data_root=root, max_steps=1, log_dir=log_dir, device="cpu")
    with open(os.path.join(log_dir, "stage2.jsonl")) as f:
        return next(r["total"] for r in map(json.loads, f) if "total" in r)


def test_run_stage_first_loss_from_either_cache(caches, tmp_path):
    cfg, params, roots, _ = caches
    losses = {who: _first_loss(cfg, params, root, str(tmp_path / who))
              for who, root in roots.items()}
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    # the cache stands in for the towers: its fp16 text context moves the
    # loss by far less than the loss's own scale
    np.testing.assert_allclose(losses["port"], losses["none"], rtol=1e-3)


def test_precompute_cli_draws_the_towers_of_the_train_seed(caches, tmp_path, capsys,
                                                           monkeypatch):
    cfg, params, roots, _ = caches
    root = str(tmp_path / "cli")
    make_fixture_dataset(root, n_train=2, n_val=0, n_test=0, duration_s=0.5, latent_hw=8)
    monkeypatch.setattr(ptool, "precompute", lambda c, p, r, b, device=None: (
        seen.update(cfg=c, params=p, root=r, batch=b, device=device) or 2))
    monkeypatch.setattr(C, "load_config", lambda path=None, overrides=None: cfg)
    seen = {}
    assert ptool.main(["--data-root", root, "--batch-size", "5", "--device", "cpu"]) == 0
    assert "wrote 2 embedding files" in capsys.readouterr().out
    from clap2diffusion_tpu_torch.diffusion.pipeline import init_params

    want = init_params(cfg, seed=cfg.train.seed, device="cpu")
    assert seen["root"] == root and seen["batch"] == 5 and seen["device"] == "cpu"
    for k, t in want["clap_audio"].items():
        assert torch.equal(seen["params"]["clap_audio"][k], t), k


# -- run_lifecycle -------------------------------------------------------------------

def test_run_lifecycle_chain_at_the_tiny_config(tmp_path, monkeypatch):
    from clap2diffusion_tpu_torch.data.latent_dataset import AudioCapsLatentDataset
    from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline
    from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer
    from clap2diffusion_tpu_torch.train import checkpoint as ckpt
    from clap2diffusion_tpu_torch.train import trainer
    from clap2diffusion_tpu_torch.utils.png import decode_png

    from tests.test_torch_eval import eval_config

    # with a tiny CLIP vision tower, for the evaluation of the resumed run
    cfg = C.apply_overrides(port_cfg(eval_config()), OVERRIDES + [
        f"train.stage{s}.steps_per_call=2" for s in (1, 2, 3)])
    started = {}
    real = trainer.run_stage

    def spy(cfg_, stage, params, **kw):
        started[stage] = {t: {k: v.clone() for k, v in sd.items()} for t, sd in params.items()}
        return real(cfg_, stage, params, **kw)

    monkeypatch.setattr(trainer, "run_stage", spy)
    root = str(tmp_path / "life")
    summary = L.run(cfg, root, scale=0.0, skip_eval=True, device="cpu",
                    n_train=4, n_val=2, n_test=2)
    assert summary["budgets"] == {1: 2, 2: 2, 3: 2}
    with open(os.path.join(root, "lifecycle_summary.json")) as f:
        assert json.load(f)["budgets"] == {"1": 2, "2": 2, "3": 2}
    names = [p["phase"] for p in summary["phases"]]
    assert names[:4] == ["prepare: fixture dataset", "prepare: params (cached init)",
                         "prepare: VAE latent precompute (device)",
                         "prepare: embedding precompute (device)"]
    assert names[4:] == ["stage 1: 2 steps", "stage 2: 2 steps", "stage 3: 2 steps",
                         "export: stage3_final -> reference .pth",
                         "serve: images from the trained checkpoint chain"]
    assert all(p["wall_s"] >= 0 for p in summary["phases"])
    assert summary["phases"][2]["latents"] == summary["phases"][3]["embeddings"] == 8
    assert set(summary["stages"]) == {"stage1", "stage2", "stage3"}

    # each stage started from the weights the one before saved
    ck = os.path.join(root, "ckpt")
    finals = {s: ckpt.load_payload(ck, f"stage{s}_final") for s in (1, 2, 3)}
    for stage in (2, 3):
        for tower, sd in finals[stage - 1]["params"].items():
            for k, t in sd.items():
                assert torch.equal(started[stage][tower][k], t), (stage, tower, k)

    # the served image: stage 3's EMA weights over the chain, in bf16
    params = ckpt.merge_stage_params(started[3], finals[3], 3)
    serve = ckpt.merge_stage_params(params, finals[3], 3, use_ema=True, dtype=torch.bfloat16)
    serve = {t: {k: v.to(torch.bfloat16) for k, v in sd.items()} for t, sd in serve.items()}
    pipe = AudioToImagePipeline(cfg, params=serve, device="cpu")
    item = AudioCapsLatentDataset(os.path.join(root, "ds"), split="test", audio_duration=0.5,
                                  latent_hw=8)[0]
    img = pipe.generate(waveform=item["audio"], text_ids=CLIPTokenizer(max_length=7)(
        item["caption"]), seed=0)
    with open(os.path.join(root, "out", "serve_0.png"), "rb") as f:
        assert np.array_equal(decode_png(f.read()), img[0])

    # --resume takes the dataset and every stage from disk; then the
    # evaluation in both FID variants and sharded (one process)
    started.clear()
    again = L.run(cfg, root, scale=0.0, skip_eval=False, resume=True, device="cpu",
                  n_train=4, n_val=2, n_test=2)
    names = [p["phase"] for p in again["phases"]]
    assert not started and names[4:7] == [f"stage {s}: 2 steps (resumed)" for s in (1, 2, 3)]
    assert again["phases"][0]["samples"] == "cached"
    assert names[9:] == ["evaluate: init metric towers", "evaluate: n=2, torchvision",
                         "evaluate: n=2, pytorch_fid", "evaluate: n=2, sharded"]
    assert sorted(again["eval"]) == ["pytorch_fid", "sharded", "torchvision"]
    for label, res in again["eval"].items():
        assert np.isfinite(res["summary"]["clip_score"]["mean"]), label
        assert os.path.exists(os.path.join(root, "out", f"eval_{label}.json"))
