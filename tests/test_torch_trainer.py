"""The port's training loop end to end on the CPU.

The data path against the JAX one (the same fixture files and the same
batches from the same seed and shard), ``run_stage`` for stages 1, 2 and 3
at ``tests/test_pipeline.py::tiny_config`` (frozen leaves unchanged,
trainable leaves moved), checkpoint save / restore / resume with the frozen
UNet body pruned, and a merged stage served through the port's pipeline.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.data.fixtures import make_fixture_dataset as j_fixture
from clap2diffusion_tpu.data.latent_dataset import AudioCapsLatentDataset as JDataset
from clap2diffusion_tpu.data.latent_dataset import PrefetchLoader as JLoader
from clap2diffusion_tpu.diffusion.pipeline import init_params
from clap2diffusion_tpu_torch import convert
from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset
from clap2diffusion_tpu_torch.data.latent_dataset import AudioCapsLatentDataset, PrefetchLoader
from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline
from clap2diffusion_tpu_torch.train import checkpoint as ckpt
from clap2diffusion_tpu_torch.train import stages as pstages
from clap2diffusion_tpu_torch.train.trainer import run_stage
from tests.test_pipeline import tiny_config
from tests.test_torch_models import port_cfg

torch.set_num_threads(2)

OVERRIDES = [
    "data.latent_shape=[4,8,8]", "data.duration_s=0.5", "train.compute_dtype=float32",
    "train.stage1.batch_size=2", "train.stage2.batch_size=2", "train.stage3.batch_size=2",
    "train.stage1.grad_accum=2", "train.stage2.grad_accum=2", "train.stage3.grad_accum=2",
    "train.stage1.warmup_steps=1", "train.stage2.warmup_steps=1", "train.stage3.lr=1e-3",
    "train.stage1.lr=1e-3", "train.stage2.lr=1e-3",
]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fixture"))
    make_fixture_dataset(root, n_train=4, n_val=2, n_test=1, duration_s=0.5, latent_hw=8)
    cfg = C.apply_overrides(port_cfg(tiny_config()), OVERRIDES)
    params = convert.from_flax(jax.tree.map(np.asarray, init_params(tiny_config(), seed=0)))
    return cfg, params, root


def test_fixture_files_match_jax(tmp_path):
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    make_fixture_dataset(ours, n_train=3, n_val=1, n_test=1, duration_s=0.2, latent_hw=8)
    j_fixture(ref, n_train=3, n_val=1, n_test=1, duration_s=0.2, latent_hw=8)
    for sub in ("audio", "latents", ""):
        names = sorted(f for f in os.listdir(os.path.join(ref, sub))
                       if os.path.isfile(os.path.join(ref, sub, f)))
        assert names == sorted(f for f in os.listdir(os.path.join(ours, sub))
                               if os.path.isfile(os.path.join(ours, sub, f)))
        for f in names:
            with open(os.path.join(ours, sub, f), "rb") as a, \
                    open(os.path.join(ref, sub, f), "rb") as b:
                assert a.read() == b.read(), f


@pytest.mark.parametrize("pairing", ["matching", "random"])
def test_dataset_and_loader_give_the_jax_batches(tmp_path, pairing):
    root = str(tmp_path)
    make_fixture_dataset(root, n_train=7, n_val=2, n_test=1, duration_s=0.3, latent_hw=8,
                         sample_rate=16_000)
    kw = dict(split="train", audio_duration=0.25, sample_rate=24_000,
              composition_strategy=pairing, seed=3, latent_hw=8)
    ours, ref = AudioCapsLatentDataset(root, **kw), JDataset(root, **kw)
    assert len(ours) == len(ref) == 7
    for epoch in (0, 1):
        got = list(PrefetchLoader(ours, 2, seed=9, shard_index=1, num_shards=2).epoch(epoch))
        want = list(JLoader(ref, 2, seed=9, shard_index=1, num_shards=2).epoch(epoch))
        assert len(got) == len(want) == 1
        for a, b in zip(got, want):
            assert a["audio_id"] == b["audio_id"] and a["caption"] == b["caption"]
            np.testing.assert_array_equal(a["latent"], b["latent"])
            # both resample 16 -> 24 kHz with the same polyphase filter
            np.testing.assert_allclose(a["audio"], b["audio"], atol=1e-6)


def test_zero_fallbacks_and_loader_errors(tmp_path):
    root = str(tmp_path)
    make_fixture_dataset(root, n_train=2, n_val=0, n_test=0, duration_s=0.1, latent_hw=8)
    np.save(os.path.join(root, "latents", "sample_00000.npy"), np.ones((3, 3), np.float32))
    with open(os.path.join(root, "audio", "sample_00001.wav"), "wb") as f:
        f.write(b"garbage")
    ds = AudioCapsLatentDataset(root, audio_duration=0.1, latent_hw=8)
    assert not ds[0]["latent"].any() and ds[0]["latent"].shape == (8, 8, 4)
    assert not ds[1]["audio"].any() and ds[1]["audio"].shape == (4800,)
    with pytest.raises(ValueError, match="fewer than batch_size"):
        next(PrefetchLoader(ds, 4).epoch(0))


def _changed(before, after):
    return not torch.equal(before.cpu(), after.detach().cpu())


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_run_stage_trains_only_trainable_leaves(setup, tmp_path, stage):
    cfg, params, root = setup
    state = run_stage(cfg, stage, params, data_root=root, max_steps=4,
                      log_dir=str(tmp_path), device="cpu")
    assert state.step == 4 and state.opt.count == 2
    trainable = pstages.MAKE_STAGE[stage](cfg).trainable
    moved = frozen_same = 0
    for tw, sd in state.params.items():
        for n, t in sd.items():
            if trainable(f"{tw}.{n}"):
                moved += _changed(params[tw][n], t)
            else:
                assert not _changed(params[tw][n], t), f"{tw}.{n} moved"
                frozen_same += 1
    assert moved > 0 and (stage == 1 or frozen_same > 0)
    with open(tmp_path / f"stage{stage}.jsonl") as f:
        rec = [json.loads(line) for line in f]
    # steps_per_call (50 and 25 by default) > max_steps: one log, at the end
    assert [r["step"] for r in rec] == [4] and np.isfinite(rec[0]["total"])
    assert set(state.ema) == {f"{tw}.{n}" for tw, sd in state.params.items() for n in sd
                              if trainable(f"{tw}.{n}")}


def test_checkpoint_resume_and_merge_serve(setup, tmp_path):
    cfg, params, root = setup
    ck, logs = str(tmp_path / "ck"), str(tmp_path / "logs")
    cfg2 = C.apply_overrides(cfg, ["train.stage2.save_every=2", "train.stage2.eval_every=2"])
    run_stage(cfg2, 2, params, data_root=root, max_steps=2, checkpoint_dir=ck, log_dir=logs,
              device="cpu")
    payload = ckpt.load_payload(ck, "stage2_final")
    assert payload["step"] == 2 and payload["opt_state"]["count"] == 1
    unet = payload["params"]["unet"]
    assert unet and all("audio_inject" in n for n in unet)  # the frozen body is pruned
    assert os.path.isdir(os.path.join(ck, "stage2_step2"))
    assert os.path.isdir(os.path.join(ck, "stage2_best"))
    with open(os.path.join(logs, "stage2.jsonl")) as f:
        assert any("val_total" in json.loads(line) for line in f)

    # a resume that has no step left restores exactly what was saved
    restored = run_stage(cfg2, 2, params, data_root=root, max_steps=2, checkpoint_dir=ck,
                         log_dir=logs, resume_from="stage2_final", device="cpu")
    name = "audio_inject.early.audio_proj.0.weight"
    assert restored.step == 2 and restored.opt.count == 1
    assert torch.equal(restored.params["unet"][name], unet[name])
    assert torch.equal(restored.params["unet"]["conv_in.weight"], params["unet"]["conv_in.weight"])
    assert torch.equal(restored.opt.mu[f"unet.{name}"], payload["opt_state"]["mu"][f"unet.{name}"])
    resumed = run_stage(cfg2, 2, params, data_root=root, max_steps=4, checkpoint_dir=ck,
                        log_dir=logs, resume_from="stage2_final", device="cpu")
    assert resumed.step == 4 and resumed.opt.count == 2

    assert ckpt.stage_from_name("stage2_final") == 2
    merged = ckpt.merge_stage_params(params, payload, 2, use_ema=True)
    torch.testing.assert_close(merged["unet"][name], payload["ema_params"][f"unet.{name}"])
    assert torch.equal(merged["unet"]["conv_in.weight"], params["unet"]["conv_in.weight"])
    pipe = AudioToImagePipeline(port_cfg(tiny_config()), params=merged, device="cpu")
    img = pipe.generate(waveform=np.sin(np.linspace(0, 300, 24_000)).astype(np.float32),
                        num_steps=2, seed=1)
    assert img.shape == (1, 64, 64, 3) and img.dtype == np.uint8 and img.std() > 0


def test_preemption_signal_saves_a_resumable_checkpoint(setup, tmp_path, monkeypatch):
    """A SIGTERM during training saves ``stage2_preempt`` after the current
    micro-step and re-raises the signal with the caller's handler back in
    place (the re-raise is recorded here instead of delivered)."""
    import signal

    from clap2diffusion_tpu_torch.train import trainer

    cfg, params, root = setup
    before = signal.getsignal(signal.SIGTERM)
    raised, inner = [], trainer.train_step

    def step_then_signal(st, state, batch, gen):
        out = inner(st, state, batch, gen)
        if state.step == 2:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return out

    monkeypatch.setattr(trainer, "train_step", step_then_signal)
    monkeypatch.setattr(signal, "raise_signal", raised.append)
    ck = str(tmp_path / "ck")
    run_stage(cfg, 2, params, data_root=root, max_steps=3, checkpoint_dir=ck,
              log_dir=str(tmp_path), device="cpu")
    assert raised == [signal.SIGTERM]
    assert signal.getsignal(signal.SIGTERM) is before
    assert ckpt.load_payload(ck, "stage2_preempt")["step"] == 2
    assert ckpt.load_payload(ck, "stage2_final")["step"] == 3


def test_merge_stage1_and_prune_rules(setup):
    _, params, _ = setup
    payload = {"params": {"adapter": {k: v + 1 for k, v in params["adapter"].items()}},
               "ema_params": None}
    merged = ckpt.merge_stage_params(params, payload, 1)
    k = next(iter(params["adapter"]))
    assert torch.equal(merged["adapter"][k], params["adapter"][k] + 1)
    with pytest.raises(ValueError, match="ema_params"):
        ckpt.merge_stage_params(params, payload, 1, use_ema=True)
    pruned = ckpt.prune_frozen_unet({"unet": {"conv_in.weight": 1, "audio_inject.mid.alpha": 2},
                                     "hierarchical": {"a": 3}}, pstages.stage3_trainable)
    assert pruned == {"unet": {"audio_inject.mid.alpha": 2}, "hierarchical": {"a": 3}}
    assert "unet" not in ckpt.prune_frozen_unet({"unet": {"conv_in.weight": 1}},
                                                 pstages.stage3_trainable)


def test_embedding_cache_is_used(setup, tmp_path):
    from clap2diffusion_tpu_torch.train.trainer import EmbeddingFrontend

    cfg, params, root = setup
    fe = EmbeddingFrontend(cfg, params, data_root=str(tmp_path), device="cpu")
    batch = {"audio": np.zeros((2, 24_000), np.float32), "latent": np.zeros((2, 8, 8, 4)),
             "caption": ["a", "b"], "audio_id": ["x", "y"]}
    fresh = fe.embed_batch(batch)
    os.makedirs(tmp_path / "emb")
    for i, sid in enumerate(("x", "y")):
        np.savez(tmp_path / "emb" / f"{sid}.npz", clap=np.full(32, i, np.float32),
                 text_ctx=np.zeros((7, 48), np.float32), text_emb=np.zeros(48, np.float32))
    cached = fe.embed_batch(batch)
    assert cached["clap"][1, 0] == 1 and fresh["clap"].shape == cached["clap"].shape


def test_run_stage_refuses_what_is_not_ported(setup, monkeypatch):
    cfg, params, root = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_stage(cfg, 2, params, data_root=root)
