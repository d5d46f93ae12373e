"""The port's LoRA adapters and UNet rematerialisation on the CPU, against
the JAX package (``clap2diffusion_tpu/train/lora.py``, ``nn.remat``).

- the targets, the fold and the predicate against ``target_paths``,
  ``merge_lora`` and ``lora_trainable`` on the same A/B (``from_flax``);
- the stage-2 loss and the gradient of every trainable leaf, A and B
  included, against ``jax.value_and_grad`` of the jitted JAX step, with
  ``remat`` off and on (and the port's remat gradients against its own
  without remat);
- ``run_stage(..., lora_rank=4, device="cpu")`` moving only the trainable
  leaves, with and without remat; ``merge_stage_params`` folding from the
  EMA shadow as the JAX one does.

fp32 at ``tests/test_pipeline.py::tiny_config``. Tolerances: 1e-4 of
max|ref| (+1e-4 relative) for losses and gradients, as
``tests/test_torch_train.py``; 1e-6 for the fp32 fold; one bf16 ulp for the
bf16 fold (XLA and torch sum A@B in other orders, so a value at a rounding
boundary may round the other way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.core import config as jconfig
from clap2diffusion_tpu.diffusion.pipeline import init_params
from clap2diffusion_tpu.train import checkpoint as jckpt
from clap2diffusion_tpu.train import lora as jlora
from clap2diffusion_tpu.train import stages as jstages
from clap2diffusion_tpu_torch import convert
from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset
from clap2diffusion_tpu_torch.models.unet import UNet2DCondition
from clap2diffusion_tpu_torch.train import checkpoint as ckpt
from clap2diffusion_tpu_torch.train import lora as plora
from clap2diffusion_tpu_torch.train import stages as pstages
from clap2diffusion_tpu_torch.train.trainer import run_stage
from tests.test_pipeline import tiny_config
from tests.test_torch_models import port_cfg
from tests.test_torch_train import (
    REL,
    _batch,
    _close,
    _jax_loss_and_grads,
    _port_loss_and_grads,
)
from tests.test_torch_trainer import OVERRIDES

torch.set_num_threads(2)

RANK = 4


def _jax_cfg(remat=False):
    cfg = jconfig.apply_overrides(tiny_config(), [
        "train.compute_dtype=float32", f"train.stage2.lora_rank={RANK}",
        "train.stage2.lora_alpha=8.0"])
    if remat:
        cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
            cfg.diffusion, unet=dataclasses.replace(cfg.diffusion.unet, remat=True)))
    return cfg


def _jax_lora(params, seed=3):
    """A JAX adapter tree with B drawn too (B = 0 would give A no gradient)."""
    tree = jax.tree.map(np.asarray, jlora.init_lora(params["unet"], RANK,
                                                    jax.random.key(seed), alpha=8.0))
    rng = np.random.default_rng(seed)
    for key, ab in tree.items():
        if key != "alpha":
            tree[key] = {"a": ab["a"], "b": (0.05 * rng.normal(size=ab["b"].shape))
                         .astype(np.float32)}
    return tree


@pytest.fixture(scope="module")
def tiny():
    jcfg = _jax_cfg()
    params = jax.tree.map(np.asarray, init_params(jcfg, seed=0))
    return jcfg, port_cfg(jcfg), params


def test_targets_match_jax_target_paths(tiny):
    _, _, params = tiny
    unet = convert.unet_from_flax(params["unet"])
    jtree = jlora.init_lora(params["unet"], RANK, jax.random.key(0))
    ported = convert.lora_from_flax(jax.tree.map(np.asarray, jtree))
    names = plora.target_names(unet)
    assert len(names) == len(jlora.target_paths(params["unet"])) > 0
    assert plora.adapted_names(ported) == names
    ends = (".to_q.weight", ".to_k.weight", ".to_v.weight", ".to_out.0.weight")
    assert all(".attn2." in n and n.endswith(ends) for n in names)
    assert {e for e in ends if any(n.endswith(e) for n in names)} == set(ends)
    # nothing of the audio-injection branches sits under attn2
    assert not any("audio_inject" in n for n in names)
    # the port's own draw has JAX's shapes: a [in, r], b [r, out] zero
    mine = plora.init_lora(unet, RANK, torch.Generator().manual_seed(1), alpha=8.0)
    assert sorted(mine) == sorted(ported)
    for k, v in ported.items():
        assert mine[k].shape == v.shape and mine[k].dtype == torch.float32, k
    assert all(float(mine[k].abs().max()) == 0 for k in mine if k.endswith(".b"))
    assert float(mine["alpha"]) == 8.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_init_fold_is_the_identity(tiny, dtype):
    _, _, params = tiny
    unet = {k: v.to(dtype) for k, v in convert.unet_from_flax(params["unet"]).items()}
    lora = plora.init_lora(unet, RANK, torch.Generator().manual_seed(0))
    merged = plora.merge_lora(unet, lora)
    assert sorted(merged) == sorted(unet)
    for k, v in unet.items():
        assert merged[k].dtype == dtype and torch.equal(merged[k], v), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_equals_jax_merge_lora(tiny, dtype):
    """W' = W + (alpha/r)(A B)^T in fp32, rounded to W's type, as JAX's
    ``merge_lora`` folds the same A/B into the same weights."""
    _, _, params = tiny
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tree = _jax_lora(params)
    junet = jax.tree.map(lambda x: jnp.asarray(x, jdt), params["unet"])
    want = convert.unet_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                               jlora.merge_lora(junet, tree)))
    pdt = getattr(torch, dtype)
    unet = {k: v.to(pdt) for k, v in convert.unet_from_flax(params["unet"]).items()}
    got = plora.merge_lora(unet, convert.lora_from_flax(tree))
    changed = 0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == pdt, k
        if dtype == "float32":
            _close(g, w, 1e-6, k)
        else:  # one bf16 ulp at most, where the fp32 sums straddle a boundary
            ulp = torch.finfo(torch.bfloat16).eps * w.abs().clamp(min=1e-30)
            assert bool(((g.float() - w).abs() <= ulp).all()), k
        changed += not torch.equal(g.float(), unet[k].float())
    assert changed == len(plora.adapted_names(convert.lora_from_flax(tree)))


def test_trainable_predicate_matches_jax(tiny):
    jcfg, pcfg, params = tiny
    jtrain = jstages.make_stage2_step(jcfg)[0].trainable
    ours = pstages.make_stage2_step(pcfg).trainable
    tree = _jax_lora(params)
    for key in tree:
        if key == "alpha":
            assert not jtrain(("lora", "alpha")) and not ours("lora.alpha")
            continue
        name = plora.adapted_names(convert.lora_from_flax({"alpha": 1.0, key: tree[key]}))[0]
        for part in ("a", "b"):
            assert jtrain(("lora", key, part)) and ours(f"lora.{name}.{part}")
    # the adapted UNet weights stay frozen in both
    for name in plora.target_names(convert.unet_from_flax(params["unet"])):
        assert not ours(f"unet.{name}")
    assert not plora.lora_trainable("unet.x.attn2.to_q.weight")
    assert pstages.make_stage2_step(pcfg).towers == ("hierarchical", "unet", "lora")
    # stages 1 and 3 ignore lora_rank, as the JAX trainer reads it only in stage 2
    assert "lora" not in pstages.make_stage3_step(pcfg).towers


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_stage2_lora_loss_and_grads_match_jax(tiny, monkeypatch, remat):
    """The loss and the gradient of every trainable leaf, A and B of every
    adapter included, against the jitted JAX step (its remat step with
    ``remat``)."""
    _, _, base = tiny
    jcfg = _jax_cfg(remat)
    pcfg = port_cfg(jcfg)
    assert pcfg.diffusion.unet.remat == remat
    params = {**base, "lora": _jax_lora(base)}
    batch, noise, t = _batch(jcfg)
    jlosses, jgrads = _jax_loss_and_grads(monkeypatch, jcfg, 2, params, batch, noise, t)
    _, _, losses, grads = _port_loss_and_grads(pcfg, 2, params, batch, noise, t)
    for k, v in jlosses.items():
        if np.ndim(v) == 0:
            _close(losses[k], v, REL, k)
    conv = {"hierarchical": convert.hierarchical_from_flax, "unet": convert.unet_from_flax,
            "lora": convert.lora_from_flax}
    ref = {f"{tw}.{n}": g for tw, sub in jgrads.items()
           for n, g in conv[tw](jax.tree.map(np.asarray, sub)).items()}
    assert set(grads) <= set(ref)
    adapters = [n for n in grads if n.startswith("lora.")]
    assert len(adapters) == 2 * len(plora.target_names(convert.unet_from_flax(base["unet"])))
    for name, g in grads.items():
        _close(g, ref[name], REL, name)
    moved = [n for n in adapters if float(np.abs(ref[n].numpy()).max()) > 0]
    assert any(n.endswith(".a") for n in moved) and any(n.endswith(".b") for n in moved)
    assert float(ref["lora.alpha"].abs().max()) == 0.0


def test_remat_gives_the_gradients_of_no_remat(tiny):
    """The port's stage-2 step with ``remat`` against itself without: the
    same loss and gradients (fp32 on the CPU: the recompute runs the same
    ops on the same inputs)."""
    _, pcfg, base = tiny
    params = {**base, "lora": _jax_lora(base)}
    batch, noise, t = _batch(_jax_cfg())
    out = {}
    for remat in (False, True):
        cfg = C.apply_overrides(pcfg, [f"diffusion.unet.remat={str(remat).lower()}"])
        _, _, losses, grads = _port_loss_and_grads(cfg, 2, params, batch, noise, t)
        out[remat] = (losses, grads)
    assert torch.equal(out[False][0]["total"], out[True][0]["total"])
    for name, g in out[False][1].items():
        _close(out[True][1][name], g, 1e-6, name)


def test_remat_checkpoints_every_block_only_under_autograd(tiny, monkeypatch):
    """Every ResnetBlock and Transformer2D runs under torch.utils.checkpoint
    when autograd records (the JAX ``nn.remat`` sites), none when serving."""
    import clap2diffusion_tpu_torch.models.unet as U

    _, pcfg, base = tiny
    cfg = C.apply_overrides(pcfg, ["diffusion.unet.remat=true"])
    unet = UNet2DCondition(cfg.diffusion.unet)
    unet.load_state_dict(convert.unet_from_flax(base["unet"]))
    calls = []
    real = U.checkpoint
    monkeypatch.setattr(U, "checkpoint", lambda fn, *a, **kw: calls.append(kw) or real(
        fn, *a, **kw))
    blocks = sum(isinstance(m, (U.ResnetBlock, U.Transformer2D)) for m in unet.modules())
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 8, 4, generator=g)
    ctx = torch.randn(1, 7, 48, generator=g)
    with torch.no_grad():
        served = unet(x, torch.tensor([5]), ctx)
    assert not calls
    x.requires_grad_(True)
    trained = unet(x, torch.tensor([5]), ctx)
    assert len(calls) == blocks > 0
    assert all(kw == {"use_reentrant": False, "preserve_rng_state": False} for kw in calls)
    assert torch.equal(trained.detach(), served)


def test_remat_recomputes_every_block_after_the_first_resnet(tiny, monkeypatch):
    """What the remat micro-step launches again, counted at the tiny size
    (the counts ``chip_smoke.py`` phase 5d asserts at full width are worked
    out the same way): every ResnetBlock but down block 0's first (whose
    inputs need no gradient) runs its two GroupNorm+SiLU again in the
    backward, every Transformer2D its GroupNorm and its self-attention, and
    the forward is unchanged."""
    import clap2diffusion_tpu_torch.models.layers as layers
    import clap2diffusion_tpu_torch.ops.attention as attention
    import clap2diffusion_tpu_torch.models.unet as U

    _, pcfg, base = tiny
    params = {**base, "lora": _jax_lora(base)}
    batch, noise, t = _batch(_jax_cfg())
    counts = {}
    real_gn, real_dpa = layers.GroupNorm.forward, attention.dot_product_attention

    def gn(self, x):
        key = "group_norm_silu" if self.silu else "group_norm"
        counts[key] = counts.get(key, 0) + 1
        return real_gn(self, x)

    def dpa(q, k, v, **kw):
        if kw.get("use_flash"):
            counts["self_attention"] = counts.get("self_attention", 0) + 1
        return real_dpa(q, k, v, **kw)

    monkeypatch.setattr(layers.GroupNorm, "forward", gn)
    monkeypatch.setattr(attention, "dot_product_attention", dpa)
    got = {}
    for remat in (False, True):
        cfg = C.apply_overrides(pcfg, ["diffusion.unet.flash_attention=true",
                                       f"diffusion.unet.remat={str(remat).lower()}"])
        st = pstages.make_stage2_step(cfg)
        sd = convert.from_flax(params)
        state = st.create_state({tw: {n: v.clone() for n, v in sd[tw].items()}
                                 for tw in st.towers})
        counts.clear()
        total, _ = st.loss(state, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
                           noising=(torch.from_numpy(noise), torch.from_numpy(t).long()),
                           deterministic=True)
        forward = dict(counts)
        pstages.grads_of(total, state.trainable_leaves())
        got[remat] = (forward, dict(counts))
    unet = UNet2DCondition(pcfg.diffusion.unet)
    resnets = sum(isinstance(m, U.ResnetBlock) for m in unet.modules())
    transformers = sum(isinstance(m, U.Transformer2D) for m in unet.modules())
    want = {"group_norm_silu": 2 * resnets + 1, "group_norm": transformers,
            "self_attention": transformers}
    assert got[False] == (want, want) and got[True][0] == want
    assert got[True][1] == {"group_norm_silu": want["group_norm_silu"] + 2 * (resnets - 1),
                            "group_norm": 2 * transformers,
                            "self_attention": 2 * transformers}


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lora_fixture"))
    make_fixture_dataset(root, n_train=4, n_val=0, n_test=0, duration_s=0.5, latent_hw=8)
    return root


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_run_stage_lora_moves_only_the_trainable_leaves(tiny, fixture_root, tmp_path, remat):
    _, pcfg, base = tiny
    params = convert.from_flax(base)
    cfg = C.apply_overrides(pcfg, OVERRIDES + [
        "train.stage2.eval_every=0", f"diffusion.unet.remat={str(remat).lower()}"])
    state = run_stage(cfg, 2, params, data_root=fixture_root, max_steps=4,
                      checkpoint_dir=str(tmp_path / "ck"), log_dir=str(tmp_path / "logs"),
                      device="cpu")
    assert sorted(state.params) == ["hierarchical", "lora", "unet"]
    trainable = pstages.make_stage2_step(cfg).trainable
    for tw in ("hierarchical", "unet"):
        for n, t in state.params[tw].items():
            if not trainable(f"{tw}.{n}"):
                assert torch.equal(t.detach(), params[tw][n]), f"{tw}.{n}"
    # A from the generator of seed + 0x10A5, B from zero; both moved
    first = plora.init_lora(params["unet"], RANK,
                            torch.Generator().manual_seed(cfg.train.seed + 0x10A5), alpha=8.0)
    lora = state.params["lora"]
    assert torch.equal(lora["alpha"], first["alpha"])
    moved = {k for k in first if k != "alpha" and not torch.equal(lora[k].detach(), first[k])}
    assert any(k.endswith(".a") for k in moved) and any(k.endswith(".b") for k in moved)
    assert set(state.ema) >= {f"lora.{k}" for k in first if k != "alpha"}
    # the checkpoint holds the adapters and the pruned UNet; it folds for serving
    payload = ckpt.load_payload(str(tmp_path / "ck"), "stage2_final")
    assert sorted(payload["params"]["lora"]) == sorted(first)
    assert all(k.startswith("audio_inject.") for k in payload["params"]["unet"])
    served = ckpt.merge_stage_params(params, payload, 2)
    assert "lora" not in served
    assert served["unet"].keys() == params["unet"].keys()
    want = plora.merge_lora({**params["unet"], **payload["params"]["unet"]},
                            payload["params"]["lora"])
    assert all(torch.equal(served["unet"][k], want[k]) for k in want)


def test_merge_stage_params_folds_from_the_ema_as_jax(tiny):
    """The EMA shadow's adapters (only some leaves shadowed, as the JAX test
    has it) folded into the UNet: the port's merge against the JAX one on
    the same payload, and no fold on an empty base (the export path)."""
    _, _, params = tiny
    tree = _jax_lora(params)
    key = next(k for k in tree if k != "alpha")
    shadow_b = np.full_like(tree[key]["b"], 0.5)
    jpayload = {"params": {"hierarchical": params["hierarchical"], "unet": params["unet"],
                           "lora": tree},
                "ema_params": {f"lora.{key}.b": shadow_b}}
    want = jckpt.merge_stage_params(params, jpayload, stage=2, use_ema=True)
    assert "lora" not in want

    ported = convert.from_flax(params)
    lora = convert.lora_from_flax(tree)
    name = plora.adapted_names(convert.lora_from_flax({"alpha": 1.0, key: tree[key]}))[0]
    payload = {"params": {"hierarchical": ported["hierarchical"], "unet": ported["unet"],
                          "lora": lora},
               "ema_params": {f"lora.{name}.b": torch.from_numpy(shadow_b)}}
    got = ckpt.merge_stage_params(ported, payload, 2, use_ema=True)
    assert "lora" not in got
    ref = convert.unet_from_flax(jax.tree.map(np.asarray, want["unet"]))
    for k, w in ref.items():
        _close(got["unet"][k], w, 1e-6, k)
    live = ckpt.merge_stage_params(ported, {**payload, "ema_params": None}, 2)
    assert not torch.equal(live["unet"][name], got["unet"][name])
    assert torch.equal(payload["params"]["lora"][f"{name}.b"], lora[f"{name}.b"])  # no alias
    # no base weights to fold into: skipped, as JAX skips it
    bare = ckpt.merge_stage_params({}, {"params": {"unet": {
        k: v for k, v in ported["unet"].items() if k.startswith("audio_inject.")},
        "lora": lora}}, 2)
    assert "lora" not in bare and all(k.startswith("audio_inject.") for k in bare["unet"])
