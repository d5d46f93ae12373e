"""The port's training slice against the JAX package, on the CPU in fp32.

Configuration sections, the temperature schedule, the losses, the adapter,
the trainable-leaf predicates (through ``convert.from_flax``), the
optimizer stack against optax, and the stage-2/3 loss and gradient of every
trainable leaf against ``jax.value_and_grad`` of the JAX stage step, with
the same weights, noise and timesteps and dropout off, at
``tests/test_pipeline.py::tiny_config``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clap2diffusion_tpu.core import config as jconfig
from clap2diffusion_tpu.diffusion.pipeline import init_params
from clap2diffusion_tpu.train import losses as JL
from clap2diffusion_tpu.train import optim as joptim
from clap2diffusion_tpu.train import stages as jstages
from clap2diffusion_tpu_torch import convert
from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.train import losses as PL
from clap2diffusion_tpu_torch.train import optim as poptim
from clap2diffusion_tpu_torch.train import stages as pstages
from tests.test_pipeline import tiny_config
from tests.test_torch_models import port_cfg

torch.set_num_threads(2)

REL = 1e-4  # fp32 parity: XLA:CPU and torch sum in different orders


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _close(ours, ref, rel=REL, err_msg=""):
    """|a - b| <= rel * max|b| + rel * |b|, elementwise."""
    a = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    b = np.asarray(ref)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * float(np.abs(b).max() or 1.0),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfig.apply_overrides(tiny_config(), ["train.compute_dtype=float32"])
    params = jax.tree.map(np.asarray, init_params(jcfg, seed=0))
    return jcfg, port_cfg(jcfg), params


# -- configuration --------------------------------------------------------------


def test_data_and_train_sections_match_jax_defaults_and_yaml():
    for path in (None, "configs/default.yaml"):
        ours, ref = C.load_config(path), jconfig.load_config(path)
        for section in ("data", "train"):
            assert dataclasses.asdict(getattr(ours, section)) == \
                dataclasses.asdict(getattr(ref, section)), (path, section)
        assert dataclasses.asdict(ours.diffusion.unet) == dataclasses.asdict(ref.diffusion.unet)
    overrides = ["train.stage2.lr=3e-4", "train.stage3.grad_accum=2", "data.batch_size=2",
                 "train.compute_dtype=float32", "data.latent_shape=[4,8,8]",
                 "train.stage1.use_ema=false"]
    ours = C.load_config("configs/default.yaml", overrides)
    ref = jconfig.load_config("configs/default.yaml", overrides)
    assert dataclasses.asdict(ours.train) == dataclasses.asdict(ref.train)
    assert dataclasses.asdict(ours.data) == dataclasses.asdict(ref.data)
    assert ours.train.stage2.lr == 3e-4 and ours.data.latent_shape == (4, 8, 8)
    with pytest.raises(KeyError):
        C.apply_overrides(ours, ["train.stage2.nope=1"])


def test_temperature_schedule_matches_jax():
    from clap2diffusion_tpu.models.condition.temperature import temperature_at_step as jtemp
    from clap2diffusion_tpu_torch.models.condition.temperature import (
        temperature_at_step,
        temperature_from_config,
    )

    steps = np.arange(0, 6001)
    for kw in ({}, {"mode": "linear"}, {"total_steps": 100, "warmup_steps": 200},
               {"t_max": 3.0, "t_min": 0.05, "total_steps": 1000, "warmup_steps": 0}):
        ref = np.asarray(jtemp(steps, **kw))
        ours = np.array([temperature_at_step(int(s), **kw) for s in steps], np.float32)
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7, err_msg=str(kw))
    cfg = C.Config().condition
    assert temperature_from_config(0, cfg) == pytest.approx(2.0)
    assert temperature_from_config(10_000, cfg) == pytest.approx(0.5)


# -- losses and the adapter ------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    tokens = rng.normal(size=(4, 5, 16)).astype(np.float32)
    text = rng.normal(size=(4, 16)).astype(np.float32)
    routed = {k: rng.normal(size=(4, 5, 16)).astype(np.float32) for k in ("early", "mid", "late")}
    eps, noise = (rng.normal(size=(4, 8, 8, 4)).astype(np.float32) for _ in range(2))
    ref1, ours1 = JL.stage1_losses(tokens, text, 0.07), PL.stage1_losses(_t(tokens), _t(text), 0.07)
    for k in ("mse", "infonce", "total"):
        _close(ours1[k], ref1[k], 1e-6, k)
    _close(PL.diffusion_mse(_t(eps), _t(noise)), JL.diffusion_mse(eps, noise), 1e-6)
    _close(PL.consistency_loss({k: _t(v) for k, v in routed.items()}),
           JL.consistency_loss(routed), 1e-6)
    _close(PL.alignment_loss(_t(tokens), _t(text)), JL.alignment_loss(tokens, text), 1e-6)
    w = {"mse": 0.5, "infonce": 2.0, "absent": 3.0}
    _close(PL.weighted_total(ours1, w), JL.weighted_total(ref1, w), 1e-6)


def test_condition_losses_and_stats_match_jax():
    from clap2diffusion_tpu.models.condition import hierarchical as jh
    from clap2diffusion_tpu_torch.models.condition import hierarchical as ph

    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 10, 3)).astype(np.float32) * 2
    a = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    tok = rng.normal(size=(3, 10, 24)).astype(np.float32)
    prior = np.array([0.5, 0.3, 0.2], np.float32)
    ref = jh.compute_condition_losses(a, tok, prior)
    ours = ph.compute_condition_losses(_t(a), _t(tok), _t(prior))
    for k in ("entropy", "orthogonality", "prior"):
        _close(ours[k], ref[k], 1e-6, k)
    ref_s, ours_s = jh.assignment_stats(a), ph.assignment_stats(_t(a))
    for k in ("avg_assignment", "entropy", "effective_levels"):
        _close(ours_s[k], ref_s[k], 1e-6, k)


def test_hierarchical_return_all_carries_losses_and_stats(tiny):
    from clap2diffusion_tpu.models.condition.hierarchical import HierarchicalAudioEncoder as JH
    from clap2diffusion_tpu_torch.models.condition.hierarchical import HierarchicalAudioEncoder

    jcfg, pcfg, params = tiny
    x = np.random.default_rng(2).normal(size=(3, 32)).astype(np.float32)
    apply = jax.jit(lambda p, x: JH(cfg=jcfg.condition).apply({"params": p}, x, 1.3,
                                                              return_all=True))
    _, ref = apply(params["hierarchical"], x)
    m = HierarchicalAudioEncoder(pcfg.condition)
    m.load_state_dict(convert.from_flax(params)["hierarchical"])
    _, info = m(_t(x), 1.3, return_all=True)
    for k in ("entropy", "orthogonality", "prior"):
        _close(info["losses"][k], ref["losses"][k], REL, k)
    _close(info["stats"]["avg_assignment"], ref["stats"]["avg_assignment"], REL)


def test_dropout_is_seeded_and_off_when_deterministic(tiny):
    from clap2diffusion_tpu_torch.models.condition.hierarchical import HierarchicalAudioEncoder

    _, pcfg, params = tiny
    m = HierarchicalAudioEncoder(pcfg.condition)
    m.load_state_dict(convert.from_flax(params)["hierarchical"])
    x = _t(np.random.default_rng(3).normal(size=(2, 32)))
    det = m(x, 2.0)

    def noisy(seed):
        return m(x, 2.0, deterministic=False, generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(noisy(5), noisy(5), atol=0, rtol=0)
    assert not torch.equal(noisy(5), noisy(6)) and not torch.equal(noisy(5), det)
    torch.testing.assert_close(m(x, 2.0, deterministic=True), det, atol=0, rtol=0)
    with pytest.raises(ValueError, match="Generator"):
        m(x, 2.0, deterministic=False)


def test_audio_adapter_matches_jax(tiny):
    from clap2diffusion_tpu.models.condition.adapter import AudioAdapter as JA
    from clap2diffusion_tpu_torch.models.condition.adapter import AudioAdapter

    jcfg, pcfg, params = tiny
    x = np.random.default_rng(4).normal(size=(3, 32)).astype(np.float32)
    ref = JA(cfg=jcfg.condition).apply({"params": params["adapter"]}, x)
    m = AudioAdapter(pcfg.condition)
    m.load_state_dict(convert.from_flax(params)["adapter"], strict=True)
    _close(m(_t(x)), ref, REL)
    # the reference's names: the JAX converter reads the state dict back leaf for leaf
    from clap2diffusion_tpu.models.condition.convert import convert_audio_adapter

    back = convert_audio_adapter({k: v.numpy() for k, v in m.state_dict().items()},
                                 jcfg.condition.adapter_self_attn_layers)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(params["adapter"])[0])
    assert sorted(map(str, flat_back)) == sorted(map(str, flat_ref))
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=str(k))


# -- trainable leaves --------------------------------------------------------------


def _leaf_map(params, towers):
    """Port leaf name -> the flax paths whose values it holds (a marker
    tree through ``from_flax``: every flax leaf filled with its own id)."""
    ids, paths = {}, {}

    def mark(path, x):
        i = len(ids) + 1
        ids[i] = path
        return np.full(np.shape(x), i, np.float32)

    marked = {tw: jax.tree_util.tree_map_with_path(
        lambda p, x, tw=tw: mark((tw,) + joptim._path_strings(p), x), params[tw])
        for tw in towers}
    conv = {"hierarchical": convert.hierarchical_from_flax, "unet": convert.unet_from_flax,
            "adapter": convert.adapter_from_flax}
    for tw in towers:
        for name, t in conv[tw](marked[tw]).items():
            paths[f"{tw}.{name}"] = {ids[int(i)] for i in np.unique(t.numpy())}
    assert sum(len(v) for v in paths.values()) == len(ids)  # every flax leaf lands once
    return paths


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_trainable_predicates_select_the_jax_leaves(tiny, stage):
    jcfg, pcfg, params = tiny
    towers = pstages.MAKE_STAGE[stage](pcfg).towers
    if stage == 1:
        jtrain = lambda path: True  # noqa: E731  (stage 1 trains the whole adapter)
    else:
        jstep = {2: jstages.make_stage2_step, 3: jstages.make_stage3_step}[stage](jcfg)[0]
        jtrain = jstep.trainable
    ours = pstages.MAKE_STAGE[stage](pcfg).trainable
    n_train = 0
    for name, flax_paths in _leaf_map(params, towers).items():
        # stage-1 flax paths start at the adapter tree itself
        want = {jtrain(p if stage > 1 else p[1:]) for p in flax_paths}
        assert len(want) == 1, (name, flax_paths)
        assert ours(name) == want.pop(), name
        n_train += ours(name)
    assert n_train > 0


# -- optimizer ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["warmup_cosine", "cosine", "constant"])
def test_lr_schedule_matches_optax(kind):
    kw = dict(steps=50, lr=3e-3, warmup_steps=7, min_lr=1e-4, lr_schedule=kind)
    ref = joptim.lr_schedule(jconfig.StageConfig(**kw))
    ours = poptim.lr_schedule(C.StageConfig(**kw))
    for n in range(0, 60):
        assert ours(n) == pytest.approx(float(ref(n)), rel=1e-6, abs=1e-12), n


def test_optimizer_matches_optax_with_accumulation_clip_and_mask():
    kw = dict(steps=6, lr=5e-2, warmup_steps=1, grad_accum=2, grad_clip=0.7,
              weight_decay=0.1, min_lr=1e-3, lr_schedule="warmup_cosine")
    rng = np.random.default_rng(0)
    params = {"a": {"kernel": rng.normal(size=(4, 3)).astype(np.float32)},
              "b": {"bias": rng.normal(size=(5,)).astype(np.float32)},
              "frozen": {"kernel": rng.normal(size=(3,)).astype(np.float32)}}
    tx = joptim.make_optimizer(jconfig.StageConfig(**kw), joptim.path_matcher("a", "b"), params)
    ost, jp = tx.init(params), params
    ours = {"a.kernel": _t(params["a"]["kernel"]), "b.bias": _t(params["b"]["bias"])}
    opt = poptim.Optimizer(C.StageConfig(**kw), ours)
    applied = []
    for i in range(6):  # 3 updates; the gradient scales straddle the clip
        g = {k: {n: (rng.normal(size=v.shape) * (0.1 if i % 3 else 2.0)).astype(np.float32)
                 for n, v in sub.items()} for k, sub in params.items()}
        upd, ost = tx.update(g, ost, jp)
        jp = optax.apply_updates(jp, upd)
        applied.append(opt.step({"a.kernel": _t(g["a"]["kernel"]), "b.bias": _t(g["b"]["bias"])}))
        np.testing.assert_allclose(ours["a.kernel"].numpy(), jp["a"]["kernel"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(ours["b.bias"].numpy(), jp["b"]["bias"], rtol=1e-6, atol=1e-6)
    assert applied == [False, True] * 3 and opt.count == 3
    np.testing.assert_array_equal(np.asarray(jp["frozen"]["kernel"]),
                                  params["frozen"]["kernel"])
    assert not np.allclose(ours["a.kernel"].numpy(), params["a"]["kernel"])


def test_optimizer_state_round_trip():
    cfg = C.StageConfig(grad_accum=2, lr_schedule="constant", lr=0.1)
    p = {"w": torch.ones(3)}
    opt = poptim.Optimizer(cfg, p)
    opt.step({"w": torch.full((3,), 0.5)})
    other = poptim.Optimizer(cfg, {"w": torch.ones(3)})
    other.load_state_dict(opt.state_dict())
    assert other.mini_step == 1 and torch.equal(other.acc["w"], opt.acc["w"])


def test_ema_balancer_and_adaptive_clip_match_jax():
    ema = {"k": torch.zeros(3)}
    poptim.ema_update(ema, {"k": torch.ones(3)}, 0.9)
    ref = joptim.ema_update({"k": jnp.zeros(3)}, {"k": jnp.ones(3)}, 0.9)
    _close(ema["k"], ref["k"], 1e-7)

    seq = [{"a": 10.0, "b": 1.0}, {"a": 8.0, "b": 1.5}, {"a": 12.0}, {"a": 9.0, "b": 0.5}]
    jb, pb = joptim.LossBalancer(["a", "b"], 2), poptim.LossBalancer(["a", "b"], 2)
    for losses in seq:
        assert pb.update(losses) == pytest.approx(jb.update(losses))

    jclip = joptim.adaptive_clip_by_global_norm(max_norm=1.0, history=4, min_samples=3)
    st = jclip.init(None)
    pclip = poptim.AdaptiveClip(max_norm=1.0, history=4, min_samples=3)
    rng = np.random.default_rng(5)
    for i in range(9):
        g = (rng.normal(size=(4,)) * (30.0 if i in (4, 7) else 0.2)).astype(np.float32)
        out, st = jclip.update({"k": jnp.asarray(g)}, st)
        _close(pclip({"k": _t(g)})["k"], out["k"], 1e-5, str(i))


# -- stage loss and gradients -------------------------------------------------------


def _batch(jcfg, b=2, seed=7):
    rng = np.random.default_rng(seed)
    lat = jcfg.diffusion.image_size // 8
    batch = {
        "clap": rng.normal(size=(b, jcfg.condition.clap_dim)).astype(np.float32),
        "latent": rng.normal(size=(b, lat, lat, 4)).astype(np.float32),
        "text_ctx": rng.normal(size=(b, 7, jcfg.diffusion.unet.cross_attention_dim))
        .astype(np.float32),
        "text_emb": rng.normal(size=(b, jcfg.condition.token_dim)).astype(np.float32),
    }
    noise = rng.normal(size=batch["latent"].shape).astype(np.float32)
    t = np.array([17, 803][:b], np.int32)
    return batch, noise, t


def _jax_loss_and_grads(monkeypatch, jcfg, stage, params, batch, noise, t):
    """The JAX stage step with dropout off and the given noise and t; the
    gradient is captured by a transformation that applies no update."""
    real = jstages.HierarchicalAudioEncoder

    class Deterministic:
        def __init__(self, cfg):
            self.module = real(cfg=cfg)

        def apply(self, variables, *args, deterministic=True, rngs=None, **kw):
            return self.module.apply(variables, *args, deterministic=True, **kw)

    monkeypatch.setattr(jstages, "HierarchicalAudioEncoder", lambda cfg: Deterministic(cfg))
    monkeypatch.setattr(jstages, "_sample_noising", lambda schedule, latents, rng: (
        schedule.add_noise(latents, jnp.asarray(noise), jnp.asarray(t)), jnp.asarray(noise),
        jnp.asarray(t)))
    step_fn = {2: jstages.make_stage2_step, 3: jstages.make_stage3_step}[stage](jcfg)[0]
    # the optimizer state carries the gradient out of the jitted step
    tx = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                      lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    towers = pstages.MAKE_STAGE[stage](port_cfg(jcfg)).towers
    state = jstages.TrainState.create({tw: params[tw] for tw in towers}, tx)
    new_state, losses = jax.jit(lambda s, b, r: step_fn(s, b, r, tx))(
        state, batch, jax.random.key(0))
    return losses, new_state.opt_state


def _port_loss_and_grads(pcfg, stage, params, batch, noise, t):
    st = pstages.MAKE_STAGE[stage](pcfg)
    sd = convert.from_flax(params)
    state = st.create_state({tw: {n: v.clone() for n, v in sd[tw].items()} for tw in st.towers})
    total, losses = st.loss(state, {k: _t(v) for k, v in batch.items()}, None,
                            noising=(_t(noise), torch.from_numpy(t).long()), deterministic=True)
    return st, state, losses, pstages.grads_of(total, state.trainable_leaves())


@pytest.mark.parametrize("stage", [2, 3])
def test_stage_loss_and_trainable_grads_match_jax(tiny, monkeypatch, stage):
    jcfg, pcfg, params = tiny
    batch, noise, t = _batch(jcfg)
    jlosses, jgrads = _jax_loss_and_grads(monkeypatch, jcfg, stage, params, batch, noise, t)
    _, _, losses, grads = _port_loss_and_grads(pcfg, stage, params, batch, noise, t)
    for k, v in jlosses.items():
        if np.ndim(v) == 0:
            _close(losses[k], v, REL, k)
    conv = {"hierarchical": convert.hierarchical_from_flax, "unet": convert.unet_from_flax,
            "adapter": convert.adapter_from_flax}
    ref = {f"{tw}.{n}": g for tw, sub in jgrads.items()
           for n, g in conv[tw](jax.tree.map(np.asarray, sub)).items()}
    assert grads and set(grads) <= set(ref)
    nonzero = 0
    for name, g in grads.items():
        _close(g, ref[name], REL, name)
        nonzero += bool(np.abs(ref[name].numpy()).max() > 0)
    assert nonzero >= 2
    if stage == 2:  # the projector trains, but its tokens feed no stage-2 loss term
        proj = [n for n in grads if n.startswith("hierarchical.projector.")]
        assert proj and all(float(np.abs(ref[n].numpy()).max()) == 0.0 for n in proj)
    # frozen leaves get no gradient in JAX either
    for name in set(ref) - set(grads):
        assert float(np.abs(ref[name].numpy()).max()) == 0.0, name


def test_stage3_unet_graph_comes_only_from_the_decomposer_output_proj(tiny):
    """The JAX stage-3 predicate's ``output_proj`` substring selects
    ``decomposer.cross_hierarchy_attn.output_proj``, which feeds the routed
    tokens and so the UNet: JAX differentiates through the UNet in stage 3
    and so does the port. Frozen, that leaf leaves the UNet output with no
    autograd graph at all."""
    jcfg, pcfg, params = tiny
    batch, noise, t = _batch(jcfg)
    st, state, _, grads = _port_loss_and_grads(pcfg, 3, params, batch, noise, t)
    upstream = sorted(n for n in grads if n.startswith("hierarchical.decomposer."))
    assert upstream == ["hierarchical.decomposer.cross_hierarchy_attn.output_proj.bias",
                        "hierarchical.decomposer.cross_hierarchy_attn.output_proj.weight"]
    seen = {}
    real = st.modules["unet"].forward

    def spy(*a, **kw):
        seen["eps"] = real(*a, **kw)
        return seen["eps"]

    st.modules["unet"].forward = spy
    for n in upstream:
        state.params["hierarchical"][n.split(".", 1)[1]].requires_grad_(False)
    b = {k: _t(v) for k, v in batch.items()}
    st.loss(state, b, None, noising=(_t(noise), torch.from_numpy(t).long()), deterministic=True)
    assert seen["eps"].grad_fn is None and not seen["eps"].requires_grad
