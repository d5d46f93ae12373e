"""Weights I/O of the PyTorch port against the JAX package, on the CPU.

- safetensors: files the port writes are read by the JAX reader (and by
  the ``safetensors`` package where it is installed), and the other way
  round, F32, F16, BF16 and integers included;
- converters: each port converter, on a synthetic upstream state dict with
  the extras and prefixes of the published layouts, gives exactly
  ``convert.*_from_flax`` of the JAX converter's tree (tolerance 0, fp32);
  the legacy V4 converter, which ``from_flax`` does not cover, gives
  exactly the JAX export of the JAX converter's tree. A missing key and a
  wrong shape raise, naming the key;
- export: each port exporter on ``from_flax(jax_params)`` equals the JAX
  exporter on ``jax_params``, key for key, tolerance 0;
- modules: ``GatedAudioCrossAttention`` and ``HierarchicalAudioV4``
  against the JAX modules, within 1e-5 in fp32;
- loading and saving: ``load_torch_checkpoint`` on a reference-format
  ``.pth``, the ``save_pipeline`` -> ``load_pipeline`` round trip (same
  bits), geometry and missing-tower errors with the JAX messages,
  a load under ``C2D_INT8_WIRE=1``, ``cached_init_params`` hit and miss.

Sizes are ``tests/test_pipeline.py::tiny_config``'s; the conditioning
converters run at the reference's own geometry (``ConditionConfig()``,
from the committed shape manifest of ``tests/goldens``).
"""

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.diffusion.pipeline import init_params as jax_init_params
from clap2diffusion_tpu.models import convert as jconv
from clap2diffusion_tpu.models.clap import convert as jclap
from clap2diffusion_tpu.models.condition import convert as jcond
from clap2diffusion_tpu.models.condition import export as jexp
from clap2diffusion_tpu.utils import safetensors_io as jst
from clap2diffusion_tpu_torch import convert as bridge
from clap2diffusion_tpu_torch.core.config import ConditionConfig
from clap2diffusion_tpu_torch.diffusion import pipeline as P
from clap2diffusion_tpu_torch.models import convert as pconv
from clap2diffusion_tpu_torch.models.clap import convert as pclap
from clap2diffusion_tpu_torch.models.condition import convert as pcond
from clap2diffusion_tpu_torch.models.condition import export as pexp
from clap2diffusion_tpu_torch.train.checkpoint import load_torch_checkpoint
from clap2diffusion_tpu_torch.utils import safetensors_io as pst
from tests.golden_utils import load_shapes, synth_state_dict, synth_value
from tests.test_pipeline import tiny_config
from tests.test_sd_convert import _synth_diffusers_unet_sd
from tests.test_torch_models import port_cfg

torch.set_num_threads(2)

REF_COND = ConditionConfig()  # the reference's conditioning geometry


def equal_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape), k
        assert torch.equal(g, torch.as_tensor(np.asarray(w, np.float32))), k


def filled(tag, shapes, prefix=""):
    """A synthetic state dict: ``prefix + name`` -> seeded torch tensor."""
    return {prefix + k: torch.from_numpy(synth_value(tag, k, tuple(s)))
            for k, s in shapes.items()}


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    return cfg, port_cfg(cfg), jax.tree.map(np.asarray, jax_init_params(cfg, seed=0))


# -- safetensors ----------------------------------------------------------------

def test_safetensors_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.normal(size=(7,)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.normal(size=(4, 2)).astype(np.float32)).bfloat16(),
        "i64": torch.arange(6).reshape(2, 3),
        "u8": torch.arange(5, dtype=torch.uint8),
        "scalar": torch.tensor(2.5),
    }
    ours = str(tmp_path / "ours.safetensors")
    pst.save_safetensors(ours, tensors, metadata={"format": "pt"})
    back = pst.load_safetensors(ours)
    jax_read = jst.load_safetensors(ours)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
        want = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        got = jax_read[k].astype(np.float32) if t.dtype == torch.bfloat16 else jax_read[k]
        np.testing.assert_array_equal(got, want, err_msg=k)
    with open(ours, "rb") as f:  # the header: a little-endian u64 length, then JSON
        (hlen,) = struct.unpack("<Q", f.read(8))
        assert json.loads(f.read(hlen))["__metadata__"] == {"format": "pt"}

    theirs = str(tmp_path / "theirs.safetensors")
    jst.save_safetensors(theirs, {
        "f32": tensors["f32"].numpy(), "f16": tensors["f16"].numpy(),
        "bf16": tensors["bf16"].float().numpy().astype(ml_dtypes.bfloat16)})
    read = pst.load_safetensors(theirs)
    for k in ("f32", "f16", "bf16"):
        assert read[k].dtype == tensors[k].dtype and torch.equal(read[k], tensors[k]), k

    try:  # the upstream package, where this machine has it
        from safetensors.torch import load_file
    except ImportError:
        return
    upstream = load_file(ours)
    for k, t in tensors.items():
        assert upstream[k].dtype == t.dtype and torch.equal(upstream[k], t), k


def test_safetensors_refuses_unknown_types(tmp_path):
    with pytest.raises(ValueError, match="unsupported dtype"):
        pst.save_safetensors(str(tmp_path / "x.safetensors"),
                             {"c": torch.zeros(2, dtype=torch.complex64)})


# -- converters -----------------------------------------------------------------

def _unet_sd(cfg):
    sd = {k: torch.from_numpy(synth_value("unet", k, tuple(v.shape)))
          for k, v in _synth_diffusers_unet_sd(cfg.diffusion.unet).items()}
    # keys of a published diffusers dict the UNet does not read
    sd["time_embedding.cond_proj.weight"] = torch.zeros(3, 3)
    sd["mid_block.attentions.0.transformer_blocks.0.attn1.to_q.bias"] = torch.zeros(2)
    return sd


def _vae_sd(pcfg):
    from clap2diffusion_tpu_torch.models.vae import AutoencoderKL

    sd = filled("vae", pconv.template(AutoencoderKL, pcfg.diffusion.vae))
    sd["encoder.mid_block.attentions.0.query.weight"] = torch.zeros(1)  # old-diffusers name
    return sd


def _clip_sd(pcfg, prefix="text_model."):
    from clap2diffusion_tpu_torch.models.clip_text import CLIPTextEncoder

    sd = filled("clip", pconv.template(CLIPTextEncoder, pcfg.diffusion.clip_text), prefix)
    sd[prefix + "embeddings.position_ids"] = torch.arange(7)[None]
    sd["text_projection.weight"] = torch.zeros(4, 48)  # a CLIPModel's, unused here
    return sd


def _clap_sd(pcfg, full=True):
    from clap2diffusion_tpu_torch.models.clap.htsat import ClapAudioTower

    shapes = pconv.template(ClapAudioTower, pcfg.clap.audio)
    sd = {}
    for k, s in shapes.items():
        key = ("audio_model." + k) if full and k.startswith("audio_encoder.") else k
        sd[key] = torch.from_numpy(synth_value("clap", k, tuple(s)))
        if k.endswith("running_var"):
            sd[key] = sd[key].abs() + 0.5
    enc = "audio_model.audio_encoder." if full else "audio_encoder."
    sd[enc + "batch_norm.num_batches_tracked"] = torch.tensor(7)
    # a ClapModel's text tower and logit scales: skipped by both packages
    sd["text_model.encoder.layer.0.attention.self.query.weight"] = torch.zeros(4, 4)
    sd["text_projection.linear1.weight"] = torch.zeros(4, 4)
    sd["logit_scale_a"] = torch.tensor(2.0)
    sd["logit_scale_t"] = torch.tensor(2.0)
    return sd


def _hier_sd(adaptive=True):
    shapes = load_shapes("condition_shapes.json")["hierarchical"]
    sd = {k: torch.from_numpy(v) for k, v in synth_state_dict("hier", shapes).items()
          if adaptive or not k.startswith("adaptive_weights.")}
    # the reference's buffers, which the port takes from the config and the step
    sd["decomposer.level_prior"] = torch.tensor([0.5, 0.3, 0.2])
    sd["decomposer.temperature"] = torch.tensor(2.0)
    return sd


def _adapter_sd():
    shapes = load_shapes("condition_shapes.json")["adapter"]
    return {k: torch.from_numpy(v) for k, v in synth_state_dict("adapter", shapes).items()}


def _v4_sd():
    from clap2diffusion_tpu_torch.models.condition.hierarchical import HierarchicalAudioV4

    return filled("v4", pconv.template(HierarchicalAudioV4, REF_COND))


def test_convert_sd_unet_matches_jax(tiny):
    cfg, pcfg, _ = tiny
    sd = _unet_sd(cfg)
    want = bridge.unet_from_flax(jconv.convert_sd_unet(sd, cfg.diffusion.unet))
    equal_dicts(pconv.convert_sd_unet(sd, pcfg.diffusion.unet), want)


def test_convert_sd_vae_matches_jax(tiny):
    cfg, pcfg, _ = tiny
    sd = _vae_sd(pcfg)
    want = bridge.vae_from_flax(jconv.convert_sd_vae(sd, cfg.diffusion.vae))
    equal_dicts(pconv.convert_sd_vae(sd, pcfg.diffusion.vae), want)


@pytest.mark.parametrize("prefix", ["text_model.", ""])
def test_convert_clip_text_matches_jax(tiny, prefix):
    cfg, pcfg, _ = tiny
    sd = _clip_sd(pcfg, prefix)
    want = bridge.clip_text_from_flax(jconv.convert_clip_text(sd, cfg.diffusion.clip_text))
    equal_dicts(pconv.convert_clip_text(sd, pcfg.diffusion.clip_text), want)


@pytest.mark.parametrize("full", [True, False], ids=["ClapModel", "ClapAudioModel"])
def test_convert_clap_audio_matches_jax(tiny, full):
    cfg, pcfg, _ = tiny
    sd = _clap_sd(pcfg, full)
    want = bridge.clap_audio_from_flax(jclap.convert_clap_audio(sd, cfg.clap.audio))
    equal_dicts(pclap.convert_clap_audio(sd, pcfg.clap.audio), want)
    # a few text-tower keys without its word embeddings: no text tower to
    # convert, as the JAX converter tool decides
    assert not pclap.has_text_tower(sd)


@pytest.mark.parametrize("adaptive", [True, False])
def test_convert_hierarchical_matches_jax(adaptive):
    sd = _hier_sd(adaptive)
    tree = jcond.convert_hierarchical_encoder(sd)
    assert ("adaptive_weights" in tree) == adaptive
    equal_dicts(pcond.convert_hierarchical_encoder(sd, REF_COND),
                bridge.hierarchical_from_flax(tree))


def test_convert_adapter_matches_jax():
    sd = _adapter_sd()
    equal_dicts(pcond.convert_audio_adapter(sd, REF_COND),
                bridge.adapter_from_flax(jcond.convert_audio_adapter(sd)))


def test_convert_legacy_v4_matches_jax():
    sd = _v4_sd()
    sd["decomposer.some_buffer"] = torch.zeros(1)  # ignored by both
    want = {k: torch.from_numpy(v)
            for k, v in jexp.export_legacy_v4(jcond.convert_legacy_v4(sd)).items()}
    equal_dicts(pcond.convert_legacy_v4(sd, REF_COND), want)


def test_unwrap_nested_sections():
    inner = {"a": 1}
    assert pcond.unwrap({"hierarchical_state_dict": inner, "step": 3},
                        "hierarchical_state_dict") is inner
    assert pcond.unwrap({"model_state_dict": inner}, "adapter_state_dict") is inner
    assert pcond.unwrap({"state_dict": inner}, "adapter_state_dict") is inner
    assert pcond.unwrap(inner, "adapter_state_dict") is inner


CONVERTERS = {
    "unet": (lambda t: _unet_sd(t[0]), lambda sd, t: pconv.convert_sd_unet(sd, t[1].diffusion.unet),
             "conv_in.weight"),
    "vae": (lambda t: _vae_sd(t[1]), lambda sd, t: pconv.convert_sd_vae(sd, t[1].diffusion.vae),
            "decoder.conv_out.weight"),
    "clip_text": (lambda t: _clip_sd(t[1]),
                  lambda sd, t: pconv.convert_clip_text(sd, t[1].diffusion.clip_text),
                  "text_model.final_layer_norm.weight"),
    "clap_audio": (lambda t: _clap_sd(t[1]),
                   lambda sd, t: pclap.convert_clap_audio(sd, t[1].clap.audio),
                   "audio_projection.linear2.weight"),
    "hierarchical": (lambda t: _hier_sd(),
                     lambda sd, t: pcond.convert_hierarchical_encoder(sd, REF_COND),
                     "router.routing_matrix"),
    "adapter": (lambda t: _adapter_sd(), lambda sd, t: pcond.convert_audio_adapter(sd, REF_COND),
                "token_generator.pos_embed"),
    "legacy_v4": (lambda t: _v4_sd(), lambda sd, t: pcond.convert_legacy_v4(sd, REF_COND),
                  "decomposer.hierarchy_weights"),
}


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_converter_names_missing_and_misshapen_keys(tiny, name):
    make, conv, key = CONVERTERS[name]
    sd = make(tiny)
    missing = {k: v for k, v in sd.items() if k != key}
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        conv(missing, tiny)
    bad = dict(sd)
    bad[key] = torch.zeros(*sd[key].shape, 2)
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        conv(bad, tiny)


# -- export -----------------------------------------------------------------------

def _equal_export(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k], np.float32),
                                      err_msg=k)


def test_exports_match_jax(tiny):
    _, _, params = tiny
    ported = bridge.from_flax(params)
    _equal_export(pexp.export_hierarchical_encoder(ported["hierarchical"]),
                  jexp.export_hierarchical_encoder(params["hierarchical"]))
    _equal_export(pexp.export_audio_adapter(ported["adapter"]),
                  jexp.export_audio_adapter(params["adapter"]))
    proc = pexp.export_injection_processors(ported["unet"])
    _equal_export(proc, jexp.export_injection_processors(params["unet"]))
    assert {k.split(".")[0] for k in proc} == {"early", "mid", "late"}


def test_legacy_v4_export_matches_jax(tiny):
    from clap2diffusion_tpu.models.condition import HierarchicalAudioV4 as JV4

    cfg = tiny[0]
    tree = jax.tree.map(np.asarray, JV4(cfg=cfg.condition).init(
        jax.random.key(1), jnp.ones((1, cfg.condition.clap_dim)))["params"])
    theirs = jexp.export_legacy_v4(tree)
    ours = pexp.export_legacy_v4(pcond.convert_legacy_v4(
        {k: torch.from_numpy(np.array(v)) for k, v in theirs.items()}, tiny[1].condition))
    _equal_export(ours, theirs)


# -- modules ----------------------------------------------------------------------

def _to_torch_sd(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            bridge._convert(tree, []).items()}


@pytest.mark.parametrize("masked", [False, True])
def test_gated_cross_attention_matches_jax(masked):
    from clap2diffusion_tpu.models.condition import GatedAudioCrossAttention as JGated
    from clap2diffusion_tpu_torch.models.condition.adapter import GatedAudioCrossAttention

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    ctx = rng.normal(size=(2, 5, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 1, 9, 5), bool)
        mask[0, :, :, 3:] = False
    jm = JGated(query_dim=24, context_dim=16, heads=2, dim_head=8, gate_init=0.3)
    params = jm.init(jax.random.key(0), x, ctx)["params"]
    want = np.asarray(jm.apply({"params": params}, x, ctx, mask))
    pm = GatedAudioCrossAttention(24, context_dim=16, heads=2, dim_head=8, gate_init=0.3)
    pm.load_state_dict(_to_torch_sd(params), strict=True)
    got = pm(torch.from_numpy(x), torch.from_numpy(ctx),
             None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    assert float(torch.sigmoid(GatedAudioCrossAttention(4).gate.detach())) < 0.01  # gate init -5


def test_legacy_v4_matches_jax(tiny):
    from clap2diffusion_tpu.models.condition import HierarchicalAudioV4 as JV4
    from clap2diffusion_tpu_torch.models.condition.hierarchical import HierarchicalAudioV4

    cfg, pcfg, _ = tiny
    x = np.random.default_rng(4).normal(size=(3, cfg.condition.clap_dim)).astype(np.float32)
    jm = JV4(cfg=cfg.condition)
    tree = jm.init(jax.random.key(2), x)["params"]
    want77, want_info = jm.apply({"params": tree}, x, return_intermediate=True)
    pm = HierarchicalAudioV4(pcfg.condition).eval()
    pm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                       jexp.export_legacy_v4(tree).items()},
                       strict=True)
    got77, got_info = pm(torch.from_numpy(x), return_intermediate=True)
    np.testing.assert_allclose(got77.detach().numpy(), np.asarray(want77), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_info["tokens10"].detach().numpy(),
                               np.asarray(want_info["tokens10"]), atol=1e-5, rtol=1e-5)


# -- loading and saving -----------------------------------------------------------

def test_load_torch_checkpoint_reference_format(tmp_path):
    hier, adapter = _hier_sd(), _adapter_sd()
    path = str(tmp_path / "audio_projector_stage2.pth")
    torch.save({"step": 2000, "hierarchical_state_dict": hier, "adapter_state_dict": adapter,
                "optimizer_state_dict": {}, "config": {"stage": 2}}, path)
    ckpt = load_torch_checkpoint(path)
    assert ckpt["step"] == 2000 and ckpt["config"] == {"stage": 2}
    assert all(torch.is_tensor(v) for v in ckpt["hierarchical_state_dict"].values())
    got = pcond.convert_hierarchical_encoder(
        pcond.unwrap(ckpt, "hierarchical_state_dict"), REF_COND)
    equal_dicts(got, bridge.hierarchical_from_flax(jcond.convert_hierarchical_encoder(hier)))


def _wav(seed):
    return (np.random.default_rng(seed).normal(size=24_000) * 0.1).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_save_load_pipeline_round_trip(tiny, tmp_path, dtype):
    _, pcfg, _ = tiny
    pipe = P.AudioToImagePipeline(pcfg, seed=4, device="cpu", dtype=dtype)
    extra = {"clip_text_projection": {"weight": torch.arange(6.0).reshape(2, 3)}}
    path = P.save_pipeline(str(tmp_path / "ck"), {**pipe.params, **extra})
    loaded = P.load_pipeline(pcfg, path, dtype=dtype, device="cpu")
    for tower, sd in pipe.params.items():
        got = loaded.params[tower]
        for k, t in sd.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), (tower, k)
    assert loaded.hierarchical.router.routing_matrix.dtype == torch.float32
    assert loaded.unet.conv_in.weight.dtype == dtype
    assert torch.equal(loaded.extra_params["clip_text_projection"]["weight"],
                       extra["clip_text_projection"]["weight"])
    kw = dict(waveform=_wav(1), num_steps=2, seed=3)
    assert np.array_equal(loaded.generate(**kw), pipe.generate(**kw))


def test_load_pipeline_bf16_rounds_the_fp32_towers_as_jax(tiny, tmp_path):
    """An fp32 checkpoint of the same JAX-initialised weights in each package,
    loaded with bf16: every tower equals ``from_flax`` of the JAX load (the
    towers that compute in fp32 hold bf16-rounded values, as the JAX
    program computes with), and the conditioning tokens agree within the
    slice tests' fp32 tolerance."""
    from clap2diffusion_tpu.diffusion.pipeline import load_pipeline as jax_load_pipeline
    from clap2diffusion_tpu.diffusion.pipeline import save_pipeline as jax_save_pipeline
    from tests.test_torch_models import close

    cfg, pcfg, jparams = tiny
    jpipe = jax_load_pipeline(cfg, jax_save_pipeline(str(tmp_path / "jax"), jparams),
                              dtype=jnp.bfloat16)
    pipe = P.load_pipeline(pcfg, P.save_pipeline(str(tmp_path / "port"),
                                                 bridge.from_flax(jparams)),
                           dtype=torch.bfloat16, device="cpu")
    want = bridge.from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), jpipe.params))
    for tower, sd in want.items():
        for k, t in sd.items():
            assert torch.equal(pipe.params[tower][k].float(), t), (tower, k)
    assert pipe.params["clap_audio"][next(iter(want["clap_audio"]))].dtype == torch.float32

    wav = (np.random.default_rng(3).normal(size=(1, cfg.clap.frontend.num_samples)) * 0.1
           ).astype(np.float32)
    jclap_emb = jpipe.encode_audio(jnp.asarray(wav))
    clap_emb = pipe.encode_audio(wav)
    close(clap_emb, np.asarray(jclap_emb))
    for model_type in ("hierarchical", "sonic"):
        ref = jpipe._condition(jpipe.params, jclap_emb, model_type, 60.0, 0.7)
        with torch.no_grad():
            ours = pipe._condition(clap_emb, model_type, 60.0, 0.7)
        if ref[0] is not None:
            close(ours[0], np.asarray(ref[0]))
        for lvl in ("early", "mid", "late"):
            close(ours[1][lvl], np.asarray(ref[1][lvl]))


@pytest.mark.parametrize("tower", ["hierarchical", "adapter"])
def test_param_type_ops_follow_jax_in_bf16(tiny, tower):
    """The ops JAX runs on a bf16 conditioning tower's parameters in bf16
    (the router's softmax and gates, the adapter's query sum), in the port
    with ``param_dtype`` bf16 on fp32 weights of the same values: within
    fp32 summation order of JAX's bf16 tower; ``param_dtype`` fp32 is
    measurably off it."""
    from clap2diffusion_tpu.models.condition.adapter import AudioAdapter as JAdapter
    from clap2diffusion_tpu.models.condition.hierarchical import (
        HierarchicalAudioEncoder as JHier,
    )
    from clap2diffusion_tpu_torch.models.condition.adapter import AudioAdapter
    from clap2diffusion_tpu_torch.models.condition.hierarchical import (
        HierarchicalAudioEncoder,
    )

    cfg, pcfg, jparams = tiny
    p16 = jax.tree.map(lambda v: jnp.asarray(v).astype(jnp.bfloat16), jparams[tower])
    x = np.random.default_rng(5).normal(size=(3, cfg.condition.clap_dim)).astype(np.float32)
    sd = bridge.from_flax({**jparams, tower: jax.tree.map(
        lambda v: np.asarray(v.astype(jnp.float32)), p16)})[tower]
    if tower == "hierarchical":
        ref = JHier(cfg=cfg.condition).apply({"params": p16}, x, 0.7, return_all=True)[1]["routed"]
        module = HierarchicalAudioEncoder(pcfg.condition)
        run = lambda: module(torch.from_numpy(x), 0.7, return_all=True)[1]["routed"]  # noqa: E731
    else:
        ref = {"tokens": JAdapter(cfg=cfg.condition).apply({"params": p16}, x)}
        module = AudioAdapter(pcfg.condition)
        run = lambda: {"tokens": module(torch.from_numpy(x))}  # noqa: E731
    module.load_state_dict(sd)
    module.eval()
    errs = {}
    for pdt in (torch.bfloat16, torch.float32):
        for sub in module.modules():
            if hasattr(sub, "param_dtype"):
                sub.param_dtype = pdt
        with torch.no_grad():
            out = run()
        errs[pdt] = max(float(np.abs(out[k].numpy() - np.asarray(ref[k], np.float32)).max()
                              / np.abs(np.asarray(ref[k], np.float32)).max()) for k in ref)
    assert errs[torch.bfloat16] <= 1e-5 and errs[torch.float32] > 1e-4, errs


def test_load_pipeline_refusals(tiny, tmp_path, monkeypatch):
    _, pcfg, _ = tiny
    params = P.init_params(pcfg, seed=0, device="cpu")
    path = P.save_pipeline(str(tmp_path / "ck"), {k: v for k, v in params.items()
                                                   if k != "adapter"})
    with pytest.raises(ValueError, match=r"missing towers: \['adapter'\]"):
        P.load_pipeline(pcfg, path, device="cpu")
    P.save_pipeline(path, params)
    wide = dataclasses.replace(pcfg, condition=dataclasses.replace(pcfg.condition,
                                                                   token_dim=64))
    with pytest.raises(ValueError, match="does not match the active config's geometry"):
        P.load_pipeline(wide, path, device="cpu")
    with pytest.raises(ValueError, match="not a pipeline checkpoint"):
        P.load_pipeline(pcfg, str(tmp_path), device="cpu")
    # the int8 wire loads (tests/test_torch_wire.py holds it against JAX);
    # no leaf of the tiny config reaches MIN_WIRE_QUANT_SIZE, so it gives
    # the plain load's weights
    plain = P.load_pipeline(pcfg, path, device="cpu").params
    monkeypatch.setenv("C2D_INT8_WIRE", "1")
    wired = P.load_pipeline(pcfg, path, device="cpu").params
    assert sorted(wired) == sorted(plain)
    for tower, sd in plain.items():
        for k, t in sd.items():
            assert torch.equal(wired[tower][k], t), (tower, k)


def test_cached_init_params_hits_and_misses(tiny, tmp_path, monkeypatch):
    _, pcfg, _ = tiny
    monkeypatch.setenv("C2D_PARAM_CACHE", str(tmp_path / "cache"))
    calls = []
    real = P.init_params
    monkeypatch.setattr(P, "init_params", lambda *a, **k: calls.append(a) or real(*a, **k))
    first = P.cached_init_params(pcfg, seed=1, device="cpu")
    again = P.cached_init_params(pcfg, seed=1, device="cpu")
    assert len(calls) == 1  # the second call is a hit
    for tower in first:
        for k, t in first[tower].items():
            assert torch.equal(again[tower][k], t)
    P.cached_init_params(pcfg, seed=2, device="cpu")
    P.cached_init_params(pcfg, seed=1, dtype=torch.bfloat16, device="cpu")
    assert len(calls) == 3  # another seed or dtype misses
    keys = {P.params_cache_path(pcfg, 1, device=d) for d in ("cpu", "cuda")}
    assert len(keys) == 2  # the CPU's and CUDA's draws are kept apart
    monkeypatch.delenv("C2D_PARAM_CACHE")
    assert P.params_cache_path(pcfg) is None
