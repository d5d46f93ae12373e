"""The port's int8 weight wire (``utils/wire.py``, ``C2D_INT8_WIRE=1``)
against the JAX package's ``utils/wire.py``, on the CPU.

- The dequantised towers equal ``convert.from_flax`` of JAX's
  ``dequantize_wire(*quantize_wire(tree)[:2])`` at tolerance 0, in fp32 and
  bf16, for every tower of a pipeline with its evaluation and best-of
  towers (``tests/test_torch_eval.py``'s tiny ones); the same leaves are
  quantised (the hierarchical projector's stacked q/k/v included) and the
  stats are JAX's.
- Zero and tiny channels give finite scales and exact zeros.
- ``load_pipeline`` under the flag gives ``from_flax`` of JAX's
  ``load_pipeline`` under the flag, with and without a bf16 cast.
- The tiny pipeline's image drift stays within JAX's own bound
  (``tests/test_wire.py``: mean |drift| under 8 levels).

The tiny config's leaves are all smaller than ``MIN_WIRE_QUANT_SIZE``, so
the tests lower it to 256 elements in both packages (JAX's
``quantize_wire`` binds it as a default argument).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.diffusion.pipeline import load_pipeline as jax_load_pipeline
from clap2diffusion_tpu.diffusion.pipeline import save_pipeline as jax_save_pipeline
from clap2diffusion_tpu.utils import wire as jw
from clap2diffusion_tpu_torch import convert as bridge
from clap2diffusion_tpu_torch.diffusion import pipeline as P
from clap2diffusion_tpu_torch.utils import wire as pw
from tests.test_torch_eval import tiny  # noqa: F401  (the module fixture)

torch.set_num_threads(2)

MIN_SIZE = 256


def _cast(tree, dtype):
    return jax.tree.map(lambda x: np.asarray(x).astype(dtype)
                        if np.issubdtype(np.asarray(x).dtype, np.floating) else np.asarray(x),
                        tree)


def _port(jparams, dtype):
    """The port's state dicts of the JAX tree's values, in ``dtype``."""
    return {t: {k: v.to(dtype) for k, v in sd.items()}
            for t, sd in bridge.from_flax(jparams).items()}


def _equal_towers(got, want):
    assert sorted(got) == sorted(want)
    for tower, sd in want.items():
        assert sorted(got[tower]) == sorted(sd), tower
        for k, t in sd.items():
            assert torch.equal(got[tower][k].float(), t), (tower, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wire_equals_jax(tiny, dtype):  # noqa: F811
    _, pcfg, jparams = tiny
    jtree = _cast(jparams, jnp.dtype(dtype))
    jwire, jdtypes, jstats = jw.quantize_wire(jtree, min_size=MIN_SIZE)
    jout = jax.tree.map(np.asarray, jw.dequantize_wire(jwire, jdtypes))

    params = _port(jtree, getattr(torch, dtype))
    payload, stats = pw.quantize_wire(params, pw.tower_layouts(pcfg, params), MIN_SIZE)
    out = pw.dequantize_wire(payload, {t: torch.device("cpu") for t in payload})
    _equal_towers(out, bridge.from_flax(jout))
    for tower, sd in out.items():
        for k, t in sd.items():
            assert t.dtype == params[tower][k].dtype, (tower, k)
    assert stats == jstats

    # the same leaves quantised: a tree of ones where JAX quantised, zeros
    # elsewhere, through from_flax
    marks = jax.tree.map(
        lambda w, x: np.full(np.shape(x), 1.0 if jw._is_q8(w) else 0.0, np.float32),
        jwire, jtree, is_leaf=jw._is_q8)
    for tower, sd in bridge.from_flax(marks).items():
        for k, m in sd.items():
            quantised = isinstance(payload[tower][k], pw.WireLeaf)
            assert bool(m.all()) == quantised and bool(m.any()) == quantised, (tower, k)
    kinds = {(t, isinstance(v, pw.WireLeaf)) for t, sd in payload.items() for v in sd.values()}
    assert ("hierarchical", True) in kinds and ("clip_vision", True) in kinds
    assert isinstance(payload["hierarchical"]["projector.blocks.0.cross_attn.in_proj_weight"],
                      pw.WireLeaf)


def test_zero_and_tiny_channels_are_safe():
    x = torch.randn(4, 300, generator=torch.Generator().manual_seed(0))
    x[0] = 0.0
    x[1] *= 1e-30
    leaf = pw.quantize_leaf(x, axis=0, min_size=1)
    assert torch.isfinite(leaf.s).all() and (leaf.s > 0).all()
    back = leaf.expand("cpu")
    assert torch.equal(back[0], torch.zeros(300)) and torch.isfinite(back).all()
    err = (back - x).abs()
    assert (err <= leaf.s[:, None] / 2 + 1e-7 * x.abs()).all()
    ref_wire, ref_dt, _ = jw.quantize_wire({"x": x.numpy().T.copy()}, min_size=1)
    np.testing.assert_array_equal(back.numpy().T,
                                  np.asarray(jw.dequantize_wire(ref_wire, ref_dt)["x"]))


def test_unknown_tower_or_leaf_raises(tiny):  # noqa: F811
    _, pcfg, _ = tiny
    with pytest.raises(ValueError, match="no layout for tower 'lora'"):
        pw.tower_layouts(pcfg, ["lora"])
    with pytest.raises(ValueError, match=r"no layout for unet\.nope"):
        pw.quantize_wire({"unet": {"nope": torch.zeros(2, 2)}}, pw.tower_layouts(pcfg, ["unet"]))


@pytest.fixture(scope="module")
def checkpoints(tiny, tmp_path_factory):  # noqa: F811
    """One fp32 pipeline checkpoint in each package from the same weights."""
    _, _, jparams = tiny
    d = tmp_path_factory.mktemp("wire")
    jpath = jax_save_pipeline(str(d / "jax"), jparams)
    ppath = P.save_pipeline(str(d / "port"), bridge.from_flax(jparams))
    return jpath, ppath


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_load_pipeline_wire_equals_jax(tiny, checkpoints, monkeypatch, dtype):  # noqa: F811
    cfg, pcfg, _ = tiny
    jpath, ppath = checkpoints
    monkeypatch.setattr(jw.quantize_wire, "__defaults__", (MIN_SIZE,))
    monkeypatch.setattr(pw, "MIN_WIRE_QUANT_SIZE", MIN_SIZE)
    monkeypatch.setenv("C2D_INT8_WIRE", "1")
    jpipe = jax_load_pipeline(cfg, jpath, dtype=None if dtype is None else jnp.bfloat16)
    pipe = P.load_pipeline(pcfg, ppath, dtype=None if dtype is None else torch.bfloat16,
                           device="cpu")
    want = bridge.from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), jpipe.params))
    _equal_towers(pipe.params, want)
    assert pipe.wire_stats["quantized_leaves"] > 0
    if dtype is not None:
        assert pipe.unet.conv_in.weight.dtype == torch.bfloat16
        assert pipe.hierarchical.router.routing_matrix.dtype == torch.float32


def test_tiny_pipeline_image_drift_bounded(tiny, checkpoints, monkeypatch):  # noqa: F811
    _, pcfg, _ = tiny
    _, ppath = checkpoints
    wav = (np.random.default_rng(0).normal(size=pcfg.clap.frontend.num_samples) * 0.1
           ).astype(np.float32)
    kw = dict(waveform=wav, text_ids=np.ones((1, 7), np.int32), num_steps=3, seed=0)
    ref = P.load_pipeline(pcfg, ppath, device="cpu").generate(**kw)
    monkeypatch.setattr(pw, "MIN_WIRE_QUANT_SIZE", MIN_SIZE)
    monkeypatch.setenv("C2D_INT8_WIRE", "1")
    q = P.load_pipeline(pcfg, ppath, device="cpu").generate(**kw)
    assert q.shape == ref.shape and q.dtype == ref.dtype
    drift = np.abs(q.astype(np.int32) - ref.astype(np.int32))
    assert 0 < float(drift.mean()) < 8.0, float(drift.mean())
