"""W8A8 int8 serving (``C2D_INT8=1``) of the port against the JAX package's
``ops/quant.py``, on the CPU.

- ``quantize_weight``, ``quantize_dynamic``, ``int8_matmul`` and
  ``int8_conv`` against JAX's on the same numpy inputs at tolerance 0, in
  fp32 and bf16, zero and tiny channels included: the int32 products are
  exact and the dequantisation keeps JAX's order.
- The tiny UNet (``tests/test_pipeline.py::tiny_config``) with
  ``INT8_MIN_WIDTH`` set to 8 in both packages, as ``tests/test_quant.py``
  does, against JAX's int8 UNet; also under ``C2D_INT8_CONV=0`` and
  ``C2D_FUSED_QKV=0``. Tolerance: 2e-3 of max|ref|. These 8x8 inputs
  put no activation of either package on the other side of a quantiser's
  rounding boundary, so the two int8 paths are the same computation up to
  fp32 summation order: measured 2.9e-7 (default), 3.3e-7
  (``C2D_INT8_CONV=0``) and 4.0e-7 (``C2D_FUSED_QKV=0``) of max|ref|, and a
  site quantised in one package and not the other would show at once. A
  value that crosses a boundary moves by one quantum (1/127 of the
  tensor's absmax) and the next sites carry it on: JAX's own int8 UNet
  moves by 1e-2 of max|ref| under a 1e-6 relative input perturbation at
  16x16 latents, where ``tests/test_torch_fullsize.py`` holds the two
  packages with JAX's drift criterion instead.
- int8 against fp on the port: cosine of eps above 0.99, as JAX's test asks.
- The VAE and ``Downsample`` unchanged by the flag; the int8 weight cache
  refreshed by ``load_state_dict``, an in-place change and ``.to()``
  (``run_stage``'s refusal of the flag is held in
  ``tests/test_torch_winograd.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.diffusion.pipeline import init_params
from clap2diffusion_tpu.ops import quant as jq
from clap2diffusion_tpu_torch import convert
from clap2diffusion_tpu_torch.ops import quant as pq
from tests.test_pipeline import tiny_config
from tests.test_torch_models import load, port_cfg, to_torch

torch.set_num_threads(2)

UNET_TOL = 2e-3  # of max|ref|; see the module doc


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(np.array(x, np.float32)).to(dtype)
    j = jnp.asarray(np.array(x, np.float32)).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return j, t


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _weights(rng, shape, out_axis):
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    idx = [slice(None)] * len(shape)
    idx[out_axis] = 0
    w[tuple(idx)] = 0.0           # a zero channel: the 1e-8 floor
    idx[out_axis] = 1
    w[tuple(idx)] *= 1e-9         # a tiny channel
    return w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,out_axis", [((24, 16), 1), ((16, 24), 0), ((3, 3, 8, 12), 3)])
def test_quantize_weight_equals_jax(dtype, shape, out_axis):
    w = _weights(np.random.default_rng(0), shape, out_axis)
    jw, tw = _pair(w, dtype)
    ji, js = jq.quantize_weight(jw, out_axis)
    pi, ps = pq.quantize_weight(tw, out_axis)
    assert pi.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [1.0, 0.0, 1e-12])
def test_quantize_dynamic_equals_jax(dtype, scale):
    x = np.random.default_rng(1).normal(size=(2, 5, 7, 9)).astype(np.float32) * scale
    jx, tx = _pair(x, dtype)
    ji, js = jq.quantize_dynamic(jx)
    pi, ps = pq.quantize_dynamic(tx)
    assert ps.dim() == 0
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("xshape,n", [((5, 24), 16), ((2, 33, 7), 3), ((3, 64, 40), 120)])
def test_int8_matmul_equals_jax(dtype, bias, xshape, n):
    rng = np.random.default_rng(2)
    x = rng.normal(size=xshape).astype(np.float32)
    w = _weights(rng, (xshape[-1], n), 1)
    b = rng.normal(size=(n,)).astype(np.float32) if bias else None
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    jb, tb = _pair(b, dtype) if bias else (None, None)
    ref = jq.int8_matmul(jx, jw, jb)
    ours = pq.int8_matmul(tx, tw.t(), tb)
    assert ours.dtype == dtype and tuple(ours.shape) == ref.shape
    np.testing.assert_array_equal(_np(ours), _np(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xshape,cout", [((2, 8, 8, 16), 24), ((1, 5, 3, 8), 8)])
def test_int8_conv_equals_jax(dtype, xshape, cout):
    rng = np.random.default_rng(3)
    x = rng.normal(size=xshape).astype(np.float32)
    k = _weights(rng, (3, 3, xshape[-1], cout), 3)
    b = rng.normal(size=(cout,)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jk, tk = _pair(k, dtype)
    jb, tb = _pair(b, dtype)
    ref = jq.int8_conv(jx, jk, jb)
    ours = pq.int8_conv(tx, tk.permute(3, 2, 0, 1), tb)
    assert ours.dtype == dtype and tuple(ours.shape) == ref.shape
    np.testing.assert_array_equal(_np(ours), _np(ref))


def test_gates_follow_the_environment(monkeypatch):
    monkeypatch.delenv("C2D_INT8", raising=False)
    assert not pq.enabled() and not pq.eligible(4096, 4096)
    monkeypatch.setenv("C2D_INT8", "1")
    assert pq.eligible(128, 320) and not pq.eligible(4, 320)
    assert pq.conv_eligible(320, 320)
    monkeypatch.setenv("C2D_INT8_CONV", "0")
    assert pq.eligible(320, 320) and not pq.conv_eligible(320, 320)
    assert pq.INT8_MIN_WIDTH == jq.INT8_MIN_WIDTH == 128


# -- the tiny UNet --------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    params = jax.tree.map(np.asarray, init_params(cfg, seed=0))
    return cfg, port_cfg(cfg), params


@pytest.fixture
def int8_env(monkeypatch):
    monkeypatch.setenv("C2D_INT8", "1")
    monkeypatch.setattr(jq, "INT8_MIN_WIDTH", 8)
    monkeypatch.setattr(pq, "INT8_MIN_WIDTH", 8)


def _unet_io(cfg):
    rng = np.random.default_rng(4)
    u = cfg.diffusion.unet
    sample = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 321], np.int32)
    ehs = rng.normal(size=(2, 7, u.cross_attention_dim)).astype(np.float32)
    audio = {lvl: rng.normal(size=(2, cfg.condition.num_tokens,
                                   u.cross_attention_dim)).astype(np.float32) * 3
             for lvl in ("early", "mid", "late")}
    return sample, t, ehs, audio


def _both_unets(tiny):
    from clap2diffusion_tpu.models.unet import UNet2DCondition as JUNet
    from clap2diffusion_tpu_torch.models.unet import UNet2DCondition

    cfg, pcfg, params = tiny
    args = _unet_io(cfg)
    jm = JUNet(cfg=cfg.diffusion.unet)
    pu = load(UNet2DCondition(pcfg.diffusion.unet), convert.unet_from_flax(params["unet"]))

    def jax_eps():
        return np.asarray(jm.apply({"params": params["unet"]}, *args))

    def port_eps():
        sample, t, ehs, audio = args
        with torch.no_grad():
            return pu(to_torch(sample), torch.from_numpy(t), to_torch(ehs),
                      {k: to_torch(v) for k, v in audio.items()}).numpy()

    return jax_eps, port_eps, pu


def _rel(ours, ref):
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("knob", [None, "C2D_INT8_CONV", "C2D_FUSED_QKV"])
def test_int8_unet_matches_jax(tiny, int8_env, monkeypatch, knob):
    if knob is not None:
        monkeypatch.setenv(knob, "0")
    jax_eps, port_eps, _ = _both_unets(tiny)
    pq.int8_gemm.reset()
    ours, ref = port_eps(), jax_eps()
    assert pq.int8_gemm.calls > 0
    err = _rel(ours, ref)
    assert err <= UNET_TOL, err


def test_int8_unet_sites(tiny, int8_env, monkeypatch):
    """The products the tiny UNet runs, by site, against the JAX rule: each
    Transformer2D has 2 Conv1x1, 4 attention products (fused QKV, to_out,
    cross q, to_out) and 2 feed-forward products; every ResnetBlock whose
    channels change has a shortcut; every 3x3 conv but conv_in and conv_out
    is int8."""
    _, pcfg, _ = tiny
    _, port_eps, pu = _both_unets(tiny)
    n_tf = sum(len(b.attentions) for b in (*pu.down_blocks, pu.mid_block, *pu.up_blocks))
    n_res = sum(len(b.resnets) for b in (*pu.down_blocks, pu.mid_block, *pu.up_blocks))
    n_short = sum(r.conv_shortcut is not None for b in (*pu.down_blocks, pu.mid_block,
                                                        *pu.up_blocks) for r in b.resnets)
    n_up = sum(b.sampler_name == "upsamplers" for b in pu.up_blocks)
    want = {None: n_tf * 8 + n_short + 2 * n_res + n_up,
            "C2D_INT8_CONV": n_tf * 8 + n_short,
            "C2D_FUSED_QKV": n_tf * 7 + n_short + 2 * n_res + n_up}
    for knob, n in want.items():
        with monkeypatch.context() as m:
            if knob is not None:
                m.setenv(knob, "0")
            pq.int8_gemm.reset()
            port_eps()
            assert pq.int8_gemm.calls == n, (knob, pq.int8_gemm.calls, n)


def test_int8_tracks_fp_on_the_port(tiny, int8_env, monkeypatch):
    _, port_eps, _ = _both_unets(tiny)
    int8 = port_eps()
    monkeypatch.setenv("C2D_INT8", "0")
    fp = port_eps()
    assert int8.shape == fp.shape and not np.array_equal(int8, fp)
    assert _cos(int8, fp) > 0.99


def test_vae_and_downsample_unchanged_by_the_flag(tiny, int8_env, monkeypatch):
    from clap2diffusion_tpu_torch.models.unet import Downsample
    from clap2diffusion_tpu_torch.models.vae import AutoencoderKL

    _, pcfg, params = tiny
    vae = load(AutoencoderKL(pcfg.diffusion.vae), convert.vae_from_flax(params["vae"]))
    down = Downsample(32)
    z = to_torch(np.random.default_rng(5).normal(size=(1, 8, 8, 4)))
    x = to_torch(np.random.default_rng(6).normal(size=(2, 8, 8, 32)))
    with torch.no_grad():
        on = vae.decode(z), down(x)
        monkeypatch.setenv("C2D_INT8", "0")
        off = vae.decode(z), down(x)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_weight_cache_refreshes(int8_env):
    from clap2diffusion_tpu_torch.models.unet import QConv1x1

    conv = QConv1x1(16, 24)
    x = torch.randn(2, 4, 4, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.weight.normal_(generator=torch.Generator().manual_seed(1))
        first = conv(x)
        entry = conv.quant._entries["w"][1]
        assert torch.equal(conv(x), first) and conv.quant._entries["w"][1] is entry  # a hit
        conv.load_state_dict({"weight": conv.weight * 2, "bias": conv.bias})
        assert not torch.equal(conv(x), first)  # load_state_dict: quantised again
        conv.weight.mul_(0.5)
        assert torch.equal(conv(x), first)  # an in-place change
    conv.to(torch.float64)
    conv.to(torch.float32)
    assert conv.quant._entries["w"][1] is not entry
    with torch.no_grad():
        assert torch.equal(conv(x), first)  # .to(): new storage
    want = pq.int8_matmul(x, conv.weight.flatten(1), conv.bias)
    assert torch.equal(conv(x), want)
