"""The port's Winograd convolutions and the UNet's opt-in routes against the
JAX package, on the CPU in fp32.

``ops/winograd.py`` (the plain-PyTorch route of ``C2D_WINOGRAD=1``) is held
against the JAX XLA Winograd, value and gradient; the plain version of the
Winograd kernel (``ops/winograd_pallas.py``; the kernel is CUDA and runs
only on the card, where ``chip_smoke.py`` phase 2d holds it against this
version) against the JAX Pallas kernel in interpret mode; the tiny UNet
under ``C2D_WINOGRAD=1`` against the JAX UNet under the same flag. The
UNet and ``run_stage`` refuse ``C2D_INT8=1``, whose W8A8 path is not ported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.ops import winograd as jw
from clap2diffusion_tpu.ops import winograd_pallas as jwp
from clap2diffusion_tpu_torch import convert
from clap2diffusion_tpu_torch.ops import winograd as pw
from clap2diffusion_tpu_torch.ops import winograd_pallas as pwp
from tests.test_torch_models import _unet_inputs, close, load, tiny, to_torch  # noqa: F401
from tests.test_torch_pipeline import _same_tree

torch.set_num_threads(2)

# tests/test_ops.py's Winograd shapes: (x shape, Cout)
SHAPES = [((2, 8, 8, 16), 24), ((1, 10, 6, 8), 8)]


def _conv_inputs(shape, co, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, shape[-1], co)) * 0.2).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    return x, w, b


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX Pallas kernel in interpret mode on the CPU."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jwp.pl, "pallas_call", interp)


@pytest.mark.parametrize("shape,co", SHAPES)
def test_winograd_route_and_its_weight_gradient_match_jax(shape, co):
    x, w, b = _conv_inputs(shape, co, 0)
    gy = np.random.default_rng(1).normal(size=shape[:3] + (co,)).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda k: jw.conv3x3_winograd(x, k, b), w)
    (gw_ref,) = vjp(gy)
    wt = to_torch(w).requires_grad_(True)
    y = pw.conv3x3_winograd(to_torch(x), wt, to_torch(b))
    (gw,) = torch.autograd.grad(y, [wt], to_torch(gy))
    # fp32; the 16 products and the transforms sum in another order
    close(y, y_ref, atol=1e-4, rtol=1e-4)
    close(gw, gw_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape,co", SHAPES + [((2, 4, 6, 32), 16)])
def test_winograd_kernel_plain_matches_pallas_interpret_fp32(interpret, shape, co):
    x, w, b = _conv_inputs(shape, co, 2)
    ref = jwp.conv3x3_winograd_pallas(x, w, b)
    ours = pwp.conv3x3_winograd_pallas(to_torch(x), to_torch(w), to_torch(b))
    assert pwp.conv3x3_winograd_pallas.launches == 0  # CPU tensor: the plain version
    close(ours, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape,co", SHAPES + [((2, 4, 6, 32), 16)])
def test_winograd_kernel_plain_matches_pallas_interpret_bf16(interpret, shape, co):
    """bf16 inputs: V and U are rounded to bf16 and the products summed in
    fp32 in both; the output cast and the bias added after it in bf16."""
    x, w, b = (jnp.asarray(a).astype(jnp.bfloat16) for a in _conv_inputs(shape, co, 3))
    ref = np.asarray(jwp.conv3x3_winograd_pallas(x, w, b).astype(jnp.float32))
    ours = pwp.conv3x3_winograd_pallas(
        *(to_torch(np.asarray(a.astype(jnp.float32))).bfloat16() for a in (x, w, b)))
    assert ours.dtype == torch.bfloat16
    # fp32 sums in another order may round the other way: one bf16 ulp (2^-8)
    close(ours.float(), ref, atol=1e-4, rtol=8e-3)


def test_plain_versions_differ_only_in_where_the_bias_is_added():
    """The kernel's plain version adds the bias after the cast, in x's
    type; the route adds it in fp32 before. Without a bias they agree."""
    x, w, _ = _conv_inputs((2, 8, 8, 16), 24, 4)
    xb, wb = to_torch(x).bfloat16(), to_torch(w).bfloat16()
    torch.testing.assert_close(pwp.plain_conv3x3_winograd_pallas(xb, wb),
                               pw.conv3x3_winograd(xb, wb), atol=1e-5, rtol=8e-3)
    bias = torch.full((24,), 0.3).bfloat16()
    after = pwp.plain_conv3x3_winograd_pallas(xb, wb) + bias
    torch.testing.assert_close(pwp.plain_conv3x3_winograd_pallas(xb, wb, bias), after,
                               atol=0, rtol=0)


@pytest.mark.parametrize("x_shape,k_shape,strides,padding", [
    ((1, 64, 64, 320), (3, 3, 320, 320), (1, 1), "SAME"),
    ((1, 64, 64, 320), (3, 3, 320, 320), (2, 2), "SAME"),
    ((1, 63, 64, 320), (3, 3, 320, 320), (1, 1), "SAME"),
    ((1, 64, 7, 320), (3, 3, 320, 320), (1, 1), "SAME"),
    ((2, 2, 2, 4), (3, 3, 4, 8), (1, 1), ((1, 1), (1, 1))),
    ((2, 8, 8, 4), (1, 1, 4, 8), (1, 1), "SAME"),
    ((2, 8, 8, 4), (3, 3, 4, 8), (1, 1), "VALID"),
])
def test_eligible_matches_jax(x_shape, k_shape, strides, padding):
    assert pw.eligible(x_shape, k_shape, strides, padding) == \
        jw.eligible(x_shape, k_shape, strides, padding)


@pytest.mark.parametrize("x_shape,cin,cout,ok", [
    ((2, 64, 64, 320), 320, 320, True),    # a ResnetBlock conv at level 0
    ((2, 8, 8, 2560), 2560, 1280, True),   # an up-block conv after the skip concat
    ((2, 64, 64, 4), 4, 320, False),       # conv_in: Cin 4 is under one mma depth
    ((2, 64, 64, 320), 320, 4, False),     # conv_out: Cout 4 is under one mma width
    ((2, 63, 64, 320), 320, 320, False),   # odd H
    ((1, 2, 2, 16), 16, 8, True),
])
def test_kernel_eligible_pins_the_narrow_convs(x_shape, cin, cout, ok):
    assert pwp.eligible(x_shape, cin, cout) == ok


def test_tiny_unet_under_winograd_flag_matches_jax(tiny, monkeypatch):
    """Both packages with C2D_WINOGRAD=1: JAX takes its XLA Winograd for every
    eligible Conv3x3 on the CPU, the port its plain route."""
    from clap2diffusion_tpu.models.unet import UNet2DCondition as JUNet
    from clap2diffusion_tpu_torch.models.unet import UNet2DCondition

    cfg, pcfg, params = tiny
    sample, t, ehs, audio = _unet_inputs(cfg, np.random.default_rng(6))
    calls = []
    route = pw.conv3x3_winograd
    monkeypatch.setattr(pw, "conv3x3_winograd", lambda *a: calls.append(a[0].shape) or route(*a))
    monkeypatch.setenv("C2D_WINOGRAD", "1")
    ref = JUNet(cfg=cfg.diffusion.unet).apply({"params": params["unet"]}, sample, t, ehs, audio)
    pu = load(UNet2DCondition(pcfg.diffusion.unet), convert.unet_from_flax(params["unet"]))
    with torch.no_grad():
        ours = pu(to_torch(sample), torch.from_numpy(t), to_torch(ehs),
                  {k: to_torch(v) for k, v in audio.items()})
        # every eligible Conv3x3 took the route; the 1x1 level did not
        assert calls and all(s[1] % 2 == 0 for s in calls)
        monkeypatch.delenv("C2D_WINOGRAD")
        direct = pu(to_torch(sample), torch.from_numpy(t), to_torch(ehs),
                    {k: to_torch(v) for k, v in audio.items()})
    close(ours, ref, atol=1e-4)
    assert not torch.equal(ours, direct)  # the flag changed the arithmetic
    close(ours, direct.numpy(), atol=1e-4)


def test_unet_3x3_convs_sit_where_jax_has_conv3x3_and_convert_reads_them(tiny):
    """``Conv3x3`` at conv_in, conv_out, each ResnetBlock's conv1/conv2 and the
    Upsample conv (JAX ``Conv3x3`` sites), not at the stride-2 Downsample;
    ``convert_sd_unet`` reads the port's state_dict back to the JAX tree leaf
    for leaf."""
    from clap2diffusion_tpu.models.convert import convert_sd_unet
    from clap2diffusion_tpu_torch.models.unet import UNet2DCondition

    cfg, pcfg, params = tiny
    pu = load(UNet2DCondition(pcfg.diffusion.unet), convert.unet_from_flax(params["unet"]))
    sites = {n for n, m in pu.named_modules() if isinstance(m, pw.Conv3x3)}
    want = {"conv_in", "conv_out"}
    for n, m in pu.named_modules():
        if n.endswith((".conv1", ".conv2")) or (".upsamplers." in n and n.endswith(".conv")):
            want.add(n)
    assert sites == want
    assert not any(isinstance(m, pw.Conv3x3) for n, m in pu.named_modules()
                   if ".downsamplers." in n)
    sd = {k: v.numpy() for k, v in pu.state_dict().items()}
    ref = {k: v for k, v in params["unet"].items() if not k.startswith("audio_inject_")}
    _same_tree(convert_sd_unet(sd, cfg.diffusion.unet), ref)


def test_unet_refuses_int8(tiny, monkeypatch):
    from clap2diffusion_tpu_torch.models.unet import UNet2DCondition

    cfg, pcfg, params = tiny
    pu = load(UNet2DCondition(pcfg.diffusion.unet), convert.unet_from_flax(params["unet"]))
    sample, t, ehs, _ = _unet_inputs(cfg, np.random.default_rng(8))
    monkeypatch.setenv("C2D_INT8", "1")
    with pytest.raises(NotImplementedError, match="ops/quant.py.*ROADMAP"):
        pu(to_torch(sample), torch.from_numpy(t), to_torch(ehs), None)


def test_run_stage_refuses_int8(tiny, monkeypatch):
    """As the JAX ``run_stage`` (``train/trainer.py:188-195``): before any
    data or device is touched."""
    from clap2diffusion_tpu_torch.train.trainer import run_stage

    _, pcfg, _ = tiny
    monkeypatch.setenv("C2D_INT8", "1")
    with pytest.raises(RuntimeError, match="serve-only"):
        run_stage(pcfg, 2, {}, data_root="unused", device="cpu")
