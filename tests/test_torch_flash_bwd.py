"""The port's differentiable kernels against the JAX package, on the CPU in fp32.

The flash-attention backward kernel is CUDA and runs only on the card
(``chip_smoke.py`` phase 2b holds it against its plain version there).
Here its plain version, which the CPU path runs, is held against the JAX
Pallas backward in interpret mode (as ``tests/test_ops.py`` runs it), and
the autograd wiring of both ops is held against autograd of the plain
versions and against ``jax.vjp`` of the JAX ops.
"""

import jax
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.ops import flash_attention as jfa
from clap2diffusion_tpu.ops import groupnorm as jgn
from clap2diffusion_tpu_torch.ops import flash_attention as pfa
from clap2diffusion_tpu_torch.ops import groupnorm as pgn

torch.set_num_threads(2)


def _t(x, grad=False):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy()).requires_grad_(grad)


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX Pallas kernels in interpret mode on the CPU."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfa.pl, "pallas_call", interp)


def _qkv(d, sq, sk, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((2, 2, sq, d), (2, 2, sk, d), (2, 2, sk, d), (2, 2, sq, d))]


# Sq != Sk and neither a multiple of the CUDA kernel's 64-row tiles. Sq
# stays within one Pallas q-block (256) or a whole number of them: the
# interpret mode reads undefined rows past a ragged last q-block.
@pytest.mark.parametrize("d,sq,sk", [(8, 200, 333), (40, 512, 300), (80, 130, 777)])
def test_plain_bwd_matches_pallas_interpret(interpret, d, sq, sk):
    q, k, v, do = _qkv(d, sq, sk, d)
    scale = d ** -0.5
    ref = [np.asarray(x) for x in jfa._flash_bwd(q, k, v, do, scale)]
    o = pfa.plain_flash_attention(_t(q), _t(k), _t(v), scale)
    ours = pfa.flash_attention_bwd(_t(q), _t(k), _t(v), o, None, _t(do), scale)  # CPU: plain
    assert pfa.flash_attention_bwd.launches == 0
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        # fp32 both sides; only the summation order differs
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("d,sq,sk", [(16, 300, 300), (40, 260, 77)])
def test_function_grads_match_autograd_of_plain(d, sq, sk):
    q, k, v, do = _qkv(d, sq, sk, 7)
    scale = d ** -0.5
    ins = [_t(x, grad=True) for x in (q, k, v)]
    out = pfa.flash_attention(*ins, scale)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    got = torch.autograd.grad(out, ins, _t(do))
    ref_ins = [_t(x, grad=True) for x in (q, k, v)]
    ref_out = pfa.plain_flash_attention(*ref_ins, scale)
    want = torch.autograd.grad(ref_out, ref_ins, _t(do))
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


def test_function_without_grad_is_the_plain_forward():
    q, k, v, _ = _qkv(8, 64, 64, 3)
    with torch.no_grad():
        out = pfa.flash_attention(_t(q), _t(k), _t(v), 0.3)
    assert out.grad_fn is None
    torch.testing.assert_close(out, pfa.plain_flash_attention(_t(q), _t(k), _t(v), 0.3),
                               atol=0, rtol=0)
    assert pfa.flash_attention.launches == 0 and pfa.flash_attention_bwd.launches == 0


def test_plain_bwd_rounds_p_and_ds_to_bf16():
    """In bf16, P and dS are rounded before their products (the kernel's
    rule): the result is closer to an fp64 reference built the same way than
    one bf16 ulp of the output."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(40, 96, 80, 9))
    scale = 40 ** -0.5
    o = pfa.plain_flash_attention(q, k, v, scale)
    dq, dk, dv = pfa.plain_flash_attention_bwd(q, k, v, o, do, scale)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    qd, kd, vd, od, dod = (t.double() for t in (q, k, v, o, do))
    lg = qd @ kd.transpose(-1, -2) * scale
    p = torch.softmax(lg, -1)
    dv_ref = p.to(torch.bfloat16).double().transpose(-1, -2) @ dod
    ds = p * (dod @ vd.transpose(-1, -2) - (dod * od).sum(-1, keepdim=True)) * scale
    ds = ds.to(torch.bfloat16).double()
    for a, b in ((dq, ds @ kd), (dk, ds.transpose(-1, -2) @ qd), (dv, dv_ref)):
        # one bf16 rounding of the output (2^-8 relative) plus fp32 noise
        torch.testing.assert_close(a.double(), b, atol=2e-2 * b.abs().max().item(), rtol=8e-3)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("c,groups,eps", [(64, 32, 1e-5), (320, 32, 1e-6), (96, 8, 1e-5)])
def test_group_norm_function_grads_match_jax_vjp(silu, c, groups, eps):
    rng = np.random.default_rng(c)
    x = (rng.normal(size=(2, 6, 5, c)) * 2 + 0.5).astype(np.float32)
    scale = (rng.normal(size=(c,)) * 0.1 + 1).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    jfn = jgn.group_norm_silu if silu else jgn.group_norm
    y_ref, vjp = jax.vjp(lambda a, s, b: jfn(a, s, b, groups, eps), x, scale, bias)
    ref = [np.asarray(g) for g in vjp(gy)]
    ins = [_t(a, grad=True) for a in (x, scale, bias)]
    fn = pgn.group_norm_silu if silu else pgn.group_norm
    y = fn(*ins, groups, eps)
    assert type(y.grad_fn).__name__ == "GroupNormFunctionBackward"
    got = torch.autograd.grad(y, ins, _t(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=2e-5, rtol=1e-5)
    for name, a, b in zip(("dx", "dscale", "dbias"), got, ref):
        # fp32; the scale/bias gradients sum B*H*W terms in another order
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-4, err_msg=name)


def test_group_norm_function_only_grads_what_is_asked():
    rng = np.random.default_rng(1)
    x = _t(rng.normal(size=(1, 4, 4, 32)), grad=True)
    w, b = _t(np.ones(32)), _t(np.zeros(32))
    y = pgn.group_norm_silu(x, w, b, 8, 1e-5)
    (gx,) = torch.autograd.grad(y.sum(), [x])
    assert gx.shape == x.shape and torch.isfinite(gx).all()
    assert pgn.group_norm_silu.launches == 0
