"""The port's ops against the JAX package's, on the CPU in fp32.

The flash-attention and GroupNorm kernels of the port are CUDA/Triton and
run only on the card (``chip_smoke.py`` holds each against its plain
version there). Here the plain versions, which the CPU path runs, are held
against the JAX Pallas kernels in interpret mode (as ``tests/test_ops.py``
runs them) and against the JAX package's plain paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.ops import flash_attention as jfa
from clap2diffusion_tpu.ops import groupnorm as jgn
from clap2diffusion_tpu.ops.attention import dot_product_attention as j_dpa
from clap2diffusion_tpu.ops.attention import mha as j_mha
from clap2diffusion_tpu.ops.token_norm import rescale_to_norm as j_rescale
from clap2diffusion_tpu_torch.ops import attention as pattn
from clap2diffusion_tpu_torch.ops import flash_attention as pfa
from clap2diffusion_tpu_torch.ops import groupnorm as pgn
from clap2diffusion_tpu_torch.ops.token_norm import rescale_to_norm

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX Pallas kernels in interpret mode on the CPU."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfa.pl, "pallas_call", interp)
    monkeypatch.setattr(jgn.pl, "pallas_call", interp)


@pytest.mark.parametrize("d,sq,sk", [(40, 256, 384), (80, 384, 256), (160, 256, 384),
                                     (512, 256, 256)])
def test_flash_plain_matches_pallas_interpret(interpret, d, sq, sk):
    rng = np.random.default_rng(d)
    q = rng.normal(size=(2, 2, sq, d)).astype(np.float32)
    k = rng.normal(size=(2, 2, sk, d)).astype(np.float32)
    v = rng.normal(size=(2, 2, sk, d)).astype(np.float32)
    scale = d ** -0.5
    ref = np.asarray(jfa._flash_fwd(q, k, v, scale))
    ours = pfa.flash_attention(_t(q), _t(k), _t(v), scale)  # CPU tensor: plain version
    assert pfa.flash_attention.launches == 0
    # fp32 both sides; the Pallas kernel's one-pass softmax vs torch matmuls
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_flash_plain_bf16_rounds_probabilities_like_the_kernel():
    """In bf16 the plain version rounds P to bf16 before PV (the kernel's
    rule) but keeps fp32 logits; check against an fp64 reference built the
    same way."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 300, 40)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    out = pfa.plain_flash_attention(q, k, v, 40 ** -0.5)
    logits = (q.double() @ k.double().transpose(-1, -2)) * 40 ** -0.5
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    ref = (p.to(torch.bfloat16).double() @ v.double()) / p.sum(-1, keepdim=True)
    assert out.dtype == torch.bfloat16
    # one bf16 rounding of the output (2^-8 relative) plus fp32 noise
    torch.testing.assert_close(out.double(), ref, atol=1e-2, rtol=8e-3)


@pytest.mark.parametrize("use_mask", [False, True])
def test_dot_product_attention_matches_jax(use_mask):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 3, 5, 8)).astype(np.float32)
    k = rng.normal(size=(2, 3, 7, 8)).astype(np.float32)
    v = rng.normal(size=(2, 3, 7, 8)).astype(np.float32)
    mask = np.tril(np.ones((5, 7), bool), k=1)[None, None] if use_mask else None
    ref = j_dpa(q, k, v, mask=mask)
    ours = pattn.dot_product_attention(_t(q), _t(k), _t(v),
                                       mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_mha_matches_jax_and_stays_off_flash_on_cpu():
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 300, 32)).astype(np.float32) for _ in range(3))
    causal = np.tril(np.ones((300, 300), bool))[None, None]
    for mask in (None, causal):
        ref = j_mha(q, k, v, 4, mask=mask, use_flash=True)
        ours = pattn.mha(_t(q), _t(k), _t(v), 4, use_flash=True,
                         mask=None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-6)
    assert pfa.flash_attention.launches == 0
    assert not pattn._flash_eligible(_t(q)[:, None], _t(k)[:, None], None)  # CPU tensor


def _gn_inputs(c, shift, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 8, 8, c)) * 2 + shift).astype(np.float32)
    scale = (rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("c,groups", [(128, 32), (320, 32)])
def test_group_norm_silu_matches_pallas_interpret(interpret, monkeypatch, eps, c, groups):
    monkeypatch.setattr(jgn, "_eligible", lambda x, groups: True)
    x, scale, bias = _gn_inputs(c, 0.5, c)
    if c % 128:  # the Pallas kernel takes 128-lane channel counts only
        ref = jgn._xla_group_norm(x, scale, bias, groups, eps, silu=True)
    else:
        ref = jgn._pallas_group_norm_silu(x, scale, bias, groups, eps)
    ours = pgn.group_norm_silu(_t(x), _t(scale), _t(bias), groups, eps)
    assert pgn.group_norm_silu.launches == 0
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_matches_xla_path(silu, eps):
    x, scale, bias = _gn_inputs(96, -0.3, 3)
    ref = jgn._xla_group_norm(x, scale, bias, 32, eps, silu)
    fn = pgn.group_norm_silu if silu else pgn.group_norm
    np.testing.assert_allclose(fn(_t(x), _t(scale), _t(bias), 32, eps).numpy(),
                               np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_group_norm_large_mean_clamps_variance():
    """|mean| >> std: the one-pass variance cancels; both sides clamp it at
    0 and agree. Tolerance scales with |x| (fp32 cancellation at 1e4)."""
    rng = np.random.default_rng(4)
    x = (1e4 + rng.normal(size=(1, 4, 4, 64)) * 1e-3).astype(np.float32)
    x[..., :32] = 1e4  # a group with zero variance
    scale, bias = np.ones(64, np.float32), np.zeros(64, np.float32)
    for eps in (1e-5, 1e-6):
        ref = np.asarray(jgn._xla_group_norm(x, scale, bias, 32, eps, silu=True))
        ours = pgn.group_norm_silu(_t(x), _t(scale), _t(bias), 32, eps).numpy()
        assert np.isfinite(ours).all()
        np.testing.assert_allclose(ours, ref, atol=1e-3, rtol=1e-4)


def test_rescale_to_norm_matches_jax():
    rng = np.random.default_rng(5)
    tok = rng.normal(size=(3, 10, 48)).astype(np.float32) * np.arange(1, 4)[:, None, None]
    np.testing.assert_allclose(rescale_to_norm(_t(tok), 60.0).numpy(),
                               np.asarray(j_rescale(jnp.asarray(tok), 60.0)), rtol=1e-6)
    zero = np.zeros((1, 2, 4), np.float32)
    np.testing.assert_array_equal(rescale_to_norm(_t(zero)).numpy(), zero)
    assert jax.numpy.allclose(j_rescale(zero), 0)
