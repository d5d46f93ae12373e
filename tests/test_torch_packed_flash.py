"""The port's head-packed flash attention against the JAX package's, on the CPU.

The packed kernel is CUDA and runs only on the card (``chip_smoke.py``
phase 2c holds it against its plain version there). Here its plain version,
which the CPU path runs, is held against the JAX Pallas packed kernel in
interpret mode (as ``tests/test_ops.py`` runs it), the differentiable
``packed_flash_nhd`` against ``jax.grad`` of the JAX one (whose backward is
the Pallas per-head backward, in interpret mode), and the port's two route
predicates against the routes the JAX functions take, case by case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.ops import attention as jattn
from clap2diffusion_tpu.ops import flash_attention as jfa
from clap2diffusion_tpu_torch.ops import attention as pattn
from clap2diffusion_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(2)

# (h, d): SD's level-0 heads (pack 3), a ghost head (5 heads, pack 3), pack 4
# and pack 2
HEADS = [(8, 40), (5, 40), (4, 32), (2, 64)]


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


@pytest.mark.parametrize("h,d", HEADS)
def test_plain_packed_matches_pallas_interpret(interpret, h, d):
    rng = np.random.default_rng(h * 100 + d)
    q, k, v = (rng.normal(size=(1, h, 256, d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    ref = np.asarray(jfa._packed_flash_fwd(q, k, v, scale, min(128 // d, h)))
    ours = pfa.packed_flash_attention(_t(q), _t(k), _t(v), scale, min(128 // d, h))
    assert pfa.packed_flash_attention.launches == 0  # CPU tensor: the plain version
    # fp32 both sides; the block-diagonal product vs per-head matmuls
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("h,d", HEADS)
def test_packed_nhd_matches_jax(interpret, h, d):
    rng = np.random.default_rng(h + d)
    q, k, v = (rng.normal(size=(2, 256, h * d)).astype(np.float32) for _ in range(3))
    scale, pack = d ** -0.5, min(128 // d, h)
    ref = np.asarray(jfa.packed_flash_nhd(q, k, v, h, pack, scale))
    ours = pfa.packed_flash_nhd(_t(q), _t(k), _t(v), h, pack, scale)
    assert ours.shape == (2, 256, h * d)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("h,d", [(8, 40), (5, 40)])
def test_packed_nhd_grads_match_jax_grad(interpret, h, d):
    rng = np.random.default_rng(7 * h + d)
    q, k, v, g = (rng.normal(size=(1, 256, h * d)).astype(np.float32) for _ in range(4))
    scale, pack = d ** -0.5, min(128 // d, h)
    ref = jax.grad(lambda a, b, c: jnp.sum(jfa.packed_flash_nhd(a, b, c, h, pack, scale) * g),
                   argnums=(0, 1, 2))(q, k, v)
    ins = [_t(x, grad=True) for x in (q, k, v)]
    out = pfa.packed_flash_nhd(*ins, h, pack, scale)
    got = torch.autograd.grad(out, ins, _t(g))
    assert pfa.flash_attention_bwd.launches == 0 and pfa.packed_flash_attention.launches == 0
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        # fp32; the Pallas backward sums over its q-block and keys in another order
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_packed_function_is_in_the_graph_and_equals_plain_autograd():
    """The Function's backward (the per-head plain backward on [B, H, S, D]
    views) gives autograd's gradients of the plain packed version."""
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.normal(size=(2, 64, 3 * 16)).astype(np.float32) for _ in range(4))
    ins = [_t(x, grad=True) for x in (q, k, v)]
    out = pfa.packed_flash_nhd(*ins, 3, 3, 0.3)
    names, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None:
            names.add(type(fn).__name__)
            todo.extend(f for f, _ in fn.next_functions)
    assert "PackedFlashAttentionFunctionBackward" in names
    got = torch.autograd.grad(out, ins, _t(g))
    ref_ins = [_t(x, grad=True) for x in (q, k, v)]

    def heads(x):
        return x.unflatten(2, (3, 16)).transpose(1, 2)

    ref_out = pfa.plain_packed_flash_attention(*(heads(x) for x in ref_ins), 0.3)
    ref_out = ref_out.transpose(1, 2).reshape(2, 64, 48)
    want = torch.autograd.grad(ref_out, ref_ins, _t(g))
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


def test_plain_packed_bf16_normalises_before_rounding():
    """In bf16 the plain packed version rounds the NORMALISED probabilities
    to bf16 before PV (the TPU kernel's order), against an fp64 reference
    built the same way."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 3, 300, 40)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    out = pfa.plain_packed_flash_attention(q, k, v, 40 ** -0.5)
    logits = (q.double() @ k.double().transpose(-1, -2)) * 40 ** -0.5
    p = torch.softmax(logits, -1)
    ref = p.to(torch.bfloat16).double() @ v.double()
    assert out.dtype == torch.bfloat16
    # one bf16 rounding of the output (2^-8 relative) plus fp32 noise
    torch.testing.assert_close(out.double(), ref, atol=1e-2, rtol=8e-3)


def _jax_mha_route(monkeypatch, b, s, sk, heads, d, masked, use_flash, backend):
    """Which route the JAX ``mha`` takes for these shapes on ``backend``:
    'packed', 'flash' or 'plain' (traced abstractly, with the kernels
    replaced by spies)."""
    taken = []
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(jfa, "packed_flash_nhd",
                        lambda q, k, v, h, pack, scale: taken.append("packed") or q)
    monkeypatch.setattr(jfa, "flash_attention_wrapper",
                        lambda q, k, v, scale=None: taken.append("flash") or q)
    mask = jnp.ones((1, 1, s, sk), bool) if masked else None
    jax.eval_shape(lambda q, k, v: jattn.mha(q, k, v, heads, mask=mask, use_flash=use_flash),
                   jax.ShapeDtypeStruct((b, s, heads * d), jnp.float32),
                   jax.ShapeDtypeStruct((b, sk, heads * d), jnp.float32),
                   jax.ShapeDtypeStruct((b, sk, heads * d), jnp.float32))
    return taken[0] if taken else "plain"


# (heads, d, Sq, Sk, masked, use_flash): each condition of the JAX test on its own
MHA_CASES = [
    (8, 40, 4096, 4096, False, True),   # SD level 0: packed
    (8, 40, 1024, 1024, False, True),   # the shortest packed sequence
    (8, 80, 1024, 1024, False, True),   # d = 80: 128 // d == 1
    (8, 64, 1024, 1024, False, True),   # d = 64: pack 2
    (1, 40, 1024, 1024, False, True),   # one head
    (8, 40, 896, 896, False, True),     # Sq < 1024
    (8, 40, 1024, 77, False, True),     # cross-attention: Sq != Sk
    (8, 40, 1152, 1152, False, True),   # Sq % 128 == 0, over 1024
    (8, 40, 1088, 1088, False, True),   # Sq % 128 != 0
    (8, 40, 1024, 1024, True, True),    # masked
    (8, 40, 1024, 1024, False, False),  # use_flash off
]


@pytest.mark.parametrize("flag", [None, "1", "0"])
@pytest.mark.parametrize("case", MHA_CASES)
def test_mha_route_predicate_matches_jax(monkeypatch, case, flag):
    heads, d, s, sk, masked, use_flash = case
    if flag is None:
        monkeypatch.delenv("C2D_PACKED_FLASH", raising=False)
    else:
        monkeypatch.setenv("C2D_PACKED_FLASH", flag)
    for backend, cuda in (("tpu", True), ("cpu", False)):
        jax_packed = _jax_mha_route(monkeypatch, 1, s, sk, heads, d, masked, use_flash,
                                    backend) == "packed"
        assert pattn.packed_mha_eligible((1, s, heads * d), (1, sk, heads * d), heads, masked,
                                         use_flash, cuda) == jax_packed, backend


# (h, d, Sq, Sk) for the [B, H, S, D] route of ``flash_attention``
FLASH_CASES = [(8, 40, 4096, 4096), (8, 40, 1024, 1024), (8, 80, 1024, 1024),
               (8, 64, 1024, 1024), (1, 40, 4096, 4096), (8, 40, 768, 768),
               (8, 40, 1024, 512), (8, 40, 1088, 1088), (1, 512, 4096, 4096)]


@pytest.mark.parametrize("flag", [None, "1"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_route_predicate_matches_jax(monkeypatch, case, flag):
    h, d, s, sk = case
    if flag is None:
        monkeypatch.delenv("C2D_PACKED_FLASH", raising=False)
    else:
        monkeypatch.setenv("C2D_PACKED_FLASH", flag)
    taken = []
    monkeypatch.setattr(jfa, "_packed_flash_fwd",
                        lambda q, k, v, scale, pack: taken.append(pack) or q)
    monkeypatch.setattr(jfa, "_flash_fwd_perhead", lambda q, k, v, scale, force_pad=False: q)
    jax.eval_shape(lambda q, k, v: jfa._flash_fwd(q, k, v, d ** -0.5),
                   jax.ShapeDtypeStruct((1, h, s, d), jnp.float32),
                   jax.ShapeDtypeStruct((1, h, sk, d), jnp.float32),
                   jax.ShapeDtypeStruct((1, h, sk, d), jnp.float32))
    assert pfa.packed_eligible((1, h, s, d), (1, h, sk, d), True) == bool(taken)
    if taken:  # the same pack as JAX's
        assert taken[0] == min(128 // d, h)
    assert not pfa.packed_eligible((1, h, s, d), (1, h, sk, d), False)  # CPU tensor


def test_cpu_tensors_never_take_the_packed_route(monkeypatch):
    """On the CPU ``mha`` and ``flash_attention`` stay on the per-head plain
    path with the flag set, and give the JAX package's per-head result."""
    monkeypatch.setenv("C2D_PACKED_FLASH", "1")
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(1, 1024, 2 * 32)).astype(np.float32) for _ in range(3))
    ours = pattn.mha(_t(q), _t(k), _t(v), 2, use_flash=True)
    monkeypatch.delenv("C2D_PACKED_FLASH")
    ref = jattn.mha(q, k, v, 2, use_flash=True)  # the CPU backend: XLA attention
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-6)
    assert pfa.packed_flash_attention.launches == 0 and pfa.flash_attention.launches == 0
