"""Flash attention, forward and backward: the Hopper kernels and their plain
versions.

The forward replaces ``clap2diffusion_tpu/ops/flash_attention.py::_fwd_kernel``
(launched by ``_flash_fwd_perhead``), the backward its ``_bwd_kernel``
(launched by ``_flash_bwd`` through the custom VJP). Both kernels are CUDA
C++ for sm_90a in ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``,
built with nvcc at first use and called through ctypes; their header
comments give the design and what bounds each.

``flash_attention(q, k, v, scale)`` takes [B, H, S, D] tensors, bf16 or
fp32, any strides with a contiguous last dim, and is differentiable. When
no input needs a gradient (serving) it launches the forward kernel alone,
with no log-sum-exp output. Otherwise it goes through
``FlashAttentionFunction``: the forward also writes the row log-sum-exp,
and the backward launches the backward kernel (head dims up to 160; the
VAE's 512 is never trained). On CPU tensors both directions run the plain
versions through the same Function; on CUDA tensors they launch the kernels
or raise.

Counters: ``flash_attention.launches`` / ``.shapes`` count forward launches
and the (q shape, k shape, dtype) they ran on; ``flash_attention_bwd.launches``
/ ``.shapes`` the same for the backward (one count per backward call, which
is three kernel launches: delta, dK/dV, dQ).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from clap2diffusion_tpu_torch.ops import cuda_build

_SOURCE = "flash_attention.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MAX_D = 512
MAX_BWD_D = 160


def plain_flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: fp32 logits and softmax,
    probabilities rounded to v's type before the PV product (fp32
    accumulation), normalisation after it."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return (pv / denom).to(q.dtype)


def plain_flash_attention_bwd(q, k, v, o, do, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the backward kernel computes, in plain PyTorch, step by step as
    the JAX ``_bwd_kernel``: fp32 throughout, P rebuilt from the logits,
    delta = rowsum(dO * O), dS = P * (dP - delta) * scale. P and dS are
    rounded to the input type before dV = P^T dO, dK = dS^T Q and
    dQ = dS K, where the kernel rounds them (a no-op in fp32). Returns
    (dq, dk, dv) in the input type."""
    dt = q.dtype
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SOURCE)
    fn = lib.c2d_flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.c2d_cuda_error_string.restype = ctypes.c_char_p
        lib.c2d_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load(_BWD_SOURCE)
    fn = lib.c2d_flash_attention_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        lib.c2d_cuda_error_string_bwd.restype = ctypes.c_char_p
        lib.c2d_cuda_error_string_bwd.argtypes = [ctypes.c_int]
    return lib


def build() -> None:
    """Compile both kernel libraries in parallel and load them (no launch)."""
    cuda_build.build_all([_SOURCE, _BWD_SOURCE])
    _lib()
    _bwd_lib()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels read 16-byte vectors: last dim contiguous, other strides
    a multiple of 8 elements, 16-byte aligned base. Copy when not."""
    ok = (
        t.stride(-1) == 1
        and all(s % 8 == 0 for s in t.stride()[:-1])
        and t.data_ptr() % 16 == 0
    )
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _bshd_empty(b, h, s, d, like: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] storage seen as [B, H, S, D]: merge_heads is then free."""
    return torch.empty((b, s, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def _check(q, k, v, max_d: int, who: str) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{who}: tensors must share one CUDA device, got {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{who}: bf16 or fp32 inputs of one type, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"{who}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, h, sq, d = q.shape
    if d % 8 or d > max_d or sq == 0 or k.shape[2] == 0 or b * h > 65535:
        raise ValueError(f"{who}: head dim must be a multiple of 8 up to {max_d} "
                         f"and B*H <= 65535, got d={d}, B*H={b * h}")


def _raise(lib_err, err: int, who: str) -> None:
    if err != 0:
        raise RuntimeError(f"{who} kernel failed: {lib_err(err).decode()}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        with_lse: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel on CUDA tensors: (out, lse). ``lse`` is the
    fp32 [B, H, Sq] row log-sum-exp when ``with_lse``, else None (the kernel
    then gets a null pointer and computes exactly what serving computes)."""
    _check(q, k, v, _MAX_D, "flash_attention")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = _bshd_empty(b, h, sq, d, q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.c2d_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, sq, sk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise(lib.c2d_cuda_error_string, err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.shapes[(tuple(q.shape), tuple(k.shape), str(q.dtype))] += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q k^T * scale) v for the upstream gradient
    ``do``, given the forward's ``o`` and fp32 ``lse``. CPU tensors take
    the plain version (``lse`` unused); CUDA tensors launch the kernel or
    raise. Outputs are in q's type, in [B, S, H, D] storage."""
    if q.device.type == "cpu":
        return plain_flash_attention_bwd(q, k, v, o, do, scale)
    _check(q, k, v, MAX_BWD_D, "flash_attention_bwd")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or o.device != q.device or do.device != q.device:
        raise ValueError(f"flash_attention_bwd: o/do must match q, got o{tuple(o.shape)} "
                         f"{o.dtype}, do{tuple(do.shape)} {do.dtype}")
    if lse is None or lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_bwd: lse must be the forward's contiguous fp32 "
                         f"[B, H, Sq] = {(b, h, sq)} on {q.device}")
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    dq, dk, dv = _bshd_empty(b, h, sq, d, q), _bshd_empty(b, h, sk, d, q), \
        _bshd_empty(b, h, sk, d, q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*[s for t in (q, k, v, o, do, dq, dk, dv)
                                         for s in t.stride()[:3]])
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        err = lib.c2d_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, sq, sk, d, ctypes.cast(strides, ctypes.c_void_p),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise(lib.c2d_cuda_error_string_bwd, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.shapes[(tuple(q.shape), tuple(k.shape), str(q.dtype))] += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention: the kernels on CUDA tensors, the
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        if q.device.type == "cpu":
            out, lse = plain_flash_attention(q, k, v, scale), None
        else:
            if q.shape[-1] > MAX_BWD_D:
                raise ValueError(f"flash_attention: the backward kernel takes head dims "
                                 f"up to {MAX_BWD_D}, got {q.shape[-1]}")
            out, lse = flash_attention_fwd(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, H, S, D]; differentiable."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, float(scale))
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, scale)
    return flash_attention_fwd(q, k, v, scale)[0]


for _fn in (flash_attention, flash_attention_bwd):
    _fn.launches = 0
    _fn.shapes = collections.Counter()
