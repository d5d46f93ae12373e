"""Flash-attention forward: the Hopper kernel and its plain version.

Replaces ``clap2diffusion_tpu/ops/flash_attention.py::_fwd_kernel``
(launched by ``_flash_fwd_perhead``). The kernel is CUDA C++ for sm_90a in
``csrc/flash_attention.cu``, built with nvcc at first use and called
through ctypes; its header comment gives the design and what bounds it.

``flash_attention(q, k, v, scale)`` takes [B, H, S, D] tensors, bf16 or
fp32, any strides with a contiguous last dim. On a CPU tensor it computes
the plain version; on a CUDA tensor it launches the kernel or raises.
``flash_attention.launches`` counts kernel launches and
``flash_attention.shapes`` the (q shape, k shape, dtype) they ran on.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from clap2diffusion_tpu_torch.ops import cuda_build

_SOURCE = "flash_attention.cu"
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MAX_D = 512


def plain_flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: fp32 logits and softmax,
    probabilities rounded to v's type before the PV product (fp32
    accumulation), normalisation after it."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return (pv / denom).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SOURCE)
    fn = lib.c2d_flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.c2d_cuda_error_string.restype = ctypes.c_char_p
        lib.c2d_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def build() -> None:
    """Compile and load the kernel library (no launch)."""
    _lib()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads 16-byte vectors: last dim contiguous, other strides
    a multiple of 8 elements, 16-byte aligned base. Copy when not."""
    ok = (
        t.stride(-1) == 1
        and all(s % 8 == 0 for s in t.stride()[:-1])
        and t.data_ptr() % 16 == 0
    )
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, H, S, D]."""
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, scale)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: tensors must share one CUDA device, got {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: bf16 or fp32 inputs of one type, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d % 8 or d > _MAX_D or sk == 0 or b * h > 65535:
        raise ValueError(f"flash_attention: head dim must be a multiple of 8 up to "
                         f"{_MAX_D} and B*H <= 65535, got d={d}, B*H={b * h}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    # [B, S, H, D] storage seen as [B, H, S, D]: merge_heads is then free
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.c2d_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, sq, sk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel failed: {lib.c2d_cuda_error_string(err).decode()}"
        )
    flash_attention.launches += 1
    flash_attention.shapes[(tuple(q.shape), tuple(k.shape), str(q.dtype))] += 1
    return out


flash_attention.launches = 0
flash_attention.shapes = collections.Counter()
