"""Winograd F(2x2, 3x3) convolution in one kernel: the Hopper kernel and its
plain version (counterpart of ``clap2diffusion_tpu/ops/winograd_pallas.py``).

The kernel replaces the TPU's ``_kernel`` (launched by
``conv3x3_winograd_pallas``). It is CUDA C++ for sm_90a in
``csrc/winograd.cu``, built with nvcc at first use and called through
ctypes; its header comment gives the design and what bounds it. As in the
JAX package it is wired into no model: its callers are
``conv3x3_winograd_pallas`` and ``chip_smoke.py``. The UNet's opt-in
``C2D_WINOGRAD=1`` route runs the plain-PyTorch ``ops/winograd.py``.

``conv3x3_winograd_pallas(x, kernel, bias)`` takes NHWC x [B, H, W, Cin]
(bf16 or fp32), an HWIO kernel [3, 3, Cin, Cout] and an optional bias
[Cout]. U = G w G^T is computed here in fp32 (plain PyTorch, as the TPU
computes it outside its kernel) and cast to x's type. The output is cast to
x's type and the bias added after that cast, in x's type, as the TPU
kernel's wrapper does (``ops/winograd.py`` adds it in fp32 before the cast,
as its JAX counterpart does). CPU tensors take the plain version; CUDA
tensors launch the kernel or raise.

Counters: ``conv3x3_winograd_pallas.launches`` / ``.shapes`` count launches
and the (x shape, Cout, dtype) they ran on.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from clap2diffusion_tpu_torch.ops import cuda_build
from clap2diffusion_tpu_torch.ops.winograd import (
    _AT,
    filter_transform,
    input_transform,
    interleave,
)

SOURCE = "winograd.cu"
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def eligible(x_shape, cin: int, cout: int) -> bool:
    """The kernel's limits: H and W even; Cin a multiple of 16 (one mma
    depth per step) and Cout a multiple of 8 (one mma width). The UNet's
    ``conv_in`` (Cin 4) and ``conv_out`` (Cout 4) are not taken."""
    _, h, w, _ = x_shape
    return h % 2 == 0 and w % 2 == 0 and h >= 2 and w >= 2 and cin % 16 == 0 and cout % 8 == 0


def plain_conv3x3_winograd_pallas(x: torch.Tensor, kernel: torch.Tensor,
                                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch, in the TPU kernel's order:
    V in fp32 cast to x's type, U = G w G^T in fp32 cast to x's type, the
    16 products with fp32 sums accumulated into the four outputs by the ±AT
    coefficients, the result cast to x's type, then the bias added in x's
    type."""
    b, h, w, _ = x.shape
    v16 = input_transform(x).float()
    u16 = filter_transform(kernel).to(x.dtype).float()
    acc = [[None, None], [None, None]]
    for i in range(4):
        for j in range(4):
            m = torch.matmul(v16[4 * i + j], u16[4 * i + j])
            for a in range(2):
                for c in range(2):
                    coef = _AT[a, i] * _AT[c, j]
                    if coef == 0.0:
                        continue
                    contrib = m if coef == 1.0 else -m
                    acc[a][c] = contrib if acc[a][c] is None else acc[a][c] + contrib
    y = interleave(acc, b, h // 2, w // 2).to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.c2d_winograd_conv3x3
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.c2d_cuda_error_string_winograd.restype = ctypes.c_char_p
        lib.c2d_cuda_error_string_winograd.argtypes = [ctypes.c_int]
    return lib


def build() -> None:
    """Compile and load the kernel library (no launch)."""
    _lib()


def winograd_filter(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """U = G w G^T as the kernel reads it: [16, Cout, Cin], contiguous, in
    ``dtype``."""
    return filter_transform(kernel).to(dtype).transpose(1, 2).contiguous()


def winograd_conv_fwd(x: torch.Tensor, u: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: x [B, H, W, Cin], u from
    ``winograd_filter``, bias [Cout] or None."""
    b, h, w, cin = x.shape
    if not x.is_cuda:
        raise ValueError(f"winograd_conv3x3: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"winograd_conv3x3: bf16 or fp32 input, got {x.dtype}")
    if u.dim() != 3 or u.shape[0] != 16 or u.shape[2] != cin or u.dtype != x.dtype \
            or u.device != x.device:
        raise ValueError(f"winograd_conv3x3: u must be [16, Cout, {cin}] {x.dtype} on "
                         f"{x.device}, got {tuple(u.shape)} {u.dtype}")
    cout = u.shape[1]
    if not eligible(x.shape, cin, cout):
        raise ValueError(f"winograd_conv3x3: the kernel takes even H, W, Cin % 16 == 0 and "
                         f"Cout % 8 == 0, got x{tuple(x.shape)}, Cout {cout}")
    if bias is not None and (bias.shape != (cout,) or bias.device != x.device):
        raise ValueError(f"winograd_conv3x3: bias must be [{cout}] on {x.device}")
    x, u = x.contiguous(), u.contiguous()
    bias = None if bias is None else bias.to(x.dtype).contiguous()
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.c2d_winograd_conv3x3(
            x.data_ptr(), u.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), _DTYPE_CODE[x.dtype], b, h, w, cin, cout,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("winograd_conv3x3 kernel failed: "
                           f"{lib.c2d_cuda_error_string_winograd(err).decode()}")
    conv3x3_winograd_pallas.launches += 1
    conv3x3_winograd_pallas.shapes[(tuple(x.shape), cout, str(x.dtype))] += 1
    return y


def conv3x3_winograd_pallas(x: torch.Tensor, kernel: torch.Tensor,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC 3x3 stride-1 SAME conv, Winograd F(2x2,3x3) in one kernel.

    x: [B, H, W, Cin], kernel: [3, 3, Cin, Cout]. The kernel has no
    backward: like the JAX function it serves no training path."""
    if x.device.type == "cpu":
        return plain_conv3x3_winograd_pallas(x, kernel, bias)
    return winograd_conv_fwd(x, winograd_filter(kernel, x.dtype), bias)


conv3x3_winograd_pallas.launches = 0
conv3x3_winograd_pallas.shapes = collections.Counter()
