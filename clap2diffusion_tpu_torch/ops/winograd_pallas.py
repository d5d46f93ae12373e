"""Winograd F(2x2, 3x3) convolution: the Hopper kernel and its plain version
(counterpart of ``clap2diffusion_tpu/ops/winograd_pallas.py``).

The kernel replaces the TPU's ``_kernel`` (launched by
``conv3x3_winograd_pallas``). It is CUDA C++ for sm_90a in
``csrc/winograd.cu``, built with nvcc at first use and called through
ctypes; its header comment gives the design and what bounds it: a filter
transform, an input transform done once per patch, 16 products through a
cp.async ring of shared-memory stages, and a deterministic sum over splits
of the Cin loop where tiles x Cout alone would leave SMs idle. As in the
JAX package it is wired into no model: its callers are
``conv3x3_winograd_pallas`` and ``chip_smoke.py``. The UNet's opt-in
``C2D_WINOGRAD=1`` route runs the plain-PyTorch ``ops/winograd.py``.

``conv3x3_winograd_pallas(x, kernel, bias)`` takes NHWC x [B, H, W, Cin]
(bf16 or fp32), an HWIO kernel [3, 3, Cin, Cout] and an optional bias
[Cout]. U = G w G^T is computed in fp32 and cast once to x's type (on the
card by the ``wino_filter`` kernel, on the CPU in plain PyTorch). The
output is cast to x's type and the bias added after that cast, in x's
type, as the TPU kernel's wrapper does (``ops/winograd.py`` adds it in
fp32 before the cast, as its JAX counterpart does). CPU tensors take the
plain version; CUDA tensors launch the kernel or raise.

``launch_plan`` is the kernel's launch plan, a pure function of (x shape,
Cout, dtype): the grid, the split of the Cin loop and the shared memory.

Counters: ``conv3x3_winograd_pallas.launches`` / ``.shapes`` count calls of
the conv kernel and the (x shape, Cout, dtype) they ran on.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
from typing import Dict, Optional

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
SM_COUNT = 132          # an H100's streaming multiprocessors
MAX_SMEM = 232_448      # bytes of shared memory one block may use
# the bf16 kernel's tile (csrc/winograd.cu: TM, TN, KC, STAGES, GEMM_THREADS)
TILE_M, TILE_N, STEP_K, STAGES, THREADS = 64, 64, 16, 3, 256
# the fp32 kernel's tile (FTM, FTN, FKC), one stage, no split
F32_TILE_M, F32_TILE_N, F32_STEP_K = 32, 64, 8
MAX_SPLIT = 16
# what a block costs beyond its share of the Cin loop, in steps (filling the
# ring, the epilogue, its fp32 partial), and the least gain worth a split
# where the grid fills the card by itself: chosen after split sweeps on an
# H100 at five census shapes
_SPLIT_OVERHEAD_STEPS = 6
_SPLIT_MIN_GAIN = 0.9


def eligible(x_shape, cin: int, cout: int) -> bool:
    """The kernel's limits: H and W even; Cin a multiple of 16 (one mma
    depth per step) and Cout a multiple of 8 (one mma width). The UNet's
    ``conv_in`` (Cin 4) and ``conv_out`` (Cout 4) are not taken."""
    _, h, w, _ = x_shape
    return h % 2 == 0 and w % 2 == 0 and h >= 2 and w >= 2 and cin % 16 == 0 and cout % 8 == 0


def launch_plan(x_shape, cout: int, dtype: torch.dtype) -> Dict:
    """How the conv kernel is launched on (x shape, Cout, dtype) (a fresh
    dict; the wrapper keeps the plans it has computed).

    Blocks own ``tile_m`` tiles x ``tile_n`` output channels. bf16: where
    that grid is smaller than the card (``SM_COUNT``), the Cin loop's
    16-channel steps are cut into ``split`` contiguous ranges (``k_ranges``,
    in steps), one per ``blockIdx.z``, whose fp32 partials a reduce pass sums
    in order. The split minimises waves x (steps per split + a block's fixed
    cost): among the splits that reach ``SM_COUNT`` blocks (the largest one
    if none does), or, where the grid fills the card by itself, only if it
    evens out the last wave by a tenth or more. The rule of ``SM_COUNT``
    blocks comes first: where a smaller split in one wave is faster (120
    blocks at [2, 8, 8, 1280 -> 1280]), the plan does not take it. fp32 never
    splits.

    The split is this function's alone (the kernel is handed it). Tiles,
    grid, threads and shared memory are the source's, which launches by them
    whatever stands here; this is their mirror for planning scratch and for
    records without a card, and ``kernel_plan`` is what the built library
    reports, which ``chip_smoke.py`` holds this against at every shape it
    runs."""
    return dict(_plan(tuple(x_shape), cout, dtype))


@functools.lru_cache(maxsize=None)
def _plan(x_shape, cout: int, dtype: torch.dtype) -> Dict:
    b, h, w, cin = x_shape
    tiles = b * (h // 2) * (w // 2)
    bf16 = dtype == torch.bfloat16
    tile_m, tile_n, step_k = (TILE_M, TILE_N, STEP_K) if bf16 else (
        F32_TILE_M, F32_TILE_N, F32_STEP_K)
    steps = cin // step_k
    m_blocks, n_blocks = -(-tiles // tile_m), -(-cout // tile_n)
    base = m_blocks * n_blocks
    split = 1
    if bf16:
        cands = range(1, min(steps, MAX_SPLIT) + 1)

        def cost(s):  # waves x (the longest split's steps + a block's fixed cost)
            return -(-base * s // SM_COUNT) * (-(-steps // s) + _SPLIT_OVERHEAD_STEPS)

        if base >= SM_COUNT:  # the grid fills the card: split only to even out the last wave
            best = min(cands, key=lambda s: (cost(s), s))
            split = best if cost(best) <= _SPLIT_MIN_GAIN * cost(1) else 1
        else:
            reach = [s for s in cands if base * s >= SM_COUNT]
            split = min(reach, key=lambda s: (cost(s), s)) if reach else cands[-1]
    elem = 2 if bf16 else 4
    stage = 16 * (tile_m + tile_n) * step_k * elem
    return {
        "tile_m": tile_m, "tile_n": tile_n, "step_k": step_k,
        "stages": STAGES if bf16 else 1, "threads": THREADS,
        "grid": (m_blocks, n_blocks, split), "blocks": base * split, "split": split,
        "k_ranges": [(z * steps // split, (z + 1) * steps // split) for z in range(split)],
        "smem_bytes": stage * (STAGES if bf16 else 1),
        "v_scratch_elems": 16 * tiles * cin if bf16 else 0,
        "partial_elems": split * b * h * w * cout if split > 1 else 0,
    }


def filter_transform_steps(kernel: torch.Tensor) -> torch.Tensor:
    """U = G w G^T step by step in the ``wino_filter`` kernel's order: fp32,
    each row of G applied to three values summed left to right, first over
    the filter's rows and then over its columns: [16, Cin, Cout]."""
    w = kernel.float()

    def g_rows(a, b, c):
        return [a, 0.5 * ((a + b) + c), 0.5 * ((a - b) + c), c]

    t = [g_rows(w[0, q], w[1, q], w[2, q]) for q in range(3)]  # t[q][i]
    u = [g_rows(t[0][i], t[1][i], t[2][i]) for i in range(4)]  # u[i][j]
    return torch.stack([u[i][j] for i in range(4) for j in range(4)])


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
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.c2d_winograd_filter.restype = ctypes.c_int
        lib.c2d_winograd_filter.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                            + [ctypes.c_void_p])
        lib.c2d_winograd_plan.restype = ctypes.c_int
        lib.c2d_winograd_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.c2d_cuda_error_string_winograd.restype = ctypes.c_char_p
        lib.c2d_cuda_error_string_winograd.argtypes = [ctypes.c_int]
    return lib


def build() -> None:
    """Compile and load the kernel library (no launch)."""
    _lib()


def _raise(lib, err: int, who: str) -> None:
    if err != 0:
        raise RuntimeError(f"{who} kernel failed: "
                           f"{lib.c2d_cuda_error_string_winograd(err).decode()}")


def kernel_plan(x_shape, cout: int, dtype: torch.dtype, split: int) -> Dict:
    """The launch geometry as the built library reports it for ``split``
    (host code of ``csrc/winograd.cu``, no launch), under ``launch_plan``'s
    keys."""
    b, h, w, _ = x_shape
    out = (ctypes.c_int * 9)()
    lib = _lib()
    _raise(lib, lib.c2d_winograd_plan(_DTYPE_CODE[dtype], b, h, w, cout, split,
                                      ctypes.cast(out, ctypes.c_void_p)), "winograd_plan")
    gx, gy, gz, threads, smem, tile_m, tile_n, step_k, stages = out
    return {"grid": (gx, gy, gz), "blocks": gx * gy * gz, "threads": threads,
            "smem_bytes": smem, "tile_m": tile_m, "tile_n": tile_n, "step_k": step_k,
            "stages": stages}


def _on_device(device: torch.device):
    """``torch.cuda.device(device)`` only where it is not the current one
    already: the switch costs more than a small conv's kernels."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def winograd_filter(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """U = G w G^T as the kernel reads it: [16, Cin, Cout], contiguous, in
    ``dtype`` (fp32 sums, one cast). An HWIO [3, 3, Cin, Cout] kernel on the
    CPU takes plain PyTorch; on the card it launches ``wino_filter`` or
    raises."""
    if kernel.device.type == "cpu":
        return filter_transform(kernel).to(dtype).contiguous()
    if kernel.dim() != 4 or tuple(kernel.shape[:2]) != (3, 3) or kernel.shape[3] % 8 \
            or kernel.dtype not in _DTYPE_CODE or dtype not in _DTYPE_CODE:
        raise ValueError(f"winograd_filter: an HWIO [3, 3, Cin, Cout % 8 == 0] bf16 or fp32 "
                         f"kernel, got {tuple(kernel.shape)} {kernel.dtype} -> {dtype}")
    kernel = kernel.contiguous()
    _, _, cin, cout = kernel.shape
    u = torch.empty((16, cin, cout), dtype=dtype, device=kernel.device)
    lib = _lib()
    with _on_device(kernel.device):
        err = lib.c2d_winograd_filter(
            kernel.data_ptr(), u.data_ptr(), _DTYPE_CODE[kernel.dtype], _DTYPE_CODE[dtype],
            cin, cout, torch.cuda.current_stream(kernel.device).cuda_stream)
    _raise(lib, err, "winograd_filter")
    return u


def winograd_conv_fwd(x: torch.Tensor, u: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: x [B, H, W, Cin], u from
    ``winograd_filter``, bias [Cout] or None. The scratch buffers of
    ``launch_plan`` are allocated here."""
    b, h, w, cin = x.shape
    if not x.is_cuda:
        raise ValueError(f"winograd_conv3x3: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"winograd_conv3x3: bf16 or fp32 input, got {x.dtype}")
    if u.dim() != 3 or u.shape[0] != 16 or u.shape[1] != cin or u.dtype != x.dtype \
            or u.device != x.device:
        raise ValueError(f"winograd_conv3x3: u must be [16, {cin}, Cout] {x.dtype} on "
                         f"{x.device}, got {tuple(u.shape)} {u.dtype}")
    cout = u.shape[2]
    if not eligible(x.shape, cin, cout):
        raise ValueError(f"winograd_conv3x3: the kernel takes even H, W, Cin % 16 == 0 and "
                         f"Cout % 8 == 0, got x{tuple(x.shape)}, Cout {cout}")
    if bias is not None and (bias.shape != (cout,) or bias.device != x.device):
        raise ValueError(f"winograd_conv3x3: bias must be [{cout}] on {x.device}")
    x, u = x.contiguous(), u.contiguous()
    bias = None if bias is None else bias.to(x.dtype).contiguous()
    plan = _plan(tuple(x.shape), cout, x.dtype)
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    # one scratch allocation: the fp32 partials, then V (both 16-byte aligned)
    part_bytes, v_bytes = 4 * plan["partial_elems"], 2 * plan["v_scratch_elems"]
    scratch = (torch.empty(part_bytes + v_bytes, dtype=torch.uint8, device=x.device)
               if part_bytes + v_bytes else None)
    base = 0 if scratch is None else scratch.data_ptr()
    lib = _lib()
    with _on_device(x.device):
        err = lib.c2d_winograd_conv3x3(
            x.data_ptr(), u.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), base + part_bytes if v_bytes else None,
            base if part_bytes else None, _DTYPE_CODE[x.dtype],
            b, h, w, cin, cout, plan["split"],
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise(lib, err, "winograd_conv3x3")
    conv3x3_winograd_pallas.launches += 1
    conv3x3_winograd_pallas.shapes[(tuple(x.shape), cout, str(x.dtype))] += 1
    return y


def conv3x3_winograd_pallas(x: torch.Tensor, kernel: torch.Tensor,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC 3x3 stride-1 SAME conv, Winograd F(2x2,3x3) on the kernel.

    x: [B, H, W, Cin], kernel: [3, 3, Cin, Cout]. The kernel has no
    backward: like the JAX function it serves no training path."""
    if x.device.type == "cpu":
        return plain_conv3x3_winograd_pallas(x, kernel, bias)
    return winograd_conv_fwd(x, winograd_filter(kernel, x.dtype), bias)


conv3x3_winograd_pallas.launches = 0
conv3x3_winograd_pallas.shapes = collections.Counter()
