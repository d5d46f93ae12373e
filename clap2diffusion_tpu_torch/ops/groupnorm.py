"""GroupNorm (+SiLU) over channels-last data: the Hopper kernel (Triton)
and its plain version.

Replaces ``clap2diffusion_tpu/ops/groupnorm.py::_kernel`` (launched by
``_pallas_group_norm_silu``): GroupNorm with fp32 statistics, the affine,
and SiLU, over an NHWC activation. The plain version follows
``_xla_group_norm`` step by step: per-channel fp32 sums of x and x^2, a
per-group combine, the variance clamped at 0, and one pass of ``x*a + b``
with the affine folded per channel.

What bounds it on an H100: bytes. It does ~10 operations per element it
moves, far below the ~20 operations per byte at which fp32 arithmetic would
limit it, so the least time is reading x and writing y once at 3.35 TB/s.
The TPU kernel ran one grid step per sample over a VMEM-resident slab; on
the H100 that would leave most of 132 SMs idle (the VAE's [1,512,512,256]
slab is 128 MB in bf16), so the design spreads every call over the card in
three launches:
  1. ``_partial_sums``: one program per (sample, row chunk, 64-channel
     block) sums x and x^2 per channel in fp32 over its rows;
  2. ``_group_stats``: one program per (sample, group) combines the chunks
     and the group's channels into mean and 1/std, and folds the affine
     into per-channel ``a = scale/std`` and ``b = bias - mean*a``;
  3. ``_apply``: one read of x, ``y = x*a + b`` (then ``y*sigmoid(y)``),
     one write of y.
x is read twice; at the UNet's slabs (at most 5.2 MB) the second read
mostly hits the 50 MB L2. Groups of C/G = 10 channels (C=320) and the
concatenated skip widths (960, 1920, 2560) need no special case, because
the statistics are per channel first and per group second.

``group_norm_silu`` and ``group_norm`` take [B, H, W, C] (any layout that
is contiguous as NHWC). On a CPU tensor they compute the plain version; on
a CUDA tensor they launch the kernels or raise. Each keeps a launch
count (``.launches``) and a count of the (shape, dtype, groups, eps) it
ran on (``.shapes``). The Triton cache goes beside the CUDA build
(``build/kernels/triton``) unless ``TRITON_CACHE_DIR`` is set.

Gradients: when an input needs one, the call goes through
``GroupNormFunction``, whose forward is the same kernels (the plain version
on the CPU) and saves (x, scale, bias). Its backward recomputes
``plain_group_norm`` under autograd and returns that vector-Jacobian
product. This is deliberate and not a fallback: the JAX package's custom
VJPs (``groupnorm.py::_bwd`` and ``_gn_bwd``) do the same XLA recompute and
have no backward kernel, so there is none to port.
"""

from __future__ import annotations

import collections
import os

import torch

from clap2diffusion_tpu_torch.ops import cuda_build

_BLOCK_R = 64
_BLOCK_C = 64
_TARGET_PROGRAMS = 1024
_KERNELS = None


def plain_group_norm(x, scale, bias, groups: int, eps: float, silu: bool) -> torch.Tensor:
    """The JAX package's ``_xla_group_norm`` in PyTorch, over NHWC."""
    b, h, w, c = x.shape
    cg = c // groups
    xf = x.float()
    s1 = xf.sum(dim=(1, 2))
    s2 = xf.square().sum(dim=(1, 2))
    g1 = s1.view(b, groups, cg).sum(-1)
    g2 = s2.view(b, groups, cg).sum(-1)
    n = h * w * cg
    mean = g1 / n
    var = torch.clamp(g2 / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(cg, dim=1)
    mean_c = mean.repeat_interleave(cg, dim=1)
    a = inv_c * scale.float()[None, :]
    off = bias.float()[None, :] - mean_c * a
    y = xf * a[:, None, None, :] + off[:, None, None, :]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _kernels():
    """Define the Triton kernels on first use (this keeps the module
    importable where triton is not installed). ``triton`` and ``tl`` become
    module globals, where Triton's compiler looks names up."""
    global _KERNELS, triton, tl
    if _KERNELS is not None:
        return _KERNELS
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cuda_build.build_dir(), "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def _partial_sums(x_ptr, part_ptr, HW, C, rows_per_chunk, n_chunks,
                      BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = pid // n_chunks
        chunk = pid % n_chunks
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        r_start = chunk * rows_per_chunk
        r_end = tl.minimum(r_start + rows_per_chunk, HW)
        acc1 = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
        acc2 = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
        base = x_ptr + b.to(tl.int64) * HW * C
        for r0 in range(r_start, r_end, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            m = (rows < r_end)[:, None] & cmask[None, :]
            x = tl.load(base + rows.to(tl.int64)[:, None] * C + cols[None, :],
                        mask=m, other=0.0).to(tl.float32)
            acc1 += x
            acc2 += x * x
        out = part_ptr + (pid * 2) * C
        tl.store(out + cols, tl.sum(acc1, axis=0), mask=cmask)
        tl.store(out + C + cols, tl.sum(acc2, axis=0), mask=cmask)

    @triton.jit
    def _group_stats(part_ptr, w_ptr, bias_ptr, a_ptr, shift_ptr, n_chunks, C, CG,
                     G, count, eps, BLOCK_K: tl.constexpr, BLOCK_CG: tl.constexpr):
        pid = tl.program_id(0)
        b = pid // G
        g = pid % G
        cols = g * CG + tl.arange(0, BLOCK_CG)
        cmask = tl.arange(0, BLOCK_CG) < CG
        acc1 = tl.zeros((BLOCK_K, BLOCK_CG), dtype=tl.float32)
        acc2 = tl.zeros((BLOCK_K, BLOCK_CG), dtype=tl.float32)
        for k0 in range(0, n_chunks, BLOCK_K):
            ks = k0 + tl.arange(0, BLOCK_K)
            m = (ks < n_chunks)[:, None] & cmask[None, :]
            rows = (b * n_chunks + ks) * 2
            acc1 += tl.load(part_ptr + rows[:, None] * C + cols[None, :], mask=m, other=0.0)
            acc2 += tl.load(part_ptr + (rows + 1)[:, None] * C + cols[None, :], mask=m,
                            other=0.0)
        mean = tl.sum(tl.sum(acc1, axis=1), axis=0) / count
        var = tl.maximum(tl.sum(tl.sum(acc2, axis=1), axis=0) / count - mean * mean, 0.0)
        inv = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        bb = tl.load(bias_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        a = inv * w
        tl.store(a_ptr + b * C + cols, a, mask=cmask)
        tl.store(shift_ptr + b * C + cols, bb - mean * a, mask=cmask)

    @triton.jit
    def _apply(x_ptr, y_ptr, a_ptr, shift_ptr, HW, C, n_rblocks, SILU: tl.constexpr,
               BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = pid // n_rblocks
        rows = (pid % n_rblocks) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        m = (rows < HW)[:, None] & cmask[None, :]
        offs = b.to(tl.int64) * HW * C + rows.to(tl.int64)[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=m, other=0.0)
        a = tl.load(a_ptr + b * C + cols, mask=cmask, other=0.0)
        s = tl.load(shift_ptr + b * C + cols, mask=cmask, other=0.0)
        y = x.to(tl.float32) * a[None, :] + s[None, :]
        if SILU:
            y = y * (1.0 / (1.0 + tl.exp(-y)))
        tl.store(y_ptr + offs, y.to(x.dtype), mask=m)

    _KERNELS = (triton, _partial_sums, _group_stats, _apply)
    return _KERNELS


def build() -> None:
    """Import triton and define the kernels (they compile at first launch)."""
    _kernels()


def _launch(x, scale, bias, groups: int, eps: float, silu: bool) -> torch.Tensor:
    triton, partial_sums, group_stats, apply = _kernels()
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"group_norm: NHWC float input expected, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, h, w, c = x.shape
    if c % groups or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm: C={c} must split into {groups} groups and "
                         f"match scale/bias {tuple(scale.shape)}/{tuple(bias.shape)}")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("group_norm: scale and bias must be on the input's device")
    x = x.contiguous()
    hw = h * w
    n_cblocks = triton.cdiv(c, _BLOCK_C)
    n_chunks = max(1, min(triton.cdiv(hw, _BLOCK_R),
                          _TARGET_PROGRAMS // max(1, b * n_cblocks)))
    rows_per_chunk = triton.cdiv(triton.cdiv(hw, n_chunks), _BLOCK_R) * _BLOCK_R
    n_chunks = triton.cdiv(hw, rows_per_chunk)
    cg = c // groups
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((b, n_chunks, 2, c), **f32)
    a = torch.empty((b, c), **f32)
    shift = torch.empty((b, c), **f32)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        partial_sums[(b * n_chunks, n_cblocks)](
            x, part, hw, c, rows_per_chunk, n_chunks, BLOCK_R=_BLOCK_R, BLOCK_C=_BLOCK_C)
        group_stats[(b * groups,)](
            part, scale.contiguous(), bias.contiguous(), a, shift, n_chunks, c, cg,
            groups, float(hw * cg), float(eps),
            BLOCK_K=min(64, triton.next_power_of_2(n_chunks)),
            BLOCK_CG=triton.next_power_of_2(cg))
        n_rblocks = triton.cdiv(hw, _BLOCK_R)
        apply[(b * n_rblocks, n_cblocks)](
            x, y, a, shift, hw, c, n_rblocks, SILU=silu, BLOCK_R=_BLOCK_R,
            BLOCK_C=_BLOCK_C)
    return y


def _forward(x, scale, bias, groups: int, eps: float, silu: bool) -> torch.Tensor:
    """The plain version on a CPU tensor, the kernels on a CUDA tensor."""
    if x.device.type == "cpu":
        return plain_group_norm(x, scale, bias, groups, eps, silu)
    if not x.is_cuda:
        raise ValueError(f"group_norm: CPU or CUDA tensor expected, got {x.device}")
    y = _launch(x, scale, bias, groups, eps, silu)
    fn = group_norm_silu if silu else group_norm
    fn.launches += 1
    fn.shapes[(tuple(x.shape), str(x.dtype), groups, eps)] += 1
    return y


class GroupNormFunction(torch.autograd.Function):
    """GroupNorm(+SiLU) with the kernels forward and the JAX package's
    backward: autograd of ``plain_group_norm`` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups: int, eps: float, silu: bool):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (groups, eps, silu)
        return _forward(x, scale, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            y = plain_group_norm(*inputs, *ctx.args)
            grads = torch.autograd.grad(y, [t for t in inputs if t.requires_grad], gy)
        it = iter(grads)
        return (*(next(it) if n else None for n in need), None, None, None)


def _apply(x, scale, bias, groups: int, eps: float, silu: bool) -> torch.Tensor:
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return GroupNormFunction.apply(x, scale, bias, groups, eps, silu)
    return _forward(x, scale, bias, groups, eps, silu)


def group_norm_silu(x, scale, bias, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm + SiLU over NHWC; differentiable."""
    return _apply(x, scale, bias, groups, eps, silu=True)


def group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC (the same kernels with SiLU off); differentiable."""
    return _apply(x, scale, bias, groups, eps, silu=False)


for _fn in (group_norm_silu, group_norm):
    _fn.launches = 0
    _fn.shapes = collections.Counter()
