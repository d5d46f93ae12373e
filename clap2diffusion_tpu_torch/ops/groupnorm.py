"""GroupNorm (+SiLU) over channels-last data: the Hopper kernel (CUDA C++)
and its plain version.

Replaces ``clap2diffusion_tpu/ops/groupnorm.py::_kernel`` (launched by
``_pallas_group_norm_silu``): GroupNorm with fp32 statistics, the affine,
and SiLU, over an NHWC activation. The plain version follows
``_xla_group_norm`` step by step: per-channel fp32 sums of x and x^2, a
per-group combine, the variance clamped at 0, and one pass of ``x*a + b``
with the affine folded per channel.

The kernel is ``csrc/group_norm.cu``, built by nvcc at first use and called
through ctypes: one cooperative launch per call, a persistent grid whose
blocks each own a run of pixel rows of one sample (all C channels, 16-byte
loads), with one grid-wide barrier: per-group fp32 partial sums of the
block's rows, then in every block the mean and 1/std of its sample's groups
summed over the sample's blocks in one fixed order (two launches give the
same bits), then ``y = x*a + b`` (then ``y*sigmoid(y)``) from the rows the
block kept in shared memory. What bounds it is bytes (reading x and writing y once), and at
the UNet's small slabs the host's cost per call: one ctypes call, the output
and a workspace from ``torch.empty``, and a cached plan. x is read from device
memory once where the whole slab fits the grid's shared memory (every UNet
slab in bf16 at batch 2; the largest, [2,64,64,960], is 15.7 MB); the VAE's
32-128 MB slabs read the rows past what a block keeps twice.
``launch_plan`` is the source's geometry as a pure function; the built
library reports its own (``kernel_plan``), and ``chip_smoke.py`` holds the
two against each other at every shape it runs.

``group_norm_silu`` and ``group_norm`` take [B, H, W, C] (contiguous as
NHWC, C a multiple of 8 up to 4096) in bf16, fp16 or fp32. On a CPU tensor
they compute the plain version; on a CUDA tensor they launch the kernel or
raise. Each keeps a launch count (``.launches``) and a count of the (shape,
dtype, groups, eps) it ran on (``.shapes``).

Gradients: when an input needs one, the call goes through
``GroupNormFunction``, whose forward is the same kernel (the plain version
on the CPU) and saves (x, scale, bias). Its backward recomputes
``plain_group_norm`` under autograd and returns that vector-Jacobian
product. This is deliberate and not a fallback: the JAX package's custom
VJPs (``groupnorm.py::_bwd`` and ``_gn_bwd``) do the same XLA recompute and
have no backward kernel, so there is none to port.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from clap2diffusion_tpu_torch.ops import counters, cuda_build

SOURCE = "group_norm.cu"
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
# csrc/group_norm.cu's constants
THREADS = 512
MAX_SMEM = 232_448       # bytes of shared memory one block may use
MIN_BLOCK_BYTES = 32_768  # of x a block owns at least, where the slab allows
MAX_C = 4096
SM_COUNT = 132            # an H100's streaming multiprocessors


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


@functools.lru_cache(maxsize=None)
def launch_plan(shape, dtype, groups: int, capacity: int = SM_COUNT) -> dict:
    """How the kernel is launched on an NHWC ``shape`` of ``dtype`` with
    ``groups`` groups, when ``capacity`` blocks of 512 threads at the largest
    shared memory can be resident at once (one per SM on an H100): blocks
    per sample enough that each owns 32 KB of x, at most ``capacity // B``,
    at most one a row; rows per block evened out over them; each thread's
    items are (16-byte column, row lane) pairs, ``lanes`` row lanes; a block
    keeps as many of its rows in shared memory as fit beside the per-lane
    sums, and ``resident`` says whether that is all of them.

    csrc/group_norm.cu owns the geometry and launches by it alone; this is
    its mirror for planning, allocation and records without a card, cached
    (one dict per key: do not change it), and ``kernel_plan`` is what the
    built library reports."""
    b, h, w, c = shape
    elem = torch.empty((), dtype=dtype).element_size()
    if c % 8 or not 8 <= c <= MAX_C or c % groups or not 1 <= b <= capacity:
        raise ValueError(f"group_norm: no plan for {tuple(shape)} in {groups} groups "
                         f"(C a multiple of 8 up to {MAX_C}, B <= {capacity})")
    hw = h * w
    row_bytes = c * elem
    owning_32kb = -(-hw * row_bytes * b // MIN_BLOCK_BYTES)  # blocks, rounded up
    bps = max(1, min(capacity // b, -(-owning_32kb // b), hw))
    rpb = -(-hw // bps)
    bps = -(-hw // rpb)
    vcols = row_bytes // 16
    lanes = 1 if vcols >= THREADS else THREADS // vcols
    fixed = lanes * 2 * c * 4
    keep = max(0, min(rpb, (MAX_SMEM - fixed) // row_bytes))
    grid = b * bps
    return {
        "grid": grid, "blocks_per_sample": bps, "rows_per_block": rpb, "keep_rows": keep,
        "lanes": lanes, "smem_bytes": fixed + keep * row_bytes, "resident": keep == rpb,
        "workspace_floats": grid * 2 * groups, "threads": THREADS,
        "capacity": capacity, "vec": 16 // elem, "vec_cols": vcols,
        "items_per_thread": -(-vcols * lanes // THREADS),
        # x is read once, and the rows past what each block keeps once more
        "x_reads": 2 - b * sum(min(keep, hw - k * rpb) for k in range(bps)) / (b * hw),
    }


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.c2d_group_norm_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.c2d_group_norm_plan.restype = ctypes.c_int
        lib.c2d_group_norm_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.c2d_cuda_error_string_gn.restype = ctypes.c_char_p
        lib.c2d_cuda_error_string_gn.argtypes = [ctypes.c_int]
    return lib


def build() -> None:
    """Load the kernel library (no launch), building it if it is not built."""
    _lib()


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel failed: {lib.c2d_cuda_error_string_gn(err).decode()}")


def kernel_plan(shape, dtype, groups: int, capacity: int = 0) -> dict:
    """The launch geometry as the built library reports it (host code of
    ``csrc/group_norm.cu``, no launch), under ``launch_plan``'s keys;
    ``capacity`` < 1 asks for the device's."""
    b, h, w, c = shape
    out = (ctypes.c_longlong * 10)()
    lib = _lib()
    _raise(lib, lib.c2d_group_norm_plan(b, h * w, c, _DTYPE_CODE[dtype], groups, capacity,
                                        ctypes.cast(out, ctypes.c_void_p)), "group_norm_plan")
    grid, bps, rpb, keep, lanes, smem, resident, ws, threads, cap = out
    return {"grid": grid, "blocks_per_sample": bps, "rows_per_block": rpb, "keep_rows": keep,
            "lanes": lanes, "smem_bytes": smem, "resident": bool(resident),
            "workspace_floats": ws, "threads": threads, "capacity": cap}


@functools.lru_cache(maxsize=None)
def device_capacity(index: int) -> int:
    """Resident blocks of the kernel at its largest shared memory on CUDA
    device ``index`` (the library's occupancy query)."""
    with torch.cuda.device(index):
        return kernel_plan((1, 1, 1, 8), torch.float32, 1)["capacity"]


def _launch(x, scale, bias, groups: int, eps: float, silu: bool) -> torch.Tensor:
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"group_norm: NHWC bf16/fp16/fp32 input expected, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, h, w, c = x.shape
    if c % groups or scale.shape != (c,) or bias.shape != (c,) or scale.dtype not in _DTYPE_CODE \
            or bias.dtype != scale.dtype:
        raise ValueError(f"group_norm: C={c} must split into {groups} groups and match "
                         f"scale/bias {tuple(scale.shape)}/{tuple(bias.shape)} of one float type")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("group_norm: scale and bias must be on the input's device")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    scale, bias = scale.contiguous(), bias.contiguous()
    index = x.device.index
    plan = launch_plan(tuple(x.shape), x.dtype, groups, device_capacity(index))
    y = torch.empty_like(x)
    ws = torch.empty(plan["workspace_floats"], dtype=torch.float32, device=x.device)
    lib = _lib()
    # the kernel launches on the current device: switch only where it is another
    with torch.cuda.device(index) if index != torch.cuda.current_device() \
            else contextlib.nullcontext():
        err = lib.c2d_group_norm_fwd(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), ws.data_ptr(),
            plan["workspace_floats"], _DTYPE_CODE[x.dtype], _DTYPE_CODE[scale.dtype], b, h * w, c,
            groups, float(eps), int(silu), torch.cuda.current_stream(index).cuda_stream)
    _raise(lib, err, "group_norm")
    return y


def _forward(x, scale, bias, groups: int, eps: float, silu: bool) -> torch.Tensor:
    """The plain version on a CPU tensor, the kernel on a CUDA tensor."""
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
    """GroupNorm(+SiLU) with the kernel forward and the JAX package's
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
    """GroupNorm over NHWC (the same kernel with SiLU off); differentiable."""
    return _apply(x, scale, bias, groups, eps, silu=False)


for _fn in (group_norm_silu, group_norm):
    counters.kernel(_fn)
