"""Flash attention, forward and backward: the Hopper kernels and their plain
versions.

The forward replaces ``clap2diffusion_tpu/ops/flash_attention.py::_fwd_kernel``
(launched by ``_flash_fwd_perhead``), the backward its ``_bwd_kernel``
(launched by ``_flash_bwd`` through the custom VJP). Both kernels are CUDA
C++ for sm_90a in ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``,
built with nvcc at first use and called through ctypes; their header
comments give the design and what bounds each. The bf16 forward has three
designs, chosen by the head dim alone (``flash_design``): up to instance 80
a warp-specialised kernel, a TMA producer warpgroup and three (two at 80)
consumer warpgroups of 64 query rows over a 2-stage ring of 128-key tiles,
which overlap the softmax with the products; up to 160 the tile pipeline of
``csrc/attention_core.cuh`` with one head a block, 192 query rows on three
warpgroups over a 3-stage ring of 64-key tiles; and 64 rows on four
warpgroups that split the keys of S and the columns of O for the VAE's
d = 512 (``flash_launch_plan`` is the launch plan). The bf16
backward runs on the same tile pipeline: a dK/dV role with 192 (128 above
d = 80) keys a block, K and V as A tiles and Q, dO streamed, and a dQ role
like the forward with K, V streamed, both roles in one launch after a
delta pre-pass; no atomics (``flash_bwd_launch_plan`` is its launch plan).

``flash_attention(q, k, v, scale)`` takes [B, H, S, D] tensors, bf16 or
fp32, any strides with a contiguous last dim, and is differentiable. When
no input needs a gradient (serving) it launches the forward kernel alone,
with no log-sum-exp output. Otherwise it goes through
``FlashAttentionFunction``: the forward also writes the row log-sum-exp,
and the backward launches the backward kernel (head dims up to 160; the
VAE's 512 is never trained). On CPU tensors both directions run the plain
versions through the same Function; on CUDA tensors they launch the kernels
or raise.

The head-packed forward replaces the TPU's ``_packed_fwd_kernel`` (launched
by ``_packed_flash_fwd`` and ``_packed_flash_nhd_fwd``), CUDA C++ in
``csrc/packed_flash_attention.cu`` on the tile pipeline of
``csrc/attention_core.cuh``: self-attention for ``pack`` heads per block,
read through strides, the group's heads side by side on their own
warpgroups over K/V tiles loaded once for all of them and for 192 query
rows, wgmma products, with an online softmax (the
plain version keeps the TPU kernel's order, which normalises P before the PV
product; ``packed_launch_plan`` is the launch plan).
``packed_flash_attention`` takes [B, H, S, D]
and ``packed_flash_nhd`` the [B, S, H*D] projection layout, with no head
transposes. Both are differentiable through ``PackedFlashAttentionFunction``,
whose backward is the per-head backward kernel on [B, H, S, D] views, as the
JAX VJP recomputes through ``_flash_bwd``. ``flash_attention`` itself takes
the packed route under the JAX ``_flash_fwd`` rule (``packed_eligible``):
``C2D_PACKED_FLASH=1``, read per call, and a CUDA tensor.

Counters: ``flash_attention.launches`` / ``.shapes`` count per-head forward
launches and the (q shape, k shape, dtype) they ran on, ``.designs`` the
launches by kernel (``"ws"``, ``"narrow"``, ``"wide"``, and ``"f32"`` for
the fp32 kernel);
``packed_flash_attention.launches`` / ``.shapes`` the packed forward's
launches and (q shape as [B, H, S, D], pack, dtype); ``flash_attention_bwd``
the same for the backward (one count per backward call, which is two kernel
launches: the delta pre-pass, then the dK/dV and dQ roles in one launch).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
from typing import Optional, Tuple

import torch

from clap2diffusion_tpu_torch.ops import counters, cuda_build

_SOURCE = "flash_attention.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
_PACKED_SOURCE = "packed_flash_attention.cu"
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MAX_D = 512
MAX_BWD_D = 160
MAX_PACKED_D = 64


def plain_flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: fp32 logits and softmax,
    probabilities rounded to v's type before the PV product (fp32
    accumulation), normalisation after it."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return (pv / denom).to(q.dtype)


def plain_packed_flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """What the packed kernel computes, in plain PyTorch, per head in the TPU
    kernel's order: fp32 logits, max, exp, sum, ``p * (1/sum)``, P rounded
    to v's type, PV with fp32 sums, output cast. Over [B, H, S, D]: packing
    changes which heads share a kernel instance, not the arithmetic. The
    bf16 kernel rounds P against the running max and divides at the end (an
    online softmax), inside the bf16 tolerance of this order."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p * torch.reciprocal(p.sum(dim=-1, keepdim=True))
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


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
        lib.c2d_flash_plan.restype = ctypes.c_int
        lib.c2d_flash_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.c2d_cuda_error_string.restype = ctypes.c_char_p
        lib.c2d_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare a backward library's C interface, once per library (also a
    baseline checkout's, which may predate ``c2d_flash_bwd_plan``)."""
    fn = lib.c2d_flash_attention_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        if hasattr(lib, "c2d_flash_bwd_plan"):
            lib.c2d_flash_bwd_plan.restype = ctypes.c_int
            lib.c2d_flash_bwd_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.c2d_cuda_error_string_bwd.restype = ctypes.c_char_p
        lib.c2d_cuda_error_string_bwd.argtypes = [ctypes.c_int]
    return lib


def _bwd_lib() -> ctypes.CDLL:
    return _bind_bwd(cuda_build.load(_BWD_SOURCE))


def _packed_lib() -> ctypes.CDLL:
    lib = cuda_build.load(_PACKED_SOURCE)
    fn = lib.c2d_packed_flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.c2d_packed_flash_plan.restype = ctypes.c_int
        lib.c2d_packed_flash_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.c2d_cuda_error_string_packed.restype = ctypes.c_char_p
        lib.c2d_cuda_error_string_packed.argtypes = [ctypes.c_int]
    return lib


SOURCES = (_SOURCE, _BWD_SOURCE, _PACKED_SOURCE)


def build() -> None:
    """Load the three kernel libraries (no launch), building any that are
    not built yet, in parallel."""
    cuda_build.build_all(SOURCES)
    _lib()
    _bwd_lib()
    _packed_lib()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels read 16-byte vectors: last dim contiguous, other strides
    a multiple of 8 elements (not 0 where the dim has more than one row: a
    tensor map refuses it), 16-byte aligned base. Copy when not."""
    ok = (
        t.stride(-1) == 1
        and all(s % 8 == 0 and (s or n == 1) for s, n in zip(t.stride()[:-1], t.shape[:-1]))
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
    index = q.device.index
    # the kernel launches on the current device: switch only where it is another
    with torch.cuda.device(index) if index != torch.cuda.current_device() \
            else contextlib.nullcontext():
        err = lib.c2d_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, sq, sk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), torch.cuda.current_stream(index).cuda_stream,
        )
    _raise(lib.c2d_cuda_error_string, err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.shapes[(tuple(q.shape), tuple(k.shape), str(q.dtype))] += 1
    flash_attention.designs[flash_design(d) if q.dtype == torch.bfloat16 else "f32"] += 1
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


def _needs_grad(q, k, v) -> bool:
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)


def packed_eligible(q_shape, k_shape, cuda: bool) -> bool:
    """The JAX ``_flash_fwd`` test for its packed route (``pack = 128//d``
    >= 2, h >= 2, Sq >= 1024, Sq == Sk, Sq % 128 == 0, ``C2D_PACKED_FLASH=1``
    read per call), with a CUDA tensor as the kernel's condition."""
    _, h, sq, d = q_shape
    return (cuda and 128 // d >= 2 and h >= 2 and sq >= 1024 and sq == k_shape[2]
            and sq % 128 == 0 and os.environ.get("C2D_PACKED_FLASH") == "1")


# the bf16 packed kernel's tiling (csrc/attention_core.cuh: BQ, QT, BK, STAGES)
PACKED_BQ, PACKED_QT, PACKED_BK, PACKED_STAGES, PACKED_WARPS_PER_HEAD = 64, 3, 64, 3, 4
MAX_SMEM = 232_448  # bytes of shared memory one block may use
SM_COUNT = 132      # an H100's streaming multiprocessors


def max_pack(d: int) -> int:
    """Heads per block at most (csrc/packed_flash_attention.cu: max_pack): one
    warpgroup a head, and the block's threads must fit the registers of the
    three sub-tiles' accumulators."""
    return 4 if d <= 32 else 3 if d <= 40 else 2


def _packed_smem_bytes(pack: int, d: int) -> int:
    """Q tile (every head's columns padded to a multiple of 16, as 128-byte
    core matrices) and the ring of (K tile, V tile) stages (the heads'
    columns back to back and one pad chunk)."""
    q_block = pack * 2 * (-(-d // 16)) * 128
    kv_block = (pack * d // 8 + 1) * 128
    return (PACKED_QT * PACKED_BQ // 8 * q_block
            + PACKED_STAGES * 2 * (PACKED_BK // 8) * kv_block)


def packed_launch_plan(b: int, h: int, s: int, d: int, pack: int) -> dict:
    """How the bf16 packed kernel is launched on [b, h, s, d] with ``pack``
    heads per block: one block per (192-query tile, batch, group), one
    warpgroup per head of the group (a ghost head's warpgroup only loads),
    three 64-row query sub-tiles served by each K/V tile of 64 keys x pack*d
    columns, the tiles in a ring of 3 stages beside the Q tile. A pack above
    ``max_pack(d)`` runs as smaller groups (the heads are independent).

    The source owns the geometry and launches by it alone; this is its
    mirror for planning and records without a card, and
    ``packed_kernel_plan`` is what the built library reports, which
    ``chip_smoke.py`` holds this against at every shape it runs."""
    pack = min(pack, max_pack(d))
    groups = -(-h // pack)
    rows = PACKED_QT * PACKED_BQ
    q_tiles = -(-s // rows)
    blocks = q_tiles * b * groups
    return {
        "pack": pack, "grid": (q_tiles, b * groups), "blocks": blocks, "groups": groups,
        "heads_per_group": [min(pack, h - g * pack) for g in range(groups)],
        "ghost_heads": groups * pack - h,
        "query_rows": rows, "sub_tiles": PACKED_QT,
        "warps": PACKED_WARPS_PER_HEAD * pack, "threads": 32 * PACKED_WARPS_PER_HEAD * pack,
        "warps_per_head": PACKED_WARPS_PER_HEAD, "stages": PACKED_STAGES,
        "key_tiles": -(-s // PACKED_BK),
        "smem_bytes": _packed_smem_bytes(pack, d),
        "waves": blocks / SM_COUNT,  # one block per SM at a time
    }


def packed_kernel_plan(b: int, h: int, s: int, d: int, pack: int) -> dict:
    """The bf16 launch geometry as the built library reports it (host code
    of ``csrc/packed_flash_attention.cu``, no launch), under
    ``packed_launch_plan``'s keys."""
    out = (ctypes.c_int * 10)()
    lib = _packed_lib()
    _raise(lib.c2d_cuda_error_string_packed,
           lib.c2d_packed_flash_plan(b, h, s, d, pack, ctypes.cast(out, ctypes.c_void_p)),
           "packed_flash_plan")
    kpack, groups, gx, gy, threads, smem, rows, sub_tiles, bk, stages = out
    return {"pack": kpack, "groups": groups, "grid": (gx, gy), "blocks": gx * gy,
            "threads": threads, "smem_bytes": smem, "query_rows": rows,
            "sub_tiles": sub_tiles, "key_tiles": -(-s // bk), "stages": stages}


# the per-head bf16 kernel's instances (csrc/flash_attention.cu: instance_d)
FLASH_INSTANCES = (16, 32, 40, 48, 64, 80, 96, 128, 160)
WIDE_D, WIDE_WARPGROUPS = 512, 4
# the warp-specialised design (csrc/flash_attention.cu: WS_*, ws_*): instances
# up to WS_MAX_D, a producer warpgroup and consumer warpgroups of 64 rows over
# a ring of 128-key tiles, the registers split by setmaxnreg
WS_MAX_D, WS_BK, WS_STAGES, WS_PRODUCER_REGS = 80, 128, 2, 24


def ws_consumers(inst: int) -> int:
    """Consumer warpgroups of the warp-specialised kernel: three up to
    instance 64, two at 80 (a third's registers would spill)."""
    return 3 if inst <= 64 else 2


def ws_consumer_regs(inst: int) -> int:
    """Registers a consumer thread holds after ``setmaxnreg``."""
    return 160 if inst <= 64 else 240


DESIGNS = ("ws", "narrow", "wide")  # c2d_flash_plan's design codes, in order


def flash_instance(d: int) -> int:
    """The head dim of the kernel instance that runs ``d``: d itself where
    the UNet or the VAE has it, else the next instance up (its columns past
    d are zeros in shared memory and never stored)."""
    return next((i for i in FLASH_INSTANCES if d <= i), WIDE_D)


def flash_design(d: int) -> str:
    """The bf16 kernel that runs head dim ``d``: ``"ws"`` (warp-specialised)
    up to instance 80, ``"narrow"`` up to 160, ``"wide"`` above."""
    inst = flash_instance(d)
    return "ws" if inst <= WS_MAX_D else "narrow" if inst < WIDE_D else "wide"


def _ws_smem_bytes(inst: int) -> int:
    """Q (64 rows a consumer) and the K and V rings (128 keys a tile), each
    row 128-byte swizzled blocks of 64 columns, then the mbarriers, and 1 KB
    to align the tiles to the swizzle's atoms."""
    atoms = -(-inst // 64)
    return ((64 * ws_consumers(inst) + 2 * WS_STAGES * WS_BK) * 128 * atoms
            + 8 * (1 + 4 * WS_STAGES) + 1024)


def flash_launch_plan(b: int, h: int, sq: int, sk: int, d: int) -> dict:
    """How the bf16 per-head forward is launched on q [b, h, sq, d] and k, v
    [b, h, sk, d]. ``ws`` (instances up to 80): one block per (64·c-query
    tile, batch·head), a producer warpgroup that copies 128-key K and V
    tiles by TMA into a ring of 2 stages and c consumer warpgroups
    (``ws_consumers``: 3 up to 64, 2 at 80), one per 64-row sub-tile, each
    holding its sub-tile's fp32 accumulator (instance d / 2 registers a
    thread), one block an SM. ``narrow`` (96 to 160): one block per
    (192-query tile, batch·head), three warpgroups, one per 64-row
    sub-tile, every 64-key K/V tile loaded once for the three into a ring of
    3 stages. ``wide`` (the VAE's 512): one block per (64-query tile,
    batch·head), four warpgroups that each compute S for 16 keys of a tile
    and O for 128 of the 512 columns (64 registers a thread), one K and one
    V buffer.

    The source owns the geometry and launches by it alone; this is its
    mirror for planning and records without a card, and ``flash_kernel_plan``
    is what the built library reports, which ``chip_smoke.py`` holds this
    against at every shape it runs."""
    inst = flash_instance(d)
    design = flash_design(d)
    if design == "ws":
        consumers = sub_tiles = ws_consumers(inst)
        rows, warpgroups = consumers * PACKED_BQ, 1 + consumers
        bk, stages, o_regs, smem = WS_BK, WS_STAGES, inst // 2, _ws_smem_bytes(inst)
    elif design == "wide":
        rows, sub_tiles, warpgroups, consumers = PACKED_BQ, 1, WIDE_WARPGROUPS, WIDE_WARPGROUPS
        bk, stages, o_regs = PACKED_BK, 2, 64
        qbs = WIDE_D // 8 * 128
        smem = (PACKED_BQ // 8 * qbs + 2 * (PACKED_BK // 8) * (WIDE_D // 8 + 1) * 128
                + PACKED_BQ // 8 * (PACKED_BK // 8 * 128) + WIDE_WARPGROUPS * PACKED_BQ * 4)
    else:
        rows, sub_tiles, warpgroups, consumers = PACKED_QT * PACKED_BQ, PACKED_QT, PACKED_QT, \
            PACKED_QT
        bk, stages, o_regs, smem = PACKED_BK, PACKED_STAGES, inst // 2, \
            _packed_smem_bytes(1, inst)
    q_tiles = -(-sq // rows)
    blocks = q_tiles * b * h
    return {
        "design": design, "instance_d": inst, "grid": (q_tiles, b * h), "blocks": blocks,
        "warpgroups": warpgroups, "consumers": consumers, "threads": 128 * warpgroups,
        "query_rows": rows, "sub_tiles": sub_tiles, "bk": bk, "stages": stages,
        "key_tiles": -(-sk // bk), "smem_bytes": smem, "o_regs": o_regs,
        "waves": blocks / SM_COUNT,  # blocks per SM over the launch
    }


def flash_kernel_plan(b: int, h: int, sq: int, sk: int, d: int) -> dict:
    """The bf16 launch geometry as the built library reports it (host code
    of ``csrc/flash_attention.cu``, no launch), under ``flash_launch_plan``'s
    keys."""
    out = (ctypes.c_int * 12)()
    lib = _lib()
    _raise(lib.c2d_cuda_error_string,
           lib.c2d_flash_plan(b, h, sq, sk, d, ctypes.cast(out, ctypes.c_void_p)), "flash_plan")
    inst, gx, gy, threads, smem, rows, sub_tiles, bk, stages, o_regs, design, consumers = out
    return {"design": DESIGNS[design], "instance_d": inst, "grid": (gx, gy),
            "blocks": gx * gy, "threads": threads, "smem_bytes": smem, "query_rows": rows,
            "sub_tiles": sub_tiles, "bk": bk, "stages": stages, "key_tiles": -(-sk // bk),
            "o_regs": o_regs, "consumers": consumers}


# the bf16 backward's instances (csrc/flash_attention_bwd.cu: instance_d)
FLASH_BWD_INSTANCES = (40, 80, 160)


def flash_bwd_instance(d: int) -> int:
    """The head dim of the backward instance that runs ``d``: the UNet's 40,
    80 and 160, else the next one up (its columns past d are zeros in
    shared memory and never stored). Refuses what the kernel does not take."""
    if d % 8 or not 8 <= d <= MAX_BWD_D:
        raise ValueError(f"flash backward: head dim must be a multiple of 8 in [8, "
                         f"{MAX_BWD_D}], got {d}")
    return next(i for i in FLASH_BWD_INSTANCES if d <= i)


def flash_bwd_launch_plan(b: int, h: int, sq: int, sk: int, d: int) -> dict:
    """How the bf16 backward is launched on q [b, h, sq, d] and k, v
    [b, h, sk, d]: a delta pre-pass (one warp a query row, 4 a block), then
    one launch whose grid row (one per batch·head) holds the dK/dV blocks,
    then the dQ blocks of that head. w warpgroups a block (3 up to instance
    80, else 2), one per 64-row sub-tile. A dK/dV block owns 64·w keys, each
    warpgroup holding its keys' dK and dV (instance d registers a thread);
    K and V are loaded once, Q and dO stream in 64-query tiles with their
    lse and delta through a 3-stage ring. A dQ block owns 64·w queries
    (instance d / 2 registers a thread); Q and dO are loaded once, K and V
    stream. The block's shared memory is the larger of the two roles'.

    The source owns the geometry and launches by it alone; this is its
    mirror for planning and records without a card, and
    ``flash_bwd_kernel_plan`` is what the built library reports, which
    ``chip_smoke.py`` holds this against at every shape it runs."""
    inst = flash_bwd_instance(d)
    wg = 3 if inst <= 80 else 2
    rows = PACKED_BQ * wg
    a_tile = rows // 8 * 2 * (-(-inst // 16)) * 128  # Q-tile layout: K, V or Q, dO
    kv_tile = PACKED_BK // 8 * (inst // 8 + 1) * 128  # K/V-tile layout, one stage's tile
    stats = 2 * PACKED_BQ * 4  # a dK/dV stage's lse and delta, fp32
    dkdv_smem = 2 * a_tile + PACKED_STAGES * (2 * kv_tile + stats)
    dq_smem = 2 * a_tile + PACKED_STAGES * 2 * kv_tile
    kv_x, q_x = -(-sk // rows), -(-sq // rows)
    return {
        "instance_d": inst, "delta_blocks": -(-b * h * sq * 32 // 128),
        "grid": (kv_x + q_x, b * h), "threads": 128 * wg,
        "smem_bytes": max(dkdv_smem, dq_smem), "stages": PACKED_STAGES,
        "dkdv_blocks_per_head": kv_x, "dkdv_rows": rows, "dkdv_acc_regs": inst,
        "dq_blocks_per_head": q_x, "dq_rows": rows, "dq_acc_regs": inst // 2,
        "warpgroups": wg, "blocks": (kv_x + q_x) * b * h,
        "dkdv_smem_bytes": dkdv_smem, "dq_smem_bytes": dq_smem,
        "query_tiles": -(-sq // PACKED_BQ), "key_tiles": -(-sk // PACKED_BK),
        "waves": (kv_x + q_x) * b * h / SM_COUNT,  # one block an SM
    }


def flash_bwd_kernel_plan(b: int, h: int, sq: int, sk: int, d: int) -> dict:
    """The bf16 backward's launch geometry as the built library reports it
    (host code of ``csrc/flash_attention_bwd.cu``, no launch), under
    ``flash_bwd_launch_plan``'s keys."""
    out = (ctypes.c_int * 13)()
    lib = _bwd_lib()
    _raise(lib.c2d_cuda_error_string_bwd,
           lib.c2d_flash_bwd_plan(b, h, sq, sk, d, ctypes.cast(out, ctypes.c_void_p)),
           "flash_bwd_plan")
    (inst, delta_blocks, gx, gy, threads, smem, stages, kv_x, kv_rows, kv_regs,
     q_x, q_rows, q_regs) = out
    return {"instance_d": inst, "delta_blocks": delta_blocks, "grid": (gx, gy),
            "threads": threads, "smem_bytes": smem, "stages": stages,
            "dkdv_blocks_per_head": kv_x, "dkdv_rows": kv_rows, "dkdv_acc_regs": kv_regs,
            "dq_blocks_per_head": q_x, "dq_rows": q_rows, "dq_acc_regs": q_regs}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, H, S, D]; differentiable. Takes the
    packed kernel where ``packed_eligible`` says so, else the per-head one."""
    if packed_eligible(q.shape, k.shape, q.is_cuda):
        d, h = q.shape[3], q.shape[1]
        return packed_flash_attention(q, k, v, scale, min(128 // d, h))
    if _needs_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, float(scale))
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, scale)
    return flash_attention_fwd(q, k, v, scale)[0]


def packed_flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float, pack: int, with_lse: bool = False
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the packed forward kernel on CUDA [B, H, S, D] tensors (any
    strides with a contiguous last dim): (out, lse). ``out`` lives in
    [B, S, H, D] storage, so its [B, S, H*D] view is free; ``lse`` is the
    fp32 [B, H, S] row log-sum-exp when ``with_lse``, else None."""
    _check(q, k, v, MAX_PACKED_D, "packed_flash_attention")
    b, h, s, d = q.shape
    if k.shape[2] != s:
        raise ValueError(f"packed_flash_attention: self-attention only, got Sq={s}, "
                         f"Sk={k.shape[2]}")
    if not 1 <= pack <= h:
        raise ValueError(f"packed_flash_attention: pack must be in [1, {h}], got {pack}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = _bshd_empty(b, h, s, d, q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _packed_lib()
    with torch.cuda.device(q.device):
        err = lib.c2d_packed_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, s, d, pack,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise(lib.c2d_cuda_error_string_packed, err, "packed_flash_attention")
    packed_flash_attention.launches += 1
    packed_flash_attention.shapes[(tuple(q.shape), pack, str(q.dtype))] += 1
    return out, lse


class PackedFlashAttentionFunction(torch.autograd.Function):
    """Differentiable packed attention over [B, H, S, D]: the packed kernel
    forward (with the log-sum-exp) and the per-head backward kernel on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, pack: int):
        if q.device.type == "cpu":
            out, lse = plain_packed_flash_attention(q, k, v, scale), None
        else:
            out, lse = packed_flash_attention_fwd(q, k, v, scale, pack, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.scale)
        return dq, dk, dv, None, None


def packed_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float, pack: int) -> torch.Tensor:
    """Self-attention over [B, H, S, D] with ``pack`` heads per kernel block
    (the JAX ``_packed_flash_fwd``); differentiable."""
    if _needs_grad(q, k, v):
        return PackedFlashAttentionFunction.apply(q, k, v, float(scale), int(pack))
    if q.device.type == "cpu":
        return plain_packed_flash_attention(q, k, v, scale)
    return packed_flash_attention_fwd(q, k, v, scale, pack)[0]


def packed_flash_nhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h: int, pack: int,
                     scale: float) -> torch.Tensor:
    """Self-attention on [B, S, H*D] projections without head transposes
    (the JAX ``packed_flash_nhd``): the kernel reads each head's columns in
    place and writes [B, S, H*D]; the backward runs on [B, H, S, D] views of
    the same storage."""
    b, s, hd = q.shape

    def heads(x):
        return x.unflatten(2, (h, hd // h)).transpose(1, 2)

    out = packed_flash_attention(heads(q), heads(k), heads(v), scale, pack)
    return out.transpose(1, 2).reshape(b, s, hd)


for _fn in (flash_attention, flash_attention_bwd, packed_flash_attention):
    counters.kernel(_fn)
flash_attention.designs = collections.Counter()
counters.register(flash_attention, "designs")
