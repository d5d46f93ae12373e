#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py            # from the repository root

Phases (each raises on failure, so the exit code is non-zero):
  1. Environment and build: the card's name and power limit, the nvcc builds
     of the five CUDA sources (flash-attention forward and backward, the
     head-packed forward, the Winograd conv, GroupNorm; one nvcc each, in
     parallel), timed. No kernel of the port is Triton. The opt-in flags
     C2D_PACKED_FLASH, C2D_WINOGRAD and C2D_INT8 are cleared; phases 3b and
     5b set C2D_PACKED_FLASH=1 for themselves only.
  2. A census UNet forward (CFG batch 2) and VAE decode at full SD v1.5
     geometry record the shapes the serving path gives each kernel; then
     every kernel is held against its plain PyTorch version at each of those
     shapes, in bf16 and fp32, plus ragged sequence lengths, launched twice
     (same bits), its Python launch plan held against the built library's,
     and timed beside its roofline bound and one PyTorch library call: on
     the host's pace (``kernel_ms``, back-to-back calls) and on the device's
     (``device_ms``, one call's share of a CUDA graph of 20, which also shows
     that the kernel can be captured).
  2b. A census stage-2 micro-step (batch 4) and stage-3 micro-step (batch 2)
     record the training path's shapes; the flash-attention backward kernel
     is held against its plain version at each (bf16 and fp32) and at ragged
     shapes (Sq != Sk, S off the tile, d = 8, 16, 64 and 120, the last two on
     the next instance up), run twice for bit-identical results, its Python
     launch plan held against the built library's, and timed beside its
     bound and its ex2 floor (both computed, and the floor logged per shape
     and per micro-step, not in the kernels line), the plain version and
     autograd through
     ``scaled_dot_product_attention``: host-paced and as device time (a CUDA
     graph of the kernel, and of ``torch.autograd.grad`` on a captured SDPA
     output). A forward that writes the log-sum-exp must give the same bits
     as one that does not.
     The GroupNorm Functions' gradients are held against autograd of
     ``plain_group_norm``, and the GroupNorm kernels against their plain
     version at the training shapes.
  2c. The head-packed forward kernel: a census of the packed route's shapes
     (one UNet forward and one stage-2/3 micro-step each under
     C2D_PACKED_FLASH=1), then the kernel against its plain version at each
     ([B, S, H*D] inputs, bf16 and fp32) and at ragged cases (a ghost head,
     pack 4, pack 2, S off the tile, S shorter than one key tile, every
     head dim from 8 to 64, all at B = 1), the Python launch plan against
     the built library's, a second launch (same bits), the [B, H, S, D]
     entry against the strided one (same bits), the log-sum-exp against torch.logsumexp and the
     backward through the Function against autograd of the plain version;
     timed beside its bound, the plain version, the per-head kernel on the
     same data and SDPA on the [B, H, S, D] view.
  2d. The Winograd kernel (wired into no model, as in the JAX package): at
     the census of the UNet's Conv3x3 shapes (batch 2) that ``eligible``
     takes and at tools/bench_wino_pallas.py's shapes, against its plain
     version and against a direct conv (cuDNN, TF32 off), bf16 and fp32,
     launched twice (same bits: the sum over splits of the Cin loop is
     ordered), its filter transform against the step-by-step plain one,
     the Python launch plan against the built library's, timed beside its
     bound, the plain version and cuDNN ``F.conv2d``;
     untimed ragged shapes at the design's edges (fewer tiles than a block's
     rows, one 16-channel step, Cin 48 and 112, Cout 8, 24, 72 and 136,
     B = 1 with H != W, a Cin loop that its split does not divide); its
     entry point driven over one UNet forward's census with counts reset;
     and one full-width UNet forward with C2D_WINOGRAD=1 (the plain-PyTorch
     route) against the direct conv.
  2e. The VAE encoder (img2img and inpainting): a census of one encode at
     batch 1 (1 flash, 21 GN+SiLU, 1 GN launches; kept out of phase 2's
     census, whose sums the records compare), then the flash and GroupNorm
     kernels against their plain versions at its shapes, bf16 and fp32, the
     GroupNorm plan against the library's and timed, from a generator of its
     own; the worst errors fold into the kernels line.
  3. The serving path: 3 requests through ``AudioToImagePipeline.generate``
     (hierarchical, 50-step DDIM, CFG 7.5, 512x512, bf16 weights drawn from
     a seeded torch.Generator, a 10 s 48 kHz synthetic waveform, hash
     tokenizer ids). Counts are reset just before and read just after: each
     request must launch flash 751 times and group_norm_silu 2,279 times.
  3b. Serving under C2D_PACKED_FLASH=1: one full-width UNet forward with the
     route on and off on the same inputs (bf16, and an fp32 copy), then 2
     requests with the flag set, each with exactly 250 packed, 501 per-head
     flash and 2,279 GN+SiLU launches, interleaved with 2 requests without it
     (751 per-head, no packed launch) for a wall-time comparison.
  3c. The rest of ``generate`` at full width with phase 3's pipeline,
     waveform and prompt: ``sonic``; ``dpmpp_2m_karras`` at 20 steps;
     ``euler_a``; img2img from phase 3's first image at strength 0.6;
     inpainting (strength 1.0, the left half masked); two-audio mixing;
     ``seeds=[7, 5]`` at batch 2. Counts are reset before the phase, and
     each request's wall time and exact launches (flash, GN+SiLU, GN) are
     checked against GENERATE_REQUESTS. Then: sonic differs from
     hierarchical; an all-255 mask gives img2img's bits; a lane's initial
     latents are its seed's solo draw; ``generate_stream(depth=2)`` gives
     the bits of three ``generate`` calls (timed in turns: calls, stream,
     stream, calls); the image differences of
     ``seeds=[5, 5]``'s lanes and of solo ``seeds=[5]`` against lane 1 of
     ``[7, 5]`` are recorded; and each kernel is checked (untimed) at every
     shape of the phase that no earlier phase checked.
  4. Reference check: a small configuration (flash and GroupNorm kernels
     on) in fp32 on the card against the same pipeline on the CPU (plain
     versions), under the frozen-golden bounds of tests/test_image_golden.py.
  5. The training path at full width: ``run_stage(Config(), 2, ...)`` on a
     fixture dataset (8 samples of 10 s at 48 kHz, [4, 64, 64] latents),
     random seeded fp32 master weights with bf16 compute, batch 4, grad
     accumulation 4, 16 micro-steps (4 updates); then 2 micro-steps of
     stage 3. Counts are reset just before each and read per micro-step.
  5b. Stage-2 training under C2D_PACKED_FLASH=1: 4 micro-steps, each with
     exactly 5 packed forwards, 10 per-head forwards and 14 backwards, 4 of
     them the packed route's at [4, 8, 4096, 40].
  6. Small training reference: one stage-2 micro-step of the small
     configuration in fp32 on the card (TF32 off, kernels on) against the
     same step on the CPU: loss and the gradient of every trainable leaf.

Timing: CUDA events around repeated launches after a warm-up (inputs stay
in L2 where they fit, as they do on the path, where the producer just wrote
them): ``*_ms`` back to back from Python, so at small shapes the host's cost
per call; ``*device_ms`` (phases 2 and 2b) from a CUDA graph of 20 calls
(``utils/timing.py``), the device's. Bounds use the H100 SXM data-sheet
rates: 989 TFLOP/s bf16 tensor, 67 TFLOP/s fp32, 3.35 TB/s HBM3. The line
before the last two is the ``kernels`` JSON: the forward, packed-forward and
GroupNorm times are per image (sum over the serving path's calls of one
image), the backward's per
stage-2 micro-step, the Winograd kernel's per UNet forward over the eligible
census shapes (with per-call rows at the bench shapes). The last line is
the device JSON.
"""

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline, RequestDraws
from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer
from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset
from clap2diffusion_tpu_torch.ops import cuda_build
from clap2diffusion_tpu_torch.ops import flash_attention as fa
from clap2diffusion_tpu_torch.ops import groupnorm as gn
from clap2diffusion_tpu_torch.ops import winograd as wino
from clap2diffusion_tpu_torch.ops import winograd_pallas as wp
from clap2diffusion_tpu_torch.train import stages as S
from clap2diffusion_tpu_torch.train import trainer as T
from clap2diffusion_tpu_torch.utils.timing import graph_ms, sdpa_backward_device_ms

PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# kernel vs plain: |k - p| <= atol + rtol*|p|. bf16: both outputs are
# rounded to bf16 (2^-8 relative, one ulp apart at most where the fp32
# values straddle a rounding boundary), and the online softmax rounds P to
# bf16 against the running max, not the final one; fp32: summation order.
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
# backward kernel vs plain, per tensor: |k - p| <= atol*max|p| + rtol*|p|.
# bf16: the kernel rounds P and dS to bf16 before its products as the plain
# version does, but P is rebuilt from exp2 of fp32 logits in another order,
# so a value near a rounding boundary may round the other way (2^-8), and
# each output is rounded to bf16 once; fp32: summation order over Sq or Sk
# terms (the largest error seen is ~1e-6 of max|p|).
BWD_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
REQUESTS = 3
FLASH_PER_IMAGE = 751
GN_SILU_PER_IMAGE = 2279
# Under C2D_PACKED_FLASH=1 the 5 self-attentions at 4096 tokens (8 heads of
# d=40, pack 3) of each of the 50 CFG UNet forwards take the packed kernel.
PACKED_PER_FORWARD = 5
PACKED_PER_IMAGE = 50 * PACKED_PER_FORWARD
PACKED_REQUESTS = 2
PACKED_TRAIN_STEPS = 4
# Winograd kernel vs its plain version, per tensor: |k - p| <= atol*max|p| +
# rtol*|p|. bf16: V and U are the same bits in both; the fp32 sums of the
# 16 products run in another order, so the output cast and then the bias
# added in bf16 may each round the other way (2^-8). fp32: summation order.
WINO_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
# Winograd vs a direct conv (cuDNN, TF32 off), atol*max|direct|: bf16 rounds
# V = BT d BT^T and U = G w G^T to bf16 where the direct conv rounds only x and
# w (about 5e-3 of the output scale); fp32: the transforms' rounding.
DIRECT_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-3}
# A full-width UNet forward (CFG batch 2) with an opt-in route on against the
# same forward with it off, on the same inputs, max |err| of max|eps|. fp32
# (TF32 off) checks the route: the kernels' and transforms' fp32 rounding.
# bf16: every bf16 layer after the first changed op rounds again, so a
# per-element difference of one ulp compounds through the net: an H100 run
# measured 1.8e-2 (packed attention) and 2.4e-2 (Winograd convs) of
# max|eps| in bf16 against 4.3e-6 and 3.8e-6 in fp32.
UNET_ROUTE_TOL = {torch.bfloat16: 6e-2, torch.float32: 1e-4}
# edges of the Winograd kernel's design, untimed: (x shape, Cout)
RAGGED_WINO_SHAPES = [((2, 4, 6, 32), 16), ((1, 2, 2, 16), 8), ((1, 6, 10, 48), 24),
                      ((2, 8, 8, 80), 72), ((1, 4, 4, 112), 8), ((1, 10, 6, 208), 136),
                      ((2, 16, 16, 1904), 1280)]
BENCH_WINO_SHAPES = [((2, 64, 64, 320), 320), ((2, 32, 32, 640), 640),
                     ((16, 64, 64, 320), 320)]  # tools/bench_wino_pallas.py:54-58
FLAGS = ("C2D_PACKED_FLASH", "C2D_WINOGRAD", "C2D_INT8")
# Per training micro-step (stages 2 and 3): 15 flash forwards (5 at each of
# 4096, 1024 and 256 tokens) and 14 backwards. The first self-attention of
# down block 0 comes before any trainable leaf (its input depends only on
# the noisy latent, the timestep and frozen weights), so no input of it
# requires grad: it launches the forward kernel alone and autograd never
# asks for its backward. Every later self-attention sits after a
# cross-attention whose context carries the trainable injection branch (in
# stage 3: the routed tokens, through the decomposer's
# cross_hierarchy_attn.output_proj, which the JAX stage-3 predicate's
# "output_proj" substring selects), so it is differentiated.
FLASH_FWD_PER_STEP = 15
FLASH_BWD_PER_STEP = 14
TRAIN_STEPS = 16
STAGE3_STEPS = 2
TRAIN_REL_TOL = 1e-3  # small fp32 training step: card vs CPU, per leaf (of max|cpu|)
# Phase 3c: launches (flash, GN+SiLU, GN) per request. A UNet forward makes
# 15, 45 and 16, the VAE decoder 1, 29 and 1, the encoder (img2img) 1, 21
# and 1; a batch of 2 makes as many launches as a batch of 1.
GENERATE_REQUESTS = {
    "sonic": (dict(model_type="sonic", num_steps=50), (751, 2279, 801)),
    "dpmpp_2m_karras": (dict(sampler="dpmpp_2m_karras", num_steps=20), (301, 929, 321)),
    "euler_a": (dict(sampler="euler_a", num_steps=50), (751, 2279, 801)),
    "img2img": (dict(strength=0.6, num_steps=50), (452, 1400, 482)),  # 30 steps
    "inpainting": (dict(strength=1.0, num_steps=50), (752, 2300, 802)),
    "audio_mix": (dict(audio_mix=0.5, num_steps=50), (751, 2279, 801)),
    "seeds": (dict(seeds=[7, 5], batch=2, num_steps=50), (751, 2279, 801)),
}
STREAM_STEPS = 10  # generate_stream against generate: three requests of 10 steps


class FedLatents(RequestDraws):
    """A request's draws with its initial latents given."""

    def __init__(self, device, latents):
        super().__init__(device, 0)
        self.fed = latents.to(self.device)

    def latents(self, shape):
        return self.fed


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def smi(query="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Mean ms of one call, by CUDA events over a run of calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = int(min(50, max(3, 0.05 / max(time.perf_counter() - t0, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(name, got, ref, dtype):
    atol, rtol = TOL[dtype]
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max |err| "
                             f"{err.max().item():.3g} (atol {atol}, rtol {rtol})")
    return err.max().item()


def bound_ms(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def flash_case(qs, ks, dtype, gen, timed=True):
    q = torch.randn(qs, device="cuda", generator=gen).to(dtype)
    k = torch.randn(ks, device="cuda", generator=gen).to(dtype)
    v = torch.randn(ks, device="cuda", generator=gen).to(dtype)
    scale = qs[-1] ** -0.5
    name = f"flash {list(qs)} k{list(ks)} {str(dtype)[6:]}"
    b, h, sq, d = qs
    sk = ks[2]
    if dtype == torch.bfloat16:  # the plan the records use against the library's own
        plan, built = fa.flash_launch_plan(b, h, sq, sk, d), fa.flash_kernel_plan(b, h, sq, sk, d)
        if any(plan[key] != val for key, val in built.items()):
            raise AssertionError(f"{name}: flash_launch_plan {plan} is not the library's {built}")
    got = fa.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    if not torch.equal(fa.flash_attention(q, k, v, scale), got):
        raise AssertionError(f"{name}: two identical launches differ")
    err = check(name, got, fa.plain_flash_attention(q, k, v, scale), dtype)
    # the UNet's layout: heads of a [B, S, H*D] projection, read through strides
    strided = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    if not torch.equal(fa.flash_attention(*strided, scale), got):
        raise AssertionError(f"{name}: strided [B,S,H,D] inputs give another result")
    if not timed:
        row = {"kernel": "flash_attention_fwd", "q": list(qs), "k": list(ks),
               "dtype": str(dtype)[6:], "max_abs_err": err}
        log(row)
        return row
    bms, by = bound_ms(4 * b * h * sq * sk * d, 2 * b * h * (sq + sk) * d * q.element_size(),
                       dtype)
    kernel = lambda: fa.flash_attention(q, k, v, scale)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
    row = {"kernel": "flash_attention_fwd", "q": list(qs), "k": list(ks),
           "dtype": str(dtype)[6:], "max_abs_err": err,
           "kernel_ms": time_ms(kernel), "device_ms": graph_ms(kernel),
           "plain_ms": time_ms(lambda: fa.plain_flash_attention(q, k, v, scale)),
           "library_ms": time_ms(library), "library_device_ms": graph_ms(library),
           "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by}
    if dtype == torch.bfloat16:
        row.update({k: plan[k] for k in ("blocks", "threads", "smem_bytes", "o_regs")})
    log(row)
    return row


def gn_case(kind, shape, dtype, groups, eps, gen, timed=True):
    silu = kind == "group_norm_silu"
    x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    c = shape[-1]
    w = (torch.randn(c, device="cuda", generator=gen) * 0.1 + 1).to(dtype)
    b = (torch.randn(c, device="cuda", generator=gen) * 0.1).to(dtype)
    fn = gn.group_norm_silu if silu else gn.group_norm
    name = f"{kind} {list(shape)} {str(dtype)[6:]} eps={eps}"
    plan = gn.launch_plan(tuple(shape), dtype, groups, gn.device_capacity(0))
    built = gn.kernel_plan(shape, dtype, groups)
    if any(plan[key] != val for key, val in built.items()):
        raise AssertionError(f"{name}: launch_plan {plan} is not the library's {built}")
    launches = fn.launches
    got = fn(x, w, b, groups, eps)
    torch.cuda.synchronize()
    if fn.launches != launches + 1:
        raise AssertionError(f"{name}: one call made {fn.launches - launches} launches")
    if not torch.equal(fn(x, w, b, groups, eps), got):
        raise AssertionError(f"{name}: two identical launches differ")
    err = check(name, got, gn.plain_group_norm(x, w, b, groups, eps, silu), dtype)
    if not timed:
        row = {"kernel": kind, "x": list(shape), "dtype": str(dtype)[6:], "eps": eps,
               "max_abs_err": err, "grid": plan["grid"], "resident": plan["resident"],
               "x_reads": plan["x_reads"]}
        log(row)
        return row
    nchw = x.permute(0, 3, 1, 2)  # channels_last view: the same memory
    n = x.numel()
    bms, by = bound_ms((9 if silu else 5) * n, (2 * n + 2 * c) * x.element_size(),
                       torch.float32)
    kernel = lambda: fn(x, w, b, groups, eps)  # noqa: E731
    library = lambda: F.group_norm(nchw, groups, w, b, eps)  # noqa: E731
    row = {"kernel": kind, "x": list(shape), "dtype": str(dtype)[6:], "eps": eps,
           "max_abs_err": err, "kernel_ms": time_ms(kernel), "device_ms": graph_ms(kernel),
           "plain_ms": time_ms(lambda: gn.plain_group_norm(x, w, b, groups, eps, silu)),
           "library_ms": None, "library_device_ms": None, "bound_ms": bms,
           "bound_us": bms * 1e3, "bound_by": by, "grid": plan["grid"],
           "resident": plan["resident"], "x_reads": plan["x_reads"]}
    if silu:  # no single PyTorch call computes GN+SiLU; two calls, for scale
        two = lambda: F.silu(library())  # noqa: E731
        row.update({"group_norm_then_silu_ms": time_ms(two),
                    "group_norm_then_silu_device_ms": graph_ms(two)})
    else:
        row.update({"library_ms": time_ms(library), "library_device_ms": graph_ms(library)})
    log(row)
    return row


def lse_case(q, k, v, scale, name):
    """The forward with a log-sum-exp output: the same output bits as
    without, and the row log-sum-exp of the fp32 logits (|err| <= 1e-4 *
    (1 + |lse|): fp32 exp2/log against torch.logsumexp)."""
    o, lse = fa.flash_attention_fwd(q, k, v, scale, with_lse=True)
    if not torch.equal(o, fa.flash_attention_fwd(q, k, v, scale)[0]):
        raise AssertionError(f"{name}: the forward with lse gives other output bits")
    ref = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, -1)
    err = (lse - ref).abs()
    if not (err <= 1e-4 * (1 + ref.abs())).all():
        raise AssertionError(f"{name}: lse off by {err.max().item():.3g}")
    return o, lse, err.max().item()


def bwd_case(qs, ks, dtype, gen, timed=True, ex2_per_s=None):
    """The backward kernel against its plain version at one shape."""
    q, k, v, do = (torch.randn(sh, device="cuda", generator=gen).to(dtype)
                   for sh in (qs, ks, ks, qs))
    scale = qs[-1] ** -0.5
    name = f"flash_bwd {list(qs)} k{list(ks)} {str(dtype)[6:]}"
    plan = fa.flash_bwd_launch_plan(*qs[:3], ks[2], qs[3])
    built = fa.flash_bwd_kernel_plan(*qs[:3], ks[2], qs[3])
    if any(plan[key] != val for key, val in built.items()):
        raise AssertionError(f"{name}: flash_bwd_launch_plan {plan} is not the library's {built}")
    o, lse, lse_err = lse_case(q, k, v, scale, name)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two identical calls differ")
    ref = fa.plain_flash_attention_bwd(q, k, v, o, do, scale)
    atol, rtol = BWD_TOL[dtype]
    errs = []
    for part, a, b in zip(("dq", "dk", "dv"), got, ref):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} {part}: non-finite kernel output")
        err = (a - b).abs()
        bad = err > atol * b.abs().max() + rtol * b.abs()
        if bad.any():
            raise AssertionError(f"{name} {part}: {int(bad.sum())} elements off, max |err| "
                                 f"{err.max().item():.3g} of max|p| {b.abs().max().item():.3g}")
        errs.append(err.max().item())
    row = {"kernel": "flash_attention_bwd", "q": list(qs), "k": list(ks),
           "dtype": str(dtype)[6:], "max_abs_err": max(errs), "lse_err": lse_err,
           "rel_err": [e / max(r.float().abs().max().item(), 1e-30) for e, r in zip(errs, ref)]}
    if timed:
        b, h, sq, d = qs
        sk = ks[2]
        nbytes = b * h * (4 * sq + 4 * sk) * d * q.element_size() + 2 * b * h * sq * 4
        bms, by = bound_ms(10 * b * h * sq * sk * d, nbytes, dtype)
        qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        kernel = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, scale)  # noqa: E731
        row.update({
            "kernel_ms": time_ms(kernel), "device_ms": graph_ms(kernel),
            "plain_ms": time_ms(lambda: fa.plain_flash_attention_bwd(q, k, v, o, do, scale)),
            "library_ms": time_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                              retain_graph=True)),
            "library_device_ms": sdpa_backward_device_ms(q, k, v, do, scale),
            "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by,
            # the design's exponentials, two a logit (one in each role), at the
            # special-function units' rate; beside the bound, not in its place
            "ex2_floor_ms": 2 * b * h * sq * sk / ex2_per_s * 1e3,
            "grid": list(plan["grid"]), "threads": plan["threads"],
            "smem_bytes": plan["smem_bytes"]})
        del lib_out
    log(row)
    return row


def gn_grad_case(kind, shape, dtype, groups, eps, gen):
    """The GroupNorm Function's gradients against autograd of the plain
    version (its backward is that recompute, as in the JAX package), and
    the backward's time."""
    silu = kind == "group_norm_silu"
    fn = gn.group_norm_silu if silu else gn.group_norm
    c = shape[-1]
    x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    w = (torch.randn(c, device="cuda", generator=gen) * 0.1 + 1).to(dtype)
    b = (torch.randn(c, device="cuda", generator=gen) * 0.1).to(dtype)
    gy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = fn(*ins, groups, eps)
    got = torch.autograd.grad(y, ins, gy, retain_graph=True)
    ref_ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
    ref = torch.autograd.grad(gn.plain_group_norm(*ref_ins, groups, eps, silu), ref_ins, gy)
    name = f"{kind} grad {list(shape)} {str(dtype)[6:]}"
    errs = [check(f"{name} d{p}", a, r, dtype) for p, a, r in zip(("x", "w", "b"), got, ref)]
    row = {"kernel": f"{kind}_backward (plain recompute)", "x": list(shape),
           "dtype": str(dtype)[6:], "max_abs_err": max(errs),
           "backward_ms": time_ms(lambda: torch.autograd.grad(y, ins, gy, retain_graph=True))}
    log(row)
    return row


KERNEL_FNS = (fa.flash_attention, fa.flash_attention_bwd, fa.packed_flash_attention,
              gn.group_norm_silu, gn.group_norm, wp.conv3x3_winograd_pallas)


def reset_counts():
    for fn in KERNEL_FNS:
        fn.launches = 0
        fn.shapes.clear()


def counts():
    return {fn.__name__: fn.launches for fn in KERNEL_FNS}


@contextlib.contextmanager
def flag(name):
    """``name=1`` in the environment for the block only (the port reads the
    opt-in flags per call)."""
    os.environ[name] = "1"
    try:
        yield
    finally:
        os.environ.pop(name)


def packed_case(b, s, h, d, dtype, gen, timed=True):
    """The packed kernel against its plain version at one [B, S, H*D] shape:
    the output (nhd entry), the [B, H, S, D] entry (same bits), the
    log-sum-exp, and the backward through the Function against autograd of
    the plain version."""
    pack = min(128 // d, h)
    q, k, v, do = (torch.randn(b, s, h * d, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    scale = d ** -0.5
    name = f"packed_flash [{b},{s},{h}x{d}] pack {pack} {str(dtype)[6:]}"

    def heads(x):
        return x.unflatten(2, (h, d)).transpose(1, 2)

    if dtype == torch.bfloat16:  # the plan the records use against the library's own
        plan = fa.packed_launch_plan(b, h, s, d, pack)
        built = fa.packed_kernel_plan(b, h, s, d, pack)
        if any(plan[key] != val for key, val in built.items()):
            raise AssertionError(f"{name}: packed_launch_plan {plan} is not the library's "
                                 f"{built}")
    got = fa.packed_flash_nhd(q, k, v, h, pack, scale)
    torch.cuda.synchronize()
    if not torch.equal(fa.packed_flash_nhd(q, k, v, h, pack, scale), got):
        raise AssertionError(f"{name}: two identical launches differ")
    ref = fa.plain_packed_flash_attention(heads(q), heads(k), heads(v), scale)
    err = check(name, heads(got), ref, dtype)
    dense = [heads(t).contiguous() for t in (q, k, v)]  # [B, H, S, D] storage
    if not torch.equal(fa.packed_flash_attention(*dense, scale, pack), heads(got)):
        raise AssertionError(f"{name}: the [B,H,S,D] entry gives other bits than [B,S,H*D]")
    o, lse = fa.packed_flash_attention_fwd(heads(q), heads(k), heads(v), scale, pack,
                                           with_lse=True)
    if not torch.equal(o, heads(got)):
        raise AssertionError(f"{name}: the forward with lse gives other output bits")
    lse_ref = torch.logsumexp(torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2))
                              * scale, -1)
    lse_err = (lse - lse_ref).abs()
    if not (lse_err <= 1e-4 * (1 + lse_ref.abs())).all():
        raise AssertionError(f"{name}: lse off by {lse_err.max().item():.3g}")
    ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.packed_flash_nhd(*ins, h, pack, scale)
    grads = torch.autograd.grad(out, ins, do)
    ref_ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ref_out = fa.plain_packed_flash_attention(*(heads(t) for t in ref_ins), scale)
    ref_grads = torch.autograd.grad(ref_out, ref_ins, heads(do))
    atol, rtol = BWD_TOL[dtype]
    bwd_errs = []
    for part, a, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        a, r = a.float(), r.float()
        e = (a - r).abs()
        if not torch.isfinite(a).all() or (e > atol * r.abs().max() + rtol * r.abs()).any():
            raise AssertionError(f"{name} {part}: max |err| {e.max().item():.3g} of max|p| "
                                 f"{r.abs().max().item():.3g}")
        bwd_errs.append(e.max().item() / max(r.abs().max().item(), 1e-30))
    row = {"kernel": "packed_flash_attention_fwd", "x": [b, s, h * d], "heads": h, "d": d,
           "pack": pack, "dtype": str(dtype)[6:], "max_abs_err": err,
           "lse_err": lse_err.max().item(), "bwd_rel_err": bwd_errs}
    if timed:
        qh, kh, vh = heads(q), heads(k), heads(v)
        bms, by = bound_ms(4 * b * h * s * s * d, 4 * b * s * h * d * q.element_size(), dtype)
        row.update({
            "kernel_ms": time_ms(lambda: fa.packed_flash_nhd(q, k, v, h, pack, scale)),
            "plain_ms": time_ms(lambda: fa.plain_packed_flash_attention(qh, kh, vh, scale)),
            "per_head_ms": time_ms(lambda: fa.flash_attention_fwd(qh, kh, vh, scale)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                         scale=scale)),
            "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by})
    log(row)
    return row


def wino_case(x_shape, cout, dtype, gen, timed=True):
    """The Winograd kernel against its plain version and a direct conv at
    one shape (HWIO weights ~ N(0, 1/(9 Cin)), a bias)."""
    cin = x_shape[-1]
    x = torch.randn(x_shape, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(3, 3, cin, cout, device="cuda", generator=gen) / (9 * cin) ** 0.5).to(dtype)
    bias = (torch.randn(cout, device="cuda", generator=gen) * 0.1).to(dtype)
    name = f"winograd {list(x_shape)}->{cout} {str(dtype)[6:]}"
    got = wp.conv3x3_winograd_pallas(x, w, bias)
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if not torch.equal(wp.conv3x3_winograd_pallas(x, w, bias), got):
        raise AssertionError(f"{name}: two identical launches differ")
    # the filter-transform kernel against its step-by-step plain version: the
    # same fp32 sums in the same order, so the same bits after the one cast
    u = wp.winograd_filter(w, dtype)
    if not torch.equal(u, wp.filter_transform_steps(w).to(dtype)):
        raise AssertionError(f"{name}: the filter transform gives other bits than "
                             f"filter_transform_steps")
    ref = wp.plain_conv3x3_winograd_pallas(x, w, bias).float()
    atol, rtol = WINO_TOL[dtype]
    err = (got.float() - ref).abs()
    if (err > atol * ref.abs().max() + rtol * ref.abs()).any():
        raise AssertionError(f"{name}: max |err| {err.max().item():.3g} vs plain, max|p| "
                             f"{ref.abs().max().item():.3g}")
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    nchw = x.permute(0, 3, 1, 2)  # channels_last view: the same memory
    direct = F.conv2d(nchw, w_oihw, bias, padding=1).permute(0, 2, 3, 1).float()
    derr = (got.float() - direct).abs().max().item() / direct.abs().max().item()
    if derr > DIRECT_TOL[dtype]:
        raise AssertionError(f"{name}: {derr:.3g} of max|direct| off the direct conv")
    plan = wp.launch_plan(x_shape, cout, dtype)
    built = wp.kernel_plan(x_shape, cout, dtype, plan["split"])
    if any(plan[key] != val for key, val in built.items()):
        raise AssertionError(f"{name}: launch_plan {plan} is not the library's {built}")
    row = {"kernel": "winograd_conv3x3", "x": list(x_shape), "cout": cout,
           "dtype": str(dtype)[6:], "grid": list(plan["grid"]), "blocks": plan["blocks"],
           "max_abs_err": err.max().item(),
           "rel_err_vs_plain": err.max().item() / ref.abs().max().item(),
           "rel_err_vs_direct": derr}
    if timed:
        b, h, wd, _ = x_shape
        nbytes = (b * h * wd * cin + 9 * cin * cout + b * h * wd * cout) * x.element_size()
        bms, by = bound_ms(8 * b * h * wd * cin * cout, nbytes, dtype)
        row.update({
            "kernel_ms": time_ms(lambda: wp.winograd_conv_fwd(x, u, bias)),
            "entry_ms": time_ms(lambda: wp.conv3x3_winograd_pallas(x, w, bias)),
            "filter_ms": time_ms(lambda: wp.winograd_filter(w, dtype)),
            "plain_ms": time_ms(lambda: wp.plain_conv3x3_winograd_pallas(x, w, bias)),
            "library_ms": time_ms(lambda: F.conv2d(nchw, w_oihw, bias, padding=1)),
            "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by})
    log(row)
    return row


def unet_route_check(unet, args, flag_name):
    """One UNet forward with ``flag_name`` set against one without, on the
    same inputs, in bf16 (``unet`` as served) and in fp32 (a copy, TF32
    off): {dtype: max |err| / max|eps|}; raises past ``UNET_ROUTE_TOL``."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        net = unet if dtype == torch.bfloat16 else copy.deepcopy(unet).float()
        cast = [a.to(dtype) if a.is_floating_point() else a for a in args[:3]]
        audio = {k: v.to(dtype) for k, v in args[3].items()}
        with torch.inference_mode():
            off = net(*cast, audio).float()
            with flag(flag_name):
                on = net(*cast, audio).float()
        err = ((on - off).abs().max() / off.abs().max()).item()
        out[str(dtype)[6:]] = err
        if not torch.isfinite(on).all() or err > UNET_ROUTE_TOL[dtype]:
            raise AssertionError(f"UNet under {flag_name}=1, {dtype}: {err:.3g} of max|eps| "
                                 f"off the forward without it (tolerance "
                                 f"{UNET_ROUTE_TOL[dtype]})")
        del net, on, off
    torch.cuda.empty_cache()
    return out


def conv3x3_census(unet):
    """Forward pre-hooks on every ``Conv3x3`` of ``unet`` that count the
    (x shape, Cout) each call sees; returns the counter and the hooks."""
    seen = {}

    def hook(mod, args):
        key = (tuple(args[0].shape), mod.out_channels)
        seen[key] = seen.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in unet.modules()
               if isinstance(m, wino.Conv3x3)]
    return seen, handles


def random_batch(cfg, b, gen):
    """A stage batch drawn from ``gen`` on its device."""
    device = gen.device
    lat = cfg.diffusion.image_size // 8
    u, c = cfg.diffusion.unet, cfg.condition
    return {"clap": torch.randn(b, c.clap_dim, device=device, generator=gen),
            "latent": torch.randn(b, lat, lat, 4, device=device, generator=gen),
            "text_ctx": torch.randn(b, cfg.diffusion.clip_text.max_length,
                                    u.cross_attention_dim, device=device, generator=gen),
            "text_emb": torch.randn(b, c.token_dim, device=device, generator=gen)}


def training_census(cfg, params, gen):
    """One micro-step of stage 2 (batch 4) and of stage 3 (batch 2) through
    the stage objects, with counts reset: the shapes the training path
    gives each kernel."""
    census = {}
    for number, batch in ((2, cfg.train.stage2.batch_size), (3, cfg.train.stage3.batch_size)):
        st = S.MAKE_STAGE[number](cfg)
        state = st.create_state({tw: {n: t.detach().clone() for n, t in params[tw].items()}
                                 for tw in st.towers})
        reset_counts()
        total, _ = st.loss(state, random_batch(cfg, batch, gen), gen)
        S.grads_of(total, state.trainable_leaves())
        torch.cuda.synchronize()
        census[number] = {fn.__name__: dict(fn.shapes) for fn in KERNEL_FNS}
        census[number]["counts"] = counts()
        del state, total
    torch.cuda.empty_cache()
    return census


def waveform(seconds=10.0, sr=48_000, seed=0):
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    wav = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 97 * t * (1 + t / 20))
           + 0.05 * rng.normal(size=t.shape))
    return (wav / np.abs(wav).max()).astype(np.float32)


def small_config():
    """tests/test_pipeline.py::tiny_config at 128x128 with flash on: 256
    latent tokens reach both kernels (UNet d=8, VAE d=16)."""
    return C.Config(
        clap=C.CLAPConfig(
            frontend=C.AudioFrontendConfig(num_mel_bins=16, duration_s=0.5),
            audio=C.HTSATConfig(spec_size=64, num_mel_bins=16, patch_embed_dim=8,
                                depths=(1, 1), num_heads=(2, 2), window_size=4,
                                hidden_size=16, projection_dim=32),
            embed_dim=32),
        condition=C.ConditionConfig(
            clap_dim=32, token_dim=48, num_tokens=4, num_output_tokens=7,
            num_adapter_tokens=4, hierarchy_bottleneck=24, hierarchy_heads=2,
            projector_bottleneck=16, projector_heads=2, projector_layers=1),
        diffusion=C.DiffusionConfig(
            unet=C.UNetConfig(block_out_channels=(16, 32, 32, 32), layers_per_block=1,
                              num_attention_heads=2, cross_attention_dim=48,
                              norm_num_groups=8, sample_size=16, flash_attention=True,
                              injection_bottleneck=8),
            vae=C.VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4,
                            layers_per_block=1),
            clip_text=C.CLIPTextConfig(vocab_size=128, hidden_size=48, num_layers=1,
                                       num_heads=2, intermediate_size=96, max_length=7),
            scheduler=C.SchedulerConfig(num_inference_steps=3),
            image_size=128))


def train_phase(cfg, params, stage, steps, data_root, out_dir):
    """``run_stage`` as a user calls it, with each micro-step timed (to a
    synchronize) and its kernel launches counted."""
    steps_log = []
    inner = T.train_step

    def timed_step(st, state, batch, generator):
        torch.cuda.synchronize()
        before, t0 = counts(), time.perf_counter()
        metrics = inner(st, state, batch, generator)
        torch.cuda.synchronize()
        after = counts()
        steps_log.append({"seconds": time.perf_counter() - t0,
                          "launches": {k: after[k] - before[k] for k in after},
                          "losses": {k: float(v) for k, v in metrics.items()}})
        return metrics

    T.train_step = timed_step
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = T.run_stage(cfg, stage, params, data_root=data_root, max_steps=steps,
                            log_dir=os.path.join(out_dir, "logs"), seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        T.train_step = inner
    return state, steps_log, wall, torch.cuda.max_memory_allocated() / 2 ** 30


def check_training(stage_no, cfg, params, state, steps_log, want=None):
    """Finite losses, exact per-step launch counts (``want``: kernel ->
    launches per micro-step), frozen leaves unchanged (bit for bit);
    returns how many leaves of each trainable group moved."""
    want = want or {"flash_attention": FLASH_FWD_PER_STEP,
                    "flash_attention_bwd": FLASH_BWD_PER_STEP}
    for i, rec in enumerate(steps_log):
        if not all(np.isfinite(v) for v in rec["losses"].values()):
            raise AssertionError(f"stage {stage_no} micro-step {i}: non-finite loss {rec}")
        got = {k: rec["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"stage {stage_no} micro-step {i}: launches {got}, "
                                 f"want {want}")
    trainable = S.MAKE_STAGE[stage_no](cfg).trainable
    moved = {}
    for tw, sd in state.params.items():
        for n, t in sd.items():
            same = torch.equal(t.detach(), params[tw][n])
            if not trainable(f"{tw}.{n}"):
                if not same:
                    raise AssertionError(f"stage {stage_no}: frozen leaf {tw}.{n} changed")
            else:
                group = next((g for g in ("decomposer", "projector", "audio_inject",
                                          "output_proj") if g in n), "other")
                moved[group] = moved.get(group, 0) + (not same)
    return moved


def small_training_reference(card="cuda", gen_seed=5):
    """One stage-2 micro-step of the small configuration in fp32: the card
    (kernels) against the CPU (plain versions), the same weights, noise,
    timesteps and batch, dropout off."""
    cfg = C.apply_overrides(small_config(), ["train.compute_dtype=float32"])
    cpu_params = T.init_params(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(gen_seed)
    batch = random_batch(cfg, 2, gen)
    noise = torch.randn(batch["latent"].shape, generator=gen)
    t = torch.tensor([17, 803])
    out = {}
    for dev in (card, "cpu"):
        st = S.make_stage2_step(cfg)
        state = st.create_state({tw: {n: v.detach().to(dev, copy=True)
                                      for n, v in cpu_params[tw].items()} for tw in st.towers})
        reset_counts()
        total, _ = st.loss(state, {k: v.to(dev) for k, v in batch.items()}, None,
                           noising=(noise.to(dev), t.to(dev)), deterministic=True)
        grads = S.grads_of(total, state.trainable_leaves())
        out[dev] = (float(total.detach()), {k: g.cpu() for k, g in grads.items()}, counts())
    (l_card, g_card, n_card), (l_cpu, g_cpu, _) = out[card], out["cpu"]
    if not (n_card["flash_attention"] and n_card["flash_attention_bwd"]):
        raise AssertionError(f"small training step did not reach the flash kernels: {n_card}")
    worst = abs(l_card - l_cpu) / abs(l_cpu)
    for name, g in g_cpu.items():
        scale = float(g.abs().max()) or 1.0
        worst = max(worst, float((g_card[name] - g).abs().max()) / scale)
    if worst > TRAIN_REL_TOL:
        raise AssertionError(f"small training step: card vs CPU differ by {worst:.3g} "
                             f"(of max|cpu| per leaf) > {TRAIN_REL_TOL}")
    return {"loss_card": l_card, "loss_cpu": l_cpu, "worst_rel_err": worst,
            "leaves": len(g_cpu), "launches": n_card}


def generate_phase(pipe, wav, text, uncond, first_img, checked, card):
    """Phase 3c: the rest of ``generate`` at full width (bf16, random
    weights, phase 3's pipeline, prompt and waveform): each request of
    GENERATE_REQUESTS timed with its exact launch counts, the properties the
    JAX tests hold, ``generate_stream`` against ``generate``, then each
    kernel at every shape of the phase that no earlier phase checked."""
    size = pipe.cfg.diffusion.image_size
    lat = size // 8
    kinds = ("flash_attention", "group_norm_silu", "group_norm")
    left = np.zeros((size, size), np.uint8)
    left[:, :size // 2] = 255  # regenerate the left half
    init = first_img[0]  # phase 3's first image: hierarchical, ddim 50, seed 0
    extra = {"img2img": dict(init_image=init), "inpainting": dict(init_image=init, mask_image=left),
             "audio_mix": dict(waveform2=np.ascontiguousarray(waveform(seed=2)[::-1]))}
    rows, images = [], {}

    def run(name, kw, want):
        b = kw.get("batch", 1)
        kw = dict(waveform=wav, text_ids=np.repeat(text, b, 0), uncond_ids=np.repeat(uncond, b, 0),
                  guidance_scale=7.5, seed=0, **kw)
        before = counts()
        t0 = time.perf_counter()
        img = pipe.generate(**kw)
        wall = time.perf_counter() - t0
        after = counts()
        got = tuple(after[k] - before[k] for k in kinds)
        if img.shape != (b, size, size, 3) or img.dtype != np.uint8 or \
                any(im.std() == 0 for im in img):
            raise AssertionError(f"generate {name}: image {img.shape} {img.dtype} constant or "
                                 f"of the wrong shape")
        if got != want:
            raise AssertionError(f"generate {name}: launches (flash, gn_silu, gn) {got}, "
                                 f"want {want}")
        row = {"phase": "generate_request", "request": name, "seconds": wall,
               "flash_launches": got[0], "group_norm_silu_launches": got[1],
               "group_norm_launches": got[2], "image_mean": float(img.mean()),
               "image_std": float(img.std())}
        log(row)
        rows.append(row)
        return img

    reset_counts()
    for name, (kw, want) in GENERATE_REQUESTS.items():
        images[name] = run(name, {**kw, **extra.get(name, {})}, want)
    if not np.abs(images["sonic"].astype(int) - first_img.astype(int)).max():
        raise AssertionError("sonic gives the hierarchical image of the same seed")
    kw, want = GENERATE_REQUESTS["img2img"]
    ones = run("img2img_mask_255", {**kw, "init_image": init,
                                    "mask_image": np.full((size, size), 255, np.uint8)}, want)
    if not np.array_equal(ones, images["img2img"]):
        raise AssertionError("an all-255 mask does not give img2img's bits")
    kw, want = GENERATE_REQUESTS["seeds"]
    twin = run("seeds_5_5", {**kw, "seeds": [5, 5]}, want)
    solo = run("seeds_5", {**kw, "seeds": [5], "batch": 1}, want)
    # what the card can show bit for bit: a lane's initial latents are its
    # seed's solo draw, and two lanes of one seed get the same ones
    lanes = pipe.draws(0, [7, 5]).latents((2, lat, lat, 4))
    if not (torch.equal(lanes[1], pipe.draws(5).latents((1, lat, lat, 4))[0])
            and torch.equal(lanes[1], pipe.draws(0, [5]).latents((1, lat, lat, 4))[0])
            and torch.equal(*pipe.draws(0, [5, 5]).latents((2, lat, lat, 4)))):
        raise AssertionError("a lane's initial latents are not its seed's solo draw")

    def image_diff(a, b):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        return {"max_abs_diff": int(d.max()), "mean_abs_diff": float(d.mean()),
                "frac_differing": float((d > 0).mean()), "bit_equal": bool(d.max() == 0)}

    # the images, recorded: cuDNN's conv at [4, 32, 32, 640] (CFG batch 4)
    # gives two equal samples other bits (tools/probe_lane_bits.py), so equal
    # lanes, and a solo image against its lane at batch 2, need not match
    twin_lanes = image_diff(twin[0], twin[1])
    solo_vs_lane = image_diff(solo[0], images["seeds"][1])

    # generate_stream (two in flight) against three generate calls, timed in
    # turns (calls, stream, stream, calls) so that the host's drift cancels
    base = dict(waveform=wav, text_ids=text, uncond_ids=uncond, num_steps=STREAM_STEPS)
    reqs = [dict(seed=s) for s in (11, 12, 13)]
    one_by_one, t_calls, t_stream, service = None, [], [], []
    for mode in ("calls", "stream", "stream", "calls"):
        t0 = time.perf_counter()
        if mode == "calls":
            out = [pipe.generate(**base, **r) for r in reqs]
            t_calls.append(time.perf_counter() - t0)
        else:
            timed = list(pipe.generate_stream_timed(reqs, depth=2, **base))
            t_stream.append(time.perf_counter() - t0)
            service.append([t for _, t in timed])
            out = [img for img, _ in timed]
        one_by_one = one_by_one or out
        if not all(np.array_equal(a, b) for a, b in zip(one_by_one, out)):
            raise AssertionError(f"{mode}: generate_stream(depth=2) and generate give other bits")
    launches = counts()
    if not all(launches[k] for k in kinds):
        raise AssertionError(f"phase 3c did not reach every serving kernel: {launches}")

    # the kernels at the phase's shapes that no earlier phase checked (batch 2
    # through the UNet at CFG batch 4 and through the VAE decoder)
    seen = {fn.__name__: dict(fn.shapes)
            for fn in (fa.flash_attention, gn.group_norm_silu, gn.group_norm)}
    new_gen = torch.Generator(device="cuda").manual_seed(4)
    errs = {"flash_attention_fwd": 0.0, "group_norm_silu": 0.0, "group_norm": 0.0}
    fresh = 0
    for kind, shapes in seen.items():
        for key in set(shapes) - checked[kind]:
            fresh += 1
            if kind == "flash_attention":
                r = flash_case(key[0], key[1], torch.bfloat16, new_gen, timed=False)
                errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], r["max_abs_err"])
            else:
                r = gn_case(kind, key[0], torch.bfloat16, key[2], key[3], new_gen, timed=False)
                errs[kind] = max(errs[kind], r["max_abs_err"])
    log({"phase": "generate_path", "card": card,
         "wall_s": {r["request"]: r["seconds"] for r in rows},
         "launches": launches, "seeds_5_5_lanes": twin_lanes,
         "seeds_5_solo_vs_lane_1_of_7_5": solo_vs_lane,
         "stream_depth2_s": t_stream, "stream_service_s": service,
         "three_generate_calls_s": t_calls, "stream_steps": STREAM_STEPS,
         "shapes_first_checked_here": fresh, "errs": errs,
         "sm_clock,power_draw,temperature_after": smi("clocks.sm,power.draw,temperature.gpu")})
    return {"rows": rows, "errs": errs, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 1
    cleared = [name for name in FLAGS if os.environ.pop(name, None) is not None]
    card = smi()
    log(card)
    log({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    sources = [*fa.SOURCES, wp.SOURCE, gn.SOURCE]
    cuda_build.build_all(sources)  # one nvcc per source, all started together
    fa.build()
    wp.build()
    gn.build()
    log({"phase": "build", "seconds": time.perf_counter() - t0, "sources": sources,
         "flags_cleared": cleared})
    for source, text in cuda_build.BUILD_LOGS.items():  # registers and spills (-Xptxas=-v)
        log({"phase": "ptxas", "source": source, "kernels": cuda_build.ptxas_summary(text)})

    # -- 2. census of the main path's kernel shapes, then kernel vs plain ----
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log({"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
         "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    cfg = C.Config()
    t0 = time.perf_counter()
    pipe = AudioToImagePipeline(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log({"phase": "init", "seconds": time.perf_counter() - t0,
         "params": sum(p.numel() for m in (pipe.clap_audio, pipe.clip_text, pipe.hierarchical,
                                            pipe.unet, pipe.vae) for p in m.parameters())})
    gen = torch.Generator(device="cuda").manual_seed(0)
    lat = cfg.diffusion.image_size // 8
    unet_args = (torch.randn(2, lat, lat, 4, device="cuda", generator=gen).bfloat16(),
                 torch.tensor([981, 981], device="cuda"),
                 torch.randn(2, 77, 768, device="cuda", generator=gen).bfloat16(),
                 {lvl: torch.randn(2, 10, 768, device="cuda", generator=gen).bfloat16()
                  for lvl in ("early", "mid", "late")})
    conv_census, hooks = conv3x3_census(pipe.unet)
    reset_counts()
    with torch.inference_mode():
        pipe.unet(*unet_args)
        pipe.vae.decode_latent(torch.randn(1, lat, lat, 4, device="cuda",
                                           generator=gen).bfloat16())
    torch.cuda.synchronize()
    for handle in hooks:
        handle.remove()
    census = {fn.__name__: dict(fn.shapes)
              for fn in (fa.flash_attention, gn.group_norm_silu, gn.group_norm)}

    rows = {"flash_attention_fwd": {}, "group_norm_silu": {}, "group_norm": {}}
    errs = {k: 0.0 for k in rows}
    pad_gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        for (qs, ks, _) in census["flash_attention"]:
            r = flash_case(qs, ks, dtype, gen)
            rows["flash_attention_fwd"][(qs, ks, str(dtype))] = r
            errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], r["max_abs_err"])
        for qs, ks in (((1, 2, 1000, 40), (1, 2, 1000, 40)), ((2, 3, 300, 80), (2, 3, 777, 80)),
                       ((1, 1, 333, 512), (1, 1, 130, 512))):  # ragged tiles
            r = flash_case(qs, ks, dtype, gen)
            errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], r["max_abs_err"])
        # d = 24 and 256 run on the next instance up (32, and the four-warpgroup
        # kernel), their columns past d never stored; drawn from their own
        # generator, so that the later phases draw the inputs they always drew
        for qs, ks in (((1, 2, 100, 24), (1, 2, 100, 24)), ((1, 1, 200, 256), (1, 1, 150, 256))):
            r = flash_case(qs, ks, dtype, pad_gen)
            errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], r["max_abs_err"])
        for kind in ("group_norm_silu", "group_norm"):
            for (shape, _, groups, eps) in census[kind]:
                r = gn_case(kind, shape, dtype, groups, eps, gen)
                rows[kind][(shape, str(dtype), groups, eps)] = r
                errs[kind] = max(errs[kind], r["max_abs_err"])
    log({"phase": "kernels_vs_plain", "ok": True})

    # -- 2b. training census, then the backward kernel vs its plain version --
    train_cfg = C.Config()
    train_params = T.init_params(train_cfg, seed=0, device="cuda")
    tcensus = training_census(train_cfg, train_params, gen)
    log({"phase": "training_census",
         **{f"stage{n}_counts": tcensus[n]["counts"] for n in (2, 3)},
         **{f"stage{n}_flash_bwd_shapes": [list(k[:2]) for k in tcensus[n]["flash_attention_bwd"]]
            for n in (2, 3)}})
    for n in (2, 3):
        got = (tcensus[n]["counts"]["flash_attention"], tcensus[n]["counts"]["flash_attention_bwd"])
        if got != (FLASH_FWD_PER_STEP, FLASH_BWD_PER_STEP):
            raise AssertionError(f"stage {n} census: flash (fwd, bwd) launches {got}")
    rows["flash_attention_bwd"] = {}
    errs["flash_attention_bwd"] = 0.0
    bwd_shapes = {**tcensus[3]["flash_attention_bwd"], **tcensus[2]["flash_attention_bwd"]}
    # ex2 a second: 16 a clock on each SM at the card's highest SM clock
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    ex2_per_s = 16 * torch.cuda.get_device_properties(0).multi_processor_count * sm_mhz * 1e6
    bwd_gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        for (qs, ks, _) in bwd_shapes:
            r = bwd_case(qs, ks, dtype, gen,
                         timed=(qs, ks, "torch.bfloat16") in tcensus[2]["flash_attention_bwd"],
                         ex2_per_s=ex2_per_s)
            rows["flash_attention_bwd"][(qs, ks, str(dtype))] = r
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], r["max_abs_err"])
        for qs, ks in (((1, 2, 1000, 40), (1, 2, 1000, 40)), ((2, 3, 300, 80), (2, 3, 777, 80)),
                       ((1, 2, 130, 8), (1, 2, 65, 8)), ((1, 2, 70, 16), (1, 2, 300, 16)),
                       ((1, 2, 200, 160), (1, 2, 100, 160))):  # ragged tiles, small d
            r = bwd_case(qs, ks, dtype, gen, timed=False)
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], r["max_abs_err"])
        # d = 64 and 120 run on the next instance up (80, 160), their columns past d
        # zero and never stored; drawn from their own generator, so that the later
        # phases draw the inputs they always drew
        for qs, ks in (((1, 2, 96, 64), (1, 2, 200, 64)), ((1, 2, 100, 120), (1, 2, 150, 120))):
            r = bwd_case(qs, ks, dtype, bwd_gen, timed=False)
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], r["max_abs_err"])
        # d > 160 (the VAE) has no backward; its forward (four warpgroups over the
        # columns) writes lse from the first
        q5, k5, v5 = (torch.randn(sh, device="cuda", generator=gen).to(dtype)
                      for sh in ((1, 1, 333, 512), (1, 1, 130, 512), (1, 1, 130, 512)))
        log({"kernel": "flash_attention_fwd lse", "q": [1, 1, 333, 512], "dtype": str(dtype)[6:],
             "lse_err": lse_case(q5, k5, v5, 512 ** -0.5, "flash lse d=512")[2]})
    for kind in ("group_norm_silu", "group_norm"):
        train_gn = {**tcensus[2][kind], **tcensus[3][kind]}
        for (shape, _, groups, eps) in train_gn:  # the kernels at the training shapes
            x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
            w = torch.ones(shape[-1], device="cuda", dtype=torch.bfloat16)
            b = torch.zeros_like(w)
            fn = gn.group_norm_silu if kind == "group_norm_silu" else gn.group_norm
            check(f"{kind} {list(shape)} train", fn(x, w, b, groups, eps),
                  gn.plain_group_norm(x, w, b, groups, eps, kind == "group_norm_silu"),
                  torch.bfloat16)
    gn_grad_rows = [gn_grad_case("group_norm_silu", (4, 64, 64, 320), torch.bfloat16, 32, 1e-5,
                                 gen),
                    gn_grad_case("group_norm", (4, 16, 16, 1280), torch.bfloat16, 32, 1e-6, gen)]
    log({"phase": "backward_vs_plain", "ok": True})

    # -- 2c. census of the packed route, then the packed kernel vs plain ------
    with flag("C2D_PACKED_FLASH"):
        reset_counts()
        with torch.inference_mode():
            pipe.unet(*unet_args)
        torch.cuda.synchronize()
        packed_serve = {"counts": counts(), "shapes": dict(fa.packed_flash_attention.shapes)}
        ptcensus = training_census(train_cfg, train_params, gen)
    want_step = {"packed_flash_attention": PACKED_PER_FORWARD,
                 "flash_attention": FLASH_FWD_PER_STEP - PACKED_PER_FORWARD,
                 "flash_attention_bwd": FLASH_BWD_PER_STEP}
    for n in (2, 3):
        got = {k: ptcensus[n]["counts"][k] for k in want_step}
        if got != want_step:
            raise AssertionError(f"stage {n} census under C2D_PACKED_FLASH=1: {got}")
    got = (packed_serve["counts"]["packed_flash_attention"],
           packed_serve["counts"]["flash_attention"])
    if got != (PACKED_PER_FORWARD, FLASH_FWD_PER_STEP - PACKED_PER_FORWARD):
        raise AssertionError(f"UNet forward under C2D_PACKED_FLASH=1: (packed, per-head) {got}")
    packed_shapes = {**packed_serve["shapes"], **ptcensus[2]["packed_flash_attention"],
                     **ptcensus[3]["packed_flash_attention"]}
    log({"phase": "packed_census", "serving": packed_serve["counts"],
         **{f"stage{n}_counts": ptcensus[n]["counts"] for n in (2, 3)},
         "shapes": [list(k[0]) + [k[1]] for k in packed_shapes]})
    rows["packed_flash_attention_fwd"] = {}
    errs["packed_flash_attention_fwd"] = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for (qs, pack, _) in packed_shapes:
            b, h, s, d = qs
            r = packed_case(b, s, h, d, dtype, gen)
            rows["packed_flash_attention_fwd"][(qs, pack, str(dtype))] = r
            errs["packed_flash_attention_fwd"] = max(errs["packed_flash_attention_fwd"],
                                                     r["max_abs_err"])
        # ragged, all at B = 1: a ghost head (5 heads, pack 3), pack 4, pack 2, S=1024,
        # S off the tile, S shorter than one key tile, d = 16 and 8 (a pack above 4),
        # and the head dims no path gives the kernel (24, 48, 56): every instance runs
        for b, s, h, d in ((1, 1024, 5, 40), (1, 1024, 4, 32), (1, 1024, 2, 64),
                           (1, 1024, 8, 40), (1, 1000, 3, 40), (1, 40, 3, 40),
                           (1, 200, 5, 16), (1, 130, 6, 8), (1, 200, 3, 24),
                           (1, 1024, 2, 48), (1, 1024, 2, 56)):
            r = packed_case(b, s, h, d, dtype, gen, timed=False)
            errs["packed_flash_attention_fwd"] = max(errs["packed_flash_attention_fwd"],
                                                     r["max_abs_err"])
    log({"phase": "packed_vs_plain", "ok": True})

    # -- 2d. the Winograd kernel vs its plain version and a direct conv --------
    wino_shapes = {k: n for k, n in conv_census.items() if wp.eligible(k[0], k[0][-1], k[1])}
    log({"phase": "conv3x3_census", "calls": sum(conv_census.values()),
         "eligible": [[list(k[0]), k[1], n] for k, n in wino_shapes.items()],
         "not_eligible": [[list(k[0]), k[1], n] for k, n in conv_census.items()
                          if k not in wino_shapes]})
    rows["winograd_conv3x3"] = {}
    errs["winograd_conv3x3"] = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for xs, co in dict.fromkeys([*wino_shapes, *BENCH_WINO_SHAPES]):
            r = wino_case(xs, co, dtype, gen)
            rows["winograd_conv3x3"][(xs, co, str(dtype))] = r
            errs["winograd_conv3x3"] = max(errs["winograd_conv3x3"], r["max_abs_err"])
        for xs, co in RAGGED_WINO_SHAPES:
            r = wino_case(xs, co, dtype, gen, timed=False)
            errs["winograd_conv3x3"] = max(errs["winograd_conv3x3"], r["max_abs_err"])
    # the kernel's entry point over one UNet forward's eligible Conv3x3 calls
    drive = []
    for (xs, co), n in wino_shapes.items():
        x = torch.randn(xs, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(3, 3, xs[-1], co, device="cuda", generator=gen) * 0.02).bfloat16()
        drive.append((x, w, torch.zeros(co, device="cuda", dtype=torch.bfloat16), n))
    reset_counts()
    for x, w, bias, n in drive:
        for _ in range(n):
            wp.conv3x3_winograd_pallas(x, w, bias)
    torch.cuda.synchronize()
    wino_launches = wp.conv3x3_winograd_pallas.launches
    if wino_launches != sum(wino_shapes.values()):
        raise AssertionError(f"winograd: {wino_launches} launches over the census")
    del drive
    # the UNet's opt-in C2D_WINOGRAD=1 route (plain PyTorch) vs the direct conv
    wino_unet_err = unet_route_check(pipe.unet, unet_args, "C2D_WINOGRAD")
    log({"phase": "winograd_vs_plain", "ok": True, "launches": wino_launches,
         "unet_route_err_of_max_eps": wino_unet_err})

    # -- 2e. the VAE encoder's shapes: GroupNorm and flash vs plain -----------
    # a census of one encode (img2img's, batch 1), kept out of phase 2's; its
    # inputs come from a generator of its own, so later phases draw as before
    enc_gen = torch.Generator(device="cuda").manual_seed(3)
    reset_counts()
    with torch.inference_mode():
        pipe.vae.encode(torch.rand(1, cfg.diffusion.image_size, cfg.diffusion.image_size, 3,
                                   device="cuda", generator=enc_gen).bfloat16() * 2 - 1)
    torch.cuda.synchronize()
    enc_census = {fn.__name__: dict(fn.shapes)
                  for fn in (fa.flash_attention, gn.group_norm_silu, gn.group_norm)}
    enc_counts = counts()
    log({"phase": "encoder_census", "counts": enc_counts,
         **{k: [list(key[0]) for key in v] for k, v in enc_census.items()}})
    if (enc_counts["flash_attention"], enc_counts["group_norm_silu"],
            enc_counts["group_norm"]) != (1, 21, 1):
        raise AssertionError(f"VAE encoder: launches {enc_counts}, want flash 1, "
                             f"GN+SiLU 21, GN 1")
    enc_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for (qs, ks, _) in enc_census["flash_attention"]:
            r = flash_case(qs, ks, dtype, enc_gen, timed=False)
            errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], r["max_abs_err"])
        for kind in ("group_norm_silu", "group_norm"):
            for (shape, _, groups, eps) in enc_census[kind]:
                r = gn_case(kind, shape, dtype, groups, eps, enc_gen)
                enc_rows.append(r)
                errs[kind] = max(errs[kind], r["max_abs_err"])
    # every (shape, dtype, ...) key checked so far, for phase 3c
    checked = {kind: set(rows[row_kind]) | set(enc_census[kind])
               for kind, row_kind in (("flash_attention", "flash_attention_fwd"),
                                      ("group_norm_silu", "group_norm_silu"),
                                      ("group_norm", "group_norm"))}
    log({"phase": "encoder_vs_plain", "ok": True,
         "worst_err": {k: errs[k] for k in ("flash_attention_fwd", "group_norm_silu",
                                            "group_norm")}})

    # -- 3. the main path ----------------------------------------------------
    tok = CLIPTokenizer(max_length=cfg.diffusion.clip_text.max_length)
    wav = waveform()
    text, uncond = tok("rain on a tin roof, distant thunder"), tok("")
    times, per_request, first_img = [], [], None
    torch.cuda.reset_peak_memory_stats()  # the phase's own peak, not the checks' above
    reset_counts()
    for i in range(REQUESTS):
        before = (fa.flash_attention.launches, gn.group_norm_silu.launches)
        t0 = time.perf_counter()
        img = pipe.generate(waveform=wav, text_ids=text, uncond_ids=uncond,
                            model_type="hierarchical", num_steps=50, guidance_scale=7.5,
                            seed=i)
        times.append(time.perf_counter() - t0)
        first_img = img if i == 0 else first_img
        req_counts = (fa.flash_attention.launches - before[0],
                      gn.group_norm_silu.launches - before[1])
        per_request.append(req_counts)
        if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8:
            raise AssertionError(f"request {i}: image {img.shape} {img.dtype}")
        if img.std() == 0:
            raise AssertionError(f"request {i}: constant image")
        if req_counts != (FLASH_PER_IMAGE, GN_SILU_PER_IMAGE):
            raise AssertionError(f"request {i}: launches (flash, gn_silu) = {req_counts}, "
                                 f"want ({FLASH_PER_IMAGE}, {GN_SILU_PER_IMAGE})")
        log({"phase": "request", "i": i, "seconds": times[-1], "image_mean": float(img.mean()),
             "image_std": float(img.std()), "flash_launches": req_counts[0],
             "group_norm_silu_launches": req_counts[1]})
    launches = {"flash_attention_fwd": fa.flash_attention.launches,
                "group_norm_silu": gn.group_norm_silu.launches,
                "group_norm": gn.group_norm.launches}
    seen = {"flash_attention_fwd": dict(fa.flash_attention.shapes),
            "group_norm_silu": dict(gn.group_norm_silu.shapes),
            "group_norm": dict(gn.group_norm.shapes)}
    for kind, shapes in seen.items():
        missing = set(shapes) - {k for k in rows[kind] if "float32" not in str(k)}
        if missing:
            raise AssertionError(f"{kind}: main-path shapes not checked: {sorted(missing)}")
    log({"phase": "main_path", "card": card, "requests": REQUESTS,
         "wall_s": times, "p50_s_excluding_first": statistics.median(times[1:]),
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
         "sm_clock,power_draw,temperature_after": smi("clocks.sm,power.draw,temperature.gpu")})

    # -- 3b. serving under C2D_PACKED_FLASH=1 -----------------------------------
    packed_unet_err = unet_route_check(pipe.unet, unet_args, "C2D_PACKED_FLASH")
    # the route's requests interleaved with requests without it (on, off, off,
    # on), so that the wall times compare within one stretch of the run
    wall = {True: [], False: []}
    reset_counts()
    for i, on in enumerate((True, False, False, True)):
        before = counts()
        with flag("C2D_PACKED_FLASH") if on else contextlib.nullcontext():
            t0 = time.perf_counter()
            img = pipe.generate(waveform=wav, text_ids=text, uncond_ids=uncond,
                                model_type="hierarchical", num_steps=50, guidance_scale=7.5,
                                seed=i)
            wall[on].append(time.perf_counter() - t0)
        after = counts()
        got = tuple(after[k] - before[k] for k in
                    ("packed_flash_attention", "flash_attention", "group_norm_silu"))
        want = ((PACKED_PER_IMAGE, FLASH_PER_IMAGE - PACKED_PER_IMAGE, GN_SILU_PER_IMAGE)
                if on else (0, FLASH_PER_IMAGE, GN_SILU_PER_IMAGE))
        if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8 or img.std() == 0:
            raise AssertionError(f"packed-phase request {i}: image {img.shape} {img.dtype} "
                                 f"std {img.std()}")
        if got != want:
            raise AssertionError(f"packed-phase request {i} (route {'on' if on else 'off'}): "
                                 f"launches (packed, per-head, gn_silu) = {got}, want {want}")
        log({"phase": "packed_request", "i": i, "route": on, "seconds": wall[on][-1],
             "image_mean": float(img.mean()), "image_std": float(img.std()),
             "packed_launches": got[0], "flash_launches": got[1],
             "group_norm_silu_launches": got[2]})
    packed_launches = fa.packed_flash_attention.launches
    packed_seen = dict(fa.packed_flash_attention.shapes)
    missing = set(packed_seen) - {k for k in rows["packed_flash_attention_fwd"]
                                  if "bfloat16" in k[2]}
    if missing:
        raise AssertionError(f"packed_flash_attention: main-path shapes not checked: {missing}")
    log({"phase": "packed_path", "card": card, "requests": PACKED_REQUESTS,
         "wall_s_route_on": wall[True], "wall_s_route_off": wall[False],
         "unet_route_err_of_max_eps": packed_unet_err, "packed_launches": packed_launches})

    # -- 3c. the rest of generate at full width --------------------------------
    gen_out = generate_phase(pipe, wav, text, uncond, first_img, checked, card)
    for kind, err in gen_out["errs"].items():
        errs[kind] = max(errs[kind], err)

    # -- 4. small reference: the kernels in fp32 on the card vs the CPU -------
    small = small_config()
    wav_s = waveform(0.5, seed=1)
    ids = tok("golden rain")[:, :7]
    lat_s = torch.from_numpy(np.random.default_rng(11).normal(size=(1, 16, 16, 4))
                             .astype(np.float32))
    on_cpu = AudioToImagePipeline(small, seed=3, device="cpu")
    towers = ("clap_audio", "clip_text", "hierarchical", "unet", "vae")
    on_card = AudioToImagePipeline(
        small, params={n: getattr(on_cpu, n).state_dict() for n in towers}, device="cuda")
    for p in (on_card, on_cpu):  # both from the same initial latents
        p.draws = lambda seed, seeds=None, p=p: FedLatents(p.device, lat_s)
    reset_counts()
    outs = [p.generate(wav_s, ids, np.zeros_like(ids), num_steps=3, guidance_scale=7.5,
                       norm_target=60.0, temperature=0.5, model_type="hierarchical")
            for p in (on_card, on_cpu)]
    if not (fa.flash_attention.launches and gn.group_norm_silu.launches):
        raise AssertionError("the small reference run did not reach both kernels")
    diff = np.abs(outs[0].astype(np.int32) - outs[1].astype(np.int32))
    ref_ok = float(diff.mean()) < 0.5 and float((diff > 2).mean()) < 0.01
    log({"phase": "reference", "mean_abs_diff": float(diff.mean()),
         "frac_over_2": float((diff > 2).mean()), "ok": ref_ok})
    if not ref_ok or outs[0].std() == 0:
        raise AssertionError("small-config image on the card disagrees with the CPU path")

    # -- 5. the training path at full width -----------------------------------
    tmp = tempfile.mkdtemp(prefix="c2d_smoke_")
    data_root = os.path.join(tmp, "data")
    make_fixture_dataset(data_root, n_train=8, n_val=0, n_test=0, duration_s=10.0,
                         sample_rate=48_000, latent_hw=64)
    state, steps2, wall2, peak2 = train_phase(train_cfg, train_params, 2, TRAIN_STEPS,
                                              data_root, tmp)
    moved = check_training(2, train_cfg, train_params, state, steps2)
    # The projector is trainable in stage 2 (as in the JAX package) but its
    # 77 tokens feed no stage-2 loss term: its gradient is 0 and AdamW moves
    # it only by weight decay, lr*wd*p <= 1.5e-8*p over these updates of
    # the warmup, below fp32 resolution. The decomposer and the injection
    # branches carry the gradient.
    if not all(moved.get(g, 0) for g in ("decomposer", "audio_inject")):
        raise AssertionError(f"stage 2: a trainable group did not move: {moved}")
    train_launches = counts()
    missing = set(fa.flash_attention_bwd.shapes) - {
        k for k in rows["flash_attention_bwd"] if "bfloat16" in k[2]}
    if missing:
        raise AssertionError(f"flash_attention_bwd: training shapes not checked: {missing}")
    if state.opt.count != TRAIN_STEPS // train_cfg.train.stage2.grad_accum:
        raise AssertionError(f"stage 2: {state.opt.count} optimizer updates")
    del state
    step_s = [r["seconds"] for r in steps2]
    med = statistics.median(step_s[4:])
    bs = train_cfg.train.stage2.batch_size
    log({"phase": "train_stage2", "card": card, "micro_steps": TRAIN_STEPS, "batch": bs,
         "grad_accum": train_cfg.train.stage2.grad_accum, "updates": TRAIN_STEPS // 4,
         "micro_step_s": step_s, "median_micro_step_s_excluding_first_4": med,
         "samples_per_s": bs / med, "run_stage_wall_s": wall2, "peak_mem_gb": peak2,
         "launches_per_step": steps2[-1]["launches"], "launches_total": train_launches,
         "losses_last": steps2[-1]["losses"], "moved_leaves": moved,
         "sm_clock,power_draw,temperature_after": smi("clocks.sm,power.draw,temperature.gpu")})
    state, steps3, wall3, peak3 = train_phase(train_cfg, train_params, 3, STAGE3_STEPS,
                                              data_root, tmp)
    moved3 = check_training(3, train_cfg, train_params, state, steps3)
    missing = set(fa.flash_attention_bwd.shapes) - set(rows["flash_attention_bwd"])
    if missing:
        raise AssertionError(f"flash_attention_bwd: stage-3 shapes not checked: {missing}")
    del state
    log({"phase": "train_stage3", "micro_steps": STAGE3_STEPS,
         "batch": train_cfg.train.stage3.batch_size,
         "micro_step_s": [r["seconds"] for r in steps3], "peak_mem_gb": peak3,
         "launches_per_step": [r["launches"] for r in steps3], "moved_leaves": moved3})
    torch.cuda.empty_cache()

    # -- 5b. stage-2 training under C2D_PACKED_FLASH=1 ---------------------------
    with flag("C2D_PACKED_FLASH"):
        state, steps2p, wall2p, peak2p = train_phase(
            train_cfg, train_params, 2, PACKED_TRAIN_STEPS, data_root,
            os.path.join(tmp, "packed"))
    check_training(2, train_cfg, train_params, state, steps2p, want=want_step)
    del state
    bs = train_cfg.train.stage2.batch_size
    level0 = ((bs, 8, 4096, 40), (bs, 8, 4096, 40), "torch.bfloat16")
    from_packed = fa.flash_attention_bwd.shapes[level0]
    if from_packed != (PACKED_PER_FORWARD - 1) * PACKED_TRAIN_STEPS or \
            any(k[0][2] == 4096 for k in fa.flash_attention.shapes):
        raise AssertionError(f"stage 2 under C2D_PACKED_FLASH=1: {from_packed} backwards at "
                             f"{level0[0]}; per-head forwards {dict(fa.flash_attention.shapes)}")
    missing = set(fa.packed_flash_attention.shapes) - set(rows["packed_flash_attention_fwd"])
    if missing:
        raise AssertionError(f"packed_flash_attention: training shapes not checked: {missing}")
    packed_train_launches = fa.packed_flash_attention.launches
    log({"phase": "train_stage2_packed", "micro_steps": PACKED_TRAIN_STEPS, "batch": bs,
         "micro_step_s": [r["seconds"] for r in steps2p], "peak_mem_gb": peak2p,
         "launches_per_step": [r["launches"] for r in steps2p],
         "bwd_from_packed_route": from_packed,
         "losses_last": steps2p[-1]["losses"]})
    torch.cuda.empty_cache()

    # -- 6. small training reference: fp32 step on the card vs the CPU --------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref6 = small_training_reference()
    log({"phase": "train_reference", **ref6, "tolerance": TRAIN_REL_TOL, "ok": True})

    # -- the kernels line -----------------------------------------------------
    def per_image(kind, key):
        """Sum over one image's calls (the main path's counts / requests)."""
        vals = [rows[kind][shape_key][key] for shape_key in seen[kind]]
        if None in vals:
            return None
        return sum(v * n / REQUESTS for v, n in zip(vals, seen[kind].values()))

    def bound_by(kind):
        share = {"bytes": 0.0, "operations": 0.0}
        for shape_key, n in seen[kind].items():
            share[rows[kind][shape_key]["bound_by"]] += n * rows[kind][shape_key]["bound_ms"]
        return max(share, key=share.get)

    meta = {
        "flash_attention_fwd": ("cuda", "clap2diffusion_tpu_torch/csrc/flash_attention.cu",
                                "clap2diffusion_tpu/ops/flash_attention.py:51"),
        "group_norm_silu": ("cuda", "clap2diffusion_tpu_torch/csrc/group_norm.cu",
                            "clap2diffusion_tpu/ops/groupnorm.py:31"),
        "group_norm": ("cuda", "clap2diffusion_tpu_torch/csrc/group_norm.cu",
                       "clap2diffusion_tpu/ops/groupnorm.py:31"),
    }
    kernels = []
    for kind, (route, src, replaces) in meta.items():
        kernels.append({
            "name": kind, "route": route, "source": src, "replaces": replaces,
            "launches": launches[kind], "max_abs_err": errs[kind],
            "ms": per_image(kind, "kernel_ms"), "plain_ms": per_image(kind, "plain_ms"),
            "bound_ms": per_image(kind, "bound_ms"),
            "bound_by": bound_by(kind),
            "library_ms": per_image(kind, "library_ms"), "per": "image, bf16",
            "device_ms": per_image(kind, "device_ms"),
            "library_device_ms": per_image(kind, "library_device_ms"),
            "training_launches": train_launches[
                "flash_attention" if kind == "flash_attention_fwd" else kind],
            "generate_phase_launches": gen_out["launches"][
                "flash_attention" if kind == "flash_attention_fwd" else kind],
        })
        if kind == "group_norm_silu":
            kernels[-1].update({
                "group_norm_then_silu_ms": per_image(kind, "group_norm_then_silu_ms"),
                "group_norm_then_silu_device_ms": per_image(kind,
                                                            "group_norm_then_silu_device_ms")})
    # the backward per stage-2 micro-step: the census's calls, bf16
    per_step = tcensus[2]["flash_attention_bwd"]  # {(q, k, dtype): calls in one micro-step}
    rows_b = rows["flash_attention_bwd"]

    def per_step_sum(key):
        return sum(rows_b[k][key] * n for k, n in per_step.items())

    share = {"bytes": 0.0, "operations": 0.0}
    for k, n in per_step.items():
        share[rows_b[k]["bound_by"]] += n * rows_b[k]["bound_ms"]
    # a floor of this design (two ex2 a logit), computed, not measured: logged
    # beside the bound, kept out of the kernels line
    log({"kernel": "flash_attention_bwd", "per": "micro-step, bf16",
         "bound_ms": per_step_sum("bound_ms"), "ex2_floor_ms": per_step_sum("ex2_floor_ms")})
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "clap2diffusion_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "clap2diffusion_tpu/ops/flash_attention.py:394",
        "launches": train_launches["flash_attention_bwd"],
        "max_abs_err": errs["flash_attention_bwd"],
        "ms": per_step_sum("kernel_ms"), "plain_ms": per_step_sum("plain_ms"),
        "bound_ms": per_step_sum("bound_ms"), "bound_by": max(share, key=share.get),
        "library_ms": per_step_sum("library_ms"), "per": "micro-step, bf16",
        "device_ms": per_step_sum("device_ms"),
        "library_device_ms": per_step_sum("library_device_ms"),
        "gn_backward_ms": {str(r["x"]): r["backward_ms"] for r in gn_grad_rows},
    })
    # the packed forward per image under C2D_PACKED_FLASH=1 (phase 3b), bf16
    rows_p = rows["packed_flash_attention_fwd"]

    def packed_sum(key):
        return sum(rows_p[k][key] * n / PACKED_REQUESTS for k, n in packed_seen.items())

    share = {"bytes": 0.0, "operations": 0.0}
    for k, n in packed_seen.items():
        share[rows_p[k]["bound_by"]] += n * rows_p[k]["bound_ms"]
    kernels.append({
        "name": "packed_flash_attention_fwd", "route": "cuda",
        "source": "clap2diffusion_tpu_torch/csrc/packed_flash_attention.cu",
        "replaces": "clap2diffusion_tpu/ops/flash_attention.py:166",
        "launches": packed_launches, "max_abs_err": errs["packed_flash_attention_fwd"],
        "ms": packed_sum("kernel_ms"), "plain_ms": packed_sum("plain_ms"),
        "bound_ms": packed_sum("bound_ms"), "bound_by": max(share, key=share.get),
        "library_ms": packed_sum("library_ms"), "per_head_ms": packed_sum("per_head_ms"),
        "per": "image, bf16, C2D_PACKED_FLASH=1", "training_launches": packed_train_launches,
    })
    # the Winograd kernel per UNet forward over the eligible census shapes, bf16;
    # per call at the bench shapes
    rows_w = rows["winograd_conv3x3"]

    def wino_sum(key):
        return sum(rows_w[(xs, co, "torch.bfloat16")][key] * n
                   for (xs, co), n in wino_shapes.items())

    share = {"bytes": 0.0, "operations": 0.0}
    for (xs, co), n in wino_shapes.items():
        r = rows_w[(xs, co, "torch.bfloat16")]
        share[r["bound_by"]] += n * r["bound_ms"]
    kernels.append({
        "name": "winograd_conv3x3", "route": "cuda",
        "source": "clap2diffusion_tpu_torch/csrc/winograd.cu",
        "replaces": "clap2diffusion_tpu/ops/winograd_pallas.py:69",
        "launches": wino_launches, "max_abs_err": errs["winograd_conv3x3"],
        "ms": wino_sum("kernel_ms"), "plain_ms": wino_sum("plain_ms"),
        "bound_ms": wino_sum("bound_ms"), "bound_by": max(share, key=share.get),
        "library_ms": wino_sum("library_ms"), "entry_ms": wino_sum("entry_ms"),
        "filter_ms": wino_sum("filter_ms"),
        "per": "UNet forward (batch 2, bf16), eligible Conv3x3 shapes",
        "bench": [{k: rows_w[(xs, co, dt)][k] for k in
                   ("x", "cout", "dtype", "blocks", "kernel_ms", "entry_ms", "filter_ms",
                    "plain_ms", "library_ms", "bound_ms", "bound_by")}
                  for xs, co in BENCH_WINO_SHAPES for dt in ("torch.bfloat16", "torch.float32")],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
