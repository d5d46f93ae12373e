#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py            # from the repository root

Phases (each raises on failure, so the exit code is non-zero):
  1. Environment and build: the card's name and power limit, the nvcc builds
     of the five CUDA sources (flash-attention forward and backward, the
     head-packed forward, the Winograd conv, GroupNorm; one nvcc each, in
     parallel), timed. No kernel of the port is Triton. The opt-in flags
     C2D_PACKED_FLASH, C2D_WINOGRAD, C2D_INT8 and C2D_INT8_WIRE are
     cleared; phases 3b and 5b set C2D_PACKED_FLASH=1 for themselves only,
     phase 7a C2D_INT8=1 and phase 7b C2D_INT8_WIRE=1.
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
  3d. Checkpoint and entry points at full width: phase 3's weights written
     in the published layouts (diffusers UNet and VAE and HF CLIP text as
     .safetensors, an HF ClapModel's audio tower with text-tower keys as
     .bin, the reference's nested hierarchical and adapter .pth), the
     port's ``tools/convert_checkpoints.py`` to a pipeline checkpoint
     (bytes and seconds logged), ``apps.main infer --checkpoint`` in
     process on phase 3's waveform (a float WAV), prompt and seed, then the
     HTTP server on 127.0.0.1 over ``load_pipeline``: ``/healthz``,
     ``/generate``, ``/generate_batch`` with seeds [7, 5], two concurrent
     ``/generate`` through a coalescing service (500 ms, batch 2) and
     ``/metrics``. Each image is held bit for bit against phase 3's first
     image, phase 3c's ``seeds=[7, 5]`` or ``generate(seeds=..., batch=2)``
     (an entry of KNOWN_DELTAS against the golden bounds instead), each
     request's launches are exact, and its wall time and fetch wait logged.
  3e. Best-of-n at full width: random CLIP ViT-L/14 vision weights and a
     768x768 text projection (bf16, drawn on the card from seed 0) added to
     phase 3's pipeline; ``generate_best_of(4)`` (50 steps) on phase 3's
     waveform and prompt: exactly 751 / 2,279 / 801 launches, the four
     candidates equal to ``generate(seeds=[0..3], batch=4)`` bit for bit,
     the winner the argmax, the scores within SCORE_TOL of the same
     towers' fp32 run; the kernels at the shapes no earlier phase checked
     (the UNet at CFG batch 8); one ``/generate`` with ``best_of: 2``
     through the server against ``generate_best_of(2)``; wall times
     against phase 3's p50.
  3f. Evaluation at full width: ``run_evaluation`` on a fixture dataset of
     4 test samples (10 s at 48 kHz), 50 steps, with phase 3e's CLIP towers
     and random Inception v3 (torchvision variant) and CLAP text weights
     drawn on the card, phase 3's images (and 3c's sonic one) as PNG
     reference frames: fid, kid, frechet_clip_vision, inception_score,
     clip_score and audio_text_alignment computed and finite, exactly four
     requests' launches, each phase's time logged; each metric tower on the
     card against its fp32 CPU output on 2 inputs (TOWER_TOL); the
     ``evaluate`` CLI once on the same data from a checkpoint.
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
  5c. The way back: phase 5 saves a final stage-2 checkpoint; ``apps.main
     export`` writes it as .pth and .safetensors, both read back through
     ``convert_hierarchical_encoder`` to the trained tower bit for bit, and
     one 10-step ``infer --stage-checkpoint --ema`` request makes exactly
     151 flash, 479 GN+SiLU and 161 GN launches.
  5d. LoRA and remat: stage 2 with ``train.stage2.lora_rank=8`` at batch 4
     (one update a micro-step, no warmup, so that A moves: its gradient is
     zero until B has), 8 micro-steps with ``remat`` off, then the same 8
     with it on, from the
     same state and seed: losses within LOSS_TOL (bit equality logged),
     exact launches per micro-step (LORA_STEP_LAUNCHES, worked out from
     the code), A and B moved, every frozen leaf unchanged; peak memory
     and the median micro-step of each. Then ``merge_stage_params(
     use_ema=True)`` folds the remat run's adapters into the UNet, one
     10-step request from it makes exactly 151 / 479 / 161 launches, and
     its ``export`` holds the conditioning towers without the fold.
  6. Small training reference: one stage-2 micro-step of the small
     configuration in fp32 on the card (TF32 off, kernels on) against the
     same step on the CPU: loss and the gradient of every trainable leaf.
  6a. Prepare and encode: synthetic AudioCaps sources (WAVs at 44.1 and
     48 kHz, a FLAC from tests/flac_fixture.py, an mp3 when the system has
     libmp3lame to write one) and a CSV through ``apps.main prepare --csv``,
     then ``prepare --encode-latents`` on 8 PNG frames at 512² (phase 3's
     and 3c's images), batch 8, TF32 off: the native audio library's path and build seconds, the loader
     each source took, its decode time against the numpy path; exactly one
     chunk's launches (1 flash at [8, 1, 4096, 512], 21 GN+SiLU, 1 GN, fp32);
     each latent against the CPU encode of the same frame in fp32 with the
     same weights and draws, within LATENT_TOL of max|cpu|; the kernels at
     the chunk's new shapes (fp32) against their plain versions.
  6b. One rank over NCCL: ``apps.main train --stage 2 --coordinator
     127.0.0.1:<port> --num-processes 1 --process-id 0`` for 4 micro-steps on
     phase 5's data, against the same ``run_stage`` without a process group:
     losses and the saved parameters bit for bit, the launches per
     micro-step exact. Then ``evaluate --shard`` on phase 3f's 4 samples
     (10 steps): each image ``generate(seeds=[42])`` of its sample, bit for
     bit. The process group is destroyed afterwards.
  6c. Two ranks on the one card over Gloo (NCCL refuses two ranks on one
     device): two processes of this script run a data-parallel stage-2
     ``run_stage`` (data = 2, batch 4 each, 4 micro-steps) on ``cuda:0``;
     after every micro-step both ranks report the same losses and hold
     bit-identical trainable parameters (a digest), with exact launches.
     The run saves checkpoints, so the ranks agree on a preemption signal
     after every micro-step; each rank then times that agreement (a MAX
     all-reduce of one integer over Gloo, median of 50). A rank that fails
     fails the run.
  7a. W8A8 serving (C2D_INT8=1) on phase 3's pipeline: the int8 products of
     one UNet forward (INT8_GEMMS_PER_FORWARD, at JAX's sites) and
     ``int8_matmul`` / ``int8_conv`` on the card against the CPU at each
     of their shapes, at tolerance 0; a profiler trace of one int8 forward
     with the int8 GEMM kernel under every ``aten::_int_mm``; int8 eps
     against fp eps (cosine > INT8_COS_MIN); one UNet CFG forward timed
     with the flag on and off; six requests, int8 among default ones (the
     p50 of each, exact flash / GN+SiLU / GN launches and 50 forwards' int8
     products per int8 request, the image drift against the default).
  7b. The int8 weight wire (C2D_INT8_WIRE=1): phase 3d's converted fp32
     checkpoint loaded in bf16 with and without the flag (load seconds, raw
     and wire bytes), the card's expanded towers equal to the CPU's
     expansion of the same payload at tolerance 0, one request of each
     with exact launches and its image against phase 3's.
  7c. The port's tools: TOOLS_STEPS stage-2 micro-steps on phase 5's data
     without the embeddings cache, ``precompute_embeddings`` on the card,
     the same micro-steps with the cache (time, launches, the first loss
     within CACHE_LOSS_TOL); then ``run_lifecycle --scale 0.001
     --skip-eval`` into a temporary root, its wall time by phase.
  8a. The tools' shapes in this process, on phase 3's pipeline: ``generate``
     at batches 1, 2, 4, 8 and 16 (the coalescer's padded groups and the
     breakdown's batches: the UNet at CFG batch 2-32, the VAE decode at
     1-16), the CLAP encode to the hierarchical tokens at 1, 8 and 16, and
     the UNet at 32x32 latents (config 2), BENCH_SHAPE_STEPS steps each (the
     shapes do not depend on the count); each kernel checked (untimed)
     against its plain version at every shape no earlier phase checked.
  8. The measurement tools, each run as a user runs it (``python -m
     clap2diffusion_tpu_torch.tools.<name>``, a process of its own, its
     defaults): ``bench`` (its last line has exactly the JAX bench's keys
     and metric string and ``vs_baseline == round(2.0 / value, 3)``; its
     profiled request launches phase 3's 751 / 2,279 / 801; its wall p50 is
     logged beside phase 3's), ``bench_breakdown`` (every component at
     batches 1, 8 and 16 timed and finite), ``bench_serving`` (8 clients,
     pipelined then coalesced: as many 512x512 PNGs as requests, no group
     above the max batch, the same bits in the warm-up and the timed round)
     and ``bench_train`` (stage 1: finite losses, the last chunk's mean
     below the first's).

Timing: CUDA events around repeated launches after a warm-up (inputs stay
in L2 where they fit, as they do on the path, where the producer just wrote
them): ``*_ms`` back to back from Python, so at small shapes the host's cost
per call; ``*device_ms`` (phases 2, 2b, 2c and 2d) from a CUDA graph of 20
calls (``utils/timing.py``), the device's. Bounds use the H100 SXM data-sheet
rates: 989 TFLOP/s bf16 tensor, 67 TFLOP/s fp32, 3.35 TB/s HBM3. The line
before the last two is the ``kernels`` JSON: the forward, packed-forward and
GroupNorm times are per image (sum over the serving path's calls of one
image), the backward's per
stage-2 micro-step, the Winograd kernel's per UNet forward over the eligible
census shapes (with per-call rows at the bench shapes). The last line is
the device JSON.
"""

import base64
import contextlib
import copy
import dataclasses
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from clap2diffusion_tpu_torch.apps import main as M
from clap2diffusion_tpu_torch.apps.server import InferenceService, serve
from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.diffusion import pipeline as P
from clap2diffusion_tpu_torch.diffusion.pipeline import (
    AudioToImagePipeline,
    RequestDraws,
    _special_init,
    init_params,
    load_pipeline,
    random_init_,
)
from clap2diffusion_tpu_torch.models.clip_vision import (
    CLIPVisionEncoder,
    build_tower,
    clip_text_features,
    preprocess_images_device,
)
from clap2diffusion_tpu_torch.models.condition.convert import (
    convert_hierarchical_encoder,
    unwrap,
)
from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer
from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset
from clap2diffusion_tpu_torch.ops import cuda_build
from clap2diffusion_tpu_torch.ops import flash_attention as fa
from clap2diffusion_tpu_torch.ops import groupnorm as gn
from clap2diffusion_tpu_torch.ops import quant as pq
from clap2diffusion_tpu_torch.ops import winograd as wino
from clap2diffusion_tpu_torch.ops import winograd_pallas as wp
from clap2diffusion_tpu_torch.train import stages as S
from clap2diffusion_tpu_torch.tools import convert_checkpoints as port_tool
from clap2diffusion_tpu_torch.train import trainer as T
from clap2diffusion_tpu_torch.train.checkpoint import load_torch_checkpoint
from clap2diffusion_tpu_torch.utils.png import decode_png
from clap2diffusion_tpu_torch.utils.safetensors_io import load_safetensors, save_safetensors
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
FLAGS = ("C2D_PACKED_FLASH", "C2D_WINOGRAD", "C2D_INT8", "C2D_INT8_WIRE")
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


# the plain forward's fp32 logits at most this big in one piece (CFG batch 8
# at 4096 tokens, phase 3e's); larger batches are compared in slices of it
PLAIN_LOGITS_BYTES = 1 << 32


def plain_flash(q, k, v, scale):
    """``fa.plain_flash_attention``, in slices of the batch where its fp32
    logits would pass PLAIN_LOGITS_BYTES (CFG batch 16 and 32): each (batch,
    head) is its own softmax, so the slices give the same values."""
    rows = max(1, PLAIN_LOGITS_BYTES // (q.shape[1] * q.shape[2] * k.shape[2] * 4))
    if rows >= q.shape[0]:
        return fa.plain_flash_attention(q, k, v, scale)
    return torch.cat([fa.plain_flash_attention(q[i:i + rows], k[i:i + rows], v[i:i + rows],
                                               scale) for i in range(0, q.shape[0], rows)])


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
    err = check(name, got, plain_flash(q, k, v, scale), dtype)
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
        kernel = lambda: fa.packed_flash_nhd(q, k, v, h, pack, scale)  # noqa: E731
        library = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)  # noqa: E731
        row.update({
            "kernel_ms": time_ms(kernel), "device_ms": graph_ms(kernel),
            "plain_ms": time_ms(lambda: fa.plain_packed_flash_attention(qh, kh, vh, scale)),
            "per_head_ms": time_ms(lambda: fa.flash_attention_fwd(qh, kh, vh, scale)),
            "library_ms": time_ms(library), "library_device_ms": graph_ms(library),
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
        kernel = lambda: wp.winograd_conv_fwd(x, u, bias)  # noqa: E731
        library = lambda: F.conv2d(nchw, w_oihw, bias, padding=1)  # noqa: E731
        row.update({
            "kernel_ms": time_ms(kernel), "device_ms": graph_ms(kernel),
            "entry_ms": time_ms(lambda: wp.conv3x3_winograd_pallas(x, w, bias)),
            "filter_ms": time_ms(lambda: wp.winograd_filter(w, dtype)),
            "plain_ms": time_ms(lambda: wp.plain_conv3x3_winograd_pallas(x, w, bias)),
            "library_ms": time_ms(library), "library_device_ms": graph_ms(library),
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


def train_phase(cfg, params, stage, steps, data_root, out_dir, checkpoint_dir=None):
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
                            checkpoint_dir=checkpoint_dir,
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
    cpu_params = init_params(cfg, seed=3, device="cpu")
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


def check_new_shapes(seen, checked, gen):
    """The flash and GroupNorm kernels (untimed, in the type each call had)
    at every shape of ``seen`` (kernel -> shape counts) that no earlier phase
    checked; the worst errors and how many shapes were new."""
    errs = {"flash_attention_fwd": 0.0, "group_norm_silu": 0.0, "group_norm": 0.0}
    fresh = 0
    for kind, shapes in seen.items():
        for key in set(shapes) - checked[kind]:
            fresh += 1
            if kind == "flash_attention":
                dtype = getattr(torch, key[2].removeprefix("torch."))
                r = flash_case(key[0], key[1], dtype, gen, timed=False)
                errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], r["max_abs_err"])
            else:
                dtype = getattr(torch, key[1].removeprefix("torch."))
                r = gn_case(kind, key[0], dtype, key[2], key[3], gen, timed=False)
                errs[kind] = max(errs[kind], r["max_abs_err"])
            checked[kind].add(key)
    return errs, fresh


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
    errs, fresh = check_new_shapes(seen, checked, torch.Generator(device="cuda").manual_seed(4))
    log({"phase": "generate_path", "card": card,
         "wall_s": {r["request"]: r["seconds"] for r in rows},
         "launches": launches, "seeds_5_5_lanes": twin_lanes,
         "seeds_5_solo_vs_lane_1_of_7_5": solo_vs_lane,
         "stream_depth2_s": t_stream, "stream_service_s": service,
         "three_generate_calls_s": t_calls, "stream_steps": STREAM_STEPS,
         "shapes_first_checked_here": fresh, "errs": errs,
         "sm_clock,power_draw,temperature_after": smi("clocks.sm,power.draw,temperature.gpu")})
    return {"rows": rows, "errs": errs, "launches": launches, "images": images}


# Phase 6a: one chunk of 8 frames through the VAE encoder (phase 2e's census
# at batch 1, at batch 8); its latents on the card against the CPU, fp32
ENCODE_LAUNCHES = {"flash_attention": 1, "group_norm_silu": 21, "group_norm": 1}
ENCODE_FRAMES = 8
LATENT_TOL = 1e-3  # of max|cpu|
DIST_STEPS = 4  # micro-steps of phases 6b and 6c
SHARD_EVAL_STEPS = 10


def test_fixture(name):
    """A numpy-only module of this checkout's tests/ (by path: another
    installed package may be called ``tests``)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"c2d_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def prepare_phase(frames, checked, card):
    """Phase 6a: synthetic sources and a CSV through ``prepare --csv
    --encode-latents`` on the card; each latent against the CPU encode."""
    from clap2diffusion_tpu_torch.data import prepare as PPrep
    from clap2diffusion_tpu_torch.models.vae import AutoencoderKL
    from clap2diffusion_tpu_torch.utils import audio_io as AIO
    from clap2diffusion_tpu_torch.utils import native_audio as NA
    from clap2diffusion_tpu_torch.utils.png import encode_png

    write_flac = test_fixture("flac_fixture").write_flac
    write_mp3 = test_fixture("mp3_fixture").write_mp3
    tmp = tempfile.mkdtemp(prefix="c2d_prepare_")
    try:
        t0 = time.perf_counter()
        NA.load_library()  # built here, before any rank of 6c could race for it
        lib = {"path": NA.BUILD_INFO.get("path"), "build_s": NA.BUILD_INFO.get("seconds"),
               "load_s": time.perf_counter() - t0}
        src, frames_dir = os.path.join(tmp, "src"), os.path.join(tmp, "frames")
        os.makedirs(src)
        os.makedirs(frames_dir)
        rng = np.random.default_rng(10)

        def tone(sr, seconds):
            t = np.arange(int(sr * seconds)) / sr
            return (0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=t.size)
                    ).astype(np.float32)

        # 44.1 kHz sources are short: prepare resamples with the numpy
        # polyphase filter, as the JAX package does, at ~1e10 MACs a second
        # of audio
        sources = {"wav48": ("wav", 48_000, 10.0), "wav44": ("wav", 44_100, 0.2),
                   "flac48": ("flac", 48_000, 10.0), "flac44": ("flac", 44_100, 0.2),
                   "mp3": ("mp3", 44_100, 0.2)}
        written = {}
        for sid, (kind, sr, seconds) in sources.items():
            x = tone(sr, seconds)
            path = os.path.join(src, f"{sid}.{kind}")
            if kind == "wav":
                AIO.write_wav(path, x, sr)
            elif kind == "flac":
                write_flac(path, (x * 32767).astype(np.int16), sr, kind="lpc2")
            elif not write_mp3(path, x, sr):
                continue  # no libmp3lame: no mp3 source
            written[sid] = path
        loaders, decode = {}, {}
        for sid, path in written.items():
            kind = sources[sid][0]
            if kind == "wav":
                loaders[sid] = "numpy read_wav"
            else:
                try:
                    NA.decode_audio(path)
                    loaders[sid] = "native " + ("FLAC" if kind == "flac" else "libmpg123")
                except ValueError as e:  # mp3 without the system codec: ffmpeg or nothing
                    import shutil as _sh

                    loaders[sid] = ("ffmpeg" if _sh.which("ffmpeg") else f"unreadable: {e}")
            t0 = time.perf_counter()
            NA.load_audio(path, 48_000, 480_000)
            decode[sid] = {"audio_s": sources[sid][2], "native_s": time.perf_counter() - t0}
            if kind == "wav":
                t0 = time.perf_counter()
                NA._fallback_one(path, 48_000, 480_000, False)
                decode[sid]["numpy_s"] = time.perf_counter() - t0
        with open(os.path.join(tmp, "a.csv"), "w") as f:
            f.write("youtube_id,caption,start_time\n")
            for sid in sources:
                f.write(f"{sid},a tone from {sid},0\n")
        ids = [f"frame_{i}" for i in range(ENCODE_FRAMES)]
        for fid, img in zip(ids, frames):
            with open(os.path.join(frames_dir, f"{fid}.png"), "wb") as f:
                f.write(encode_png(img))
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        M.main(["prepare", "--csv", os.path.join(tmp, "a.csv"), "--audio-dir", src,
                "--out", out])
        csv_s = time.perf_counter() - t0
        # the CLI under PyTorch's defaults (cuDNN may take fp32 convolutions
        # to TF32), as a user runs it: encode_latents holds its fp32 encode
        # to full precision in its own scope and restores the flags
        smoke_flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M.main(["prepare", "--out", out, "--encode-latents", "--frames-dir", frames_dir])
            torch.cuda.synchronize()
            encode_s = time.perf_counter() - t0
            after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = smoke_flags
        if after != (True, False):
            raise AssertionError(f"encode_latents left the TF32 flags at {after}")
        launches = {k: v for k, v in counts().items() if k in ENCODE_LAUNCHES}
        if launches != ENCODE_LAUNCHES:
            raise AssertionError(f"prepare --encode-latents: launches {launches}, "
                                 f"want {ENCODE_LAUNCHES}")
        seen = {fn.__name__: dict(fn.shapes)
                for fn in (fa.flash_attention, gn.group_norm_silu, gn.group_norm)}
        mid = (ENCODE_FRAMES, 1, 4096, 512)  # the mid-block attention, one chunk
        if seen["flash_attention"] != {(mid, mid, "torch.float32"): 1}:
            raise AssertionError(f"prepare --encode-latents: flash at "
                                 f"{seen['flash_attention']}, want {mid} fp32 once")
        with open(os.path.join(out, "metadata_unified.json")) as f:
            meta = json.load(f)
        readable = {sid for sid, how in loaders.items() if not how.startswith("unreadable")}
        if sorted(s_["id"] for s_ in meta["samples"]) != sorted(readable):
            raise AssertionError(f"prepare: samples {meta['samples']}, readable {readable}")
        for s_ in meta["samples"]:
            wav, sr = AIO.read_wav(os.path.join(out, "audio", f"{s_['id']}.wav"))
            if sr != 48_000 or wav.shape != (480_000,) or not 0.9 < np.abs(wav).max() <= 1.0:
                raise AssertionError(f"prepare: {s_['id']} gave {wav.shape} at {sr} Hz")

        # the CPU encode of the same frames: the weights and the draws of the card's run
        with torch.device("meta"):
            vae = AutoencoderKL(C.VAEConfig())
        vae.to_empty(device="cuda")
        random_init_(vae, torch.Generator(device="cuda").manual_seed(0), {})
        cpu_sd = {k: v.cpu() for k, v in vae.state_dict().items()}
        del vae
        noise = PPrep.latent_draws(0, "cuda")((ENCODE_FRAMES, 64, 64, 4)).cpu()
        inner = PPrep.latent_draws
        PPrep.latent_draws = lambda seed, device: (lambda shape: noise)
        try:
            t0 = time.perf_counter()
            PPrep.encode_latents(os.path.join(tmp, "cpu"), frames_dir=frames_dir,
                                 vae_params=cpu_sd, device="cpu")
            cpu_s = time.perf_counter() - t0
        finally:
            PPrep.latent_draws = inner
        worst = 0.0
        for fid in ids:
            got = np.load(os.path.join(out, "latents", f"{fid}.npy"))
            want = np.load(os.path.join(tmp, "cpu", "latents", f"{fid}.npy"))
            if got.shape != (4, 64, 64) or not np.isfinite(got).all():
                raise AssertionError(f"encode_latents: {fid} latent {got.shape}")
            worst = max(worst, float(np.abs(got - want).max() / np.abs(want).max()))
        if worst > LATENT_TOL:
            raise AssertionError(f"encode_latents: card vs CPU {worst:.3g} of max|cpu| > "
                                 f"{LATENT_TOL}")
        errs, fresh = check_new_shapes(seen, checked,
                                       torch.Generator(device="cuda").manual_seed(6))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"phase": "prepare_encode", "card": card, "native_library": lib,
           "mp3_source": "mp3" in written, "loaders": loaders, "decode_to_48k": decode,
           "samples": len(meta["samples"]), "prepare_csv_cli_s": csv_s,
           "encode_latents_cli_s": encode_s,
           "encode_s_per_frame": encode_s / ENCODE_FRAMES, "cpu_encode_s": cpu_s,
           "launches": launches, "shapes": {k: [list(key[0]) for key in v]
                                            for k, v in seen.items()},
           "latent_card_vs_cpu_of_max": worst, "tolerance": LATENT_TOL,
           "shapes_first_checked_here": fresh, "errs": errs}
    log(row)
    return row


def record_steps(records):
    """A ``train_step`` that logs each micro-step's losses, launches, time
    and a digest of the trainable leaves into ``records``."""
    import hashlib

    inner = T.train_step

    def step(st, state, batch, generator, mesh=None):
        torch.cuda.synchronize()
        before, t0 = counts(), time.perf_counter()
        metrics = (inner(st, state, batch, generator) if mesh is None else
                   inner(st, state, batch, generator, mesh=mesh))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = counts()
        digest = hashlib.sha256()
        for name, t in sorted(state.trainable_leaves().items()):
            digest.update(name.encode() + t.detach().cpu().numpy().tobytes())
        records.append({"seconds": seconds, "launches": {k: after[k] - before[k] for k in after},
                        "losses": {k: float(v) for k, v in metrics.items()},
                        "digest": digest.hexdigest()})
        return metrics
    return step


def step_launches(records):
    want = LORA_STEP_LAUNCHES[False]
    for i, r in enumerate(records):
        got = {k: r["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"micro-step {i}: launches {got}, want {want}")
    return want


def nccl_phase(cfg, data_root, eval_ctx, card):
    """Phase 6b: the CLI's ``train --coordinator`` as one NCCL rank against
    ``run_stage`` without a process group, bit for bit; ``evaluate --shard``
    on phase 3f's data against ``generate(seeds=[42])``."""
    import torch.distributed as dist

    from clap2diffusion_tpu_torch.data.latent_dataset import AudioCapsLatentDataset
    from clap2diffusion_tpu_torch.diffusion import pipeline as PP
    from clap2diffusion_tpu_torch.parallel import distributed as PD

    tmp = tempfile.mkdtemp(prefix="c2d_nccl_")
    inner = T.train_step
    try:
        runs, walls = {}, {}
        for name in ("plain", "nccl"):
            records = runs[name] = []
            T.train_step = record_steps(records)
            ck = os.path.join(tmp, name)
            t0 = time.perf_counter()
            if name == "plain":
                T.run_stage(cfg, 2, init_params(cfg, seed=cfg.train.seed, device="cuda"),
                            data_root=data_root, max_steps=DIST_STEPS, checkpoint_dir=ck,
                            log_dir=os.path.join(tmp, "logs"))
            else:
                cwd = os.getcwd()
                os.chdir(tmp)  # the CLI logs to the config's relative log_dir
                try:
                    M.main(["train", "--stage", "2", "--data-root", data_root, "--max-steps",
                            str(DIST_STEPS), "--checkpoint-dir", ck, "--coordinator",
                            f"127.0.0.1:{free_port()}", "--num-processes", "1",
                            "--process-id", "0"])
                finally:
                    os.chdir(cwd)
                if not (dist.is_initialized() and dist.get_backend() == "nccl"
                        and dist.get_world_size() == 1):
                    raise AssertionError("train --coordinator did not join an NCCL group")
            walls[name] = time.perf_counter() - t0
            T.train_step = inner
        launches = step_launches(runs["nccl"])
        if [r["losses"] for r in runs["nccl"]] != [r["losses"] for r in runs["plain"]] or \
                [r["digest"] for r in runs["nccl"]] != [r["digest"] for r in runs["plain"]]:
            raise AssertionError("train --coordinator (one NCCL rank) differs from run_stage: "
                                 f"{runs}")
        a = load_torch_checkpoint(os.path.join(tmp, "plain", "stage2_final", "state.pt"))
        b = load_torch_checkpoint(os.path.join(tmp, "nccl", "stage2_final", "state.pt"))
        if not all(torch.equal(t, b["params"][tw][n]) for tw, sd in a["params"].items()
                   for n, t in sd.items()):
            raise AssertionError("train --coordinator: the saved parameters differ")

        # evaluate --shard on phase 3f's samples and checkpoint
        captured, gs = [], PP.generate_sharded

        def capture(*args, **kw):
            imgs = gs(*args, **kw)
            captured.append(imgs)
            return imgs

        PP.generate_sharded = capture
        try:
            out = os.path.join(tmp, "shard.json")
            reset_counts()
            t0 = time.perf_counter()
            M.main(["evaluate", "--shard", "--checkpoint", eval_ctx["ck"], "--data-root",
                    eval_ctx["root"], "--max-samples", str(EVAL_SAMPLES), "--steps",
                    str(SHARD_EVAL_STEPS), "--output", out])
            shard_s = time.perf_counter() - t0
        finally:
            PP.generate_sharded = gs
        with open(out) as f:
            res = json.load(f)
        pipe = load_pipeline(cfg, eval_ctx["ck"], device="cuda")
        tok = CLIPTokenizer(max_length=cfg.diffusion.clip_text.max_length)
        ds = AudioCapsLatentDataset(eval_ctx["root"], split="test",
                                    audio_duration=cfg.data.duration_s,
                                    sample_rate=cfg.data.sample_rate,
                                    latent_hw=cfg.data.latent_shape[1])
        if len(captured) != EVAL_SAMPLES or not res["config"]["shard"]:
            raise AssertionError(f"evaluate --shard: {len(captured)} groups, {res['config']}")
        for i, imgs in enumerate(captured):
            item = ds[i]
            want = pipe.generate(item["audio"], tok(item["caption"]), tok(""),
                                 num_steps=SHARD_EVAL_STEPS, seed=42, seeds=[42])
            if not np.array_equal(imgs, want):
                raise AssertionError(f"evaluate --shard: sample {i} differs from "
                                     f"generate(seeds=[42]) by {image_diff(imgs, want)}")
        del pipe
        dist.destroy_process_group()
        PD._INITIALIZED = False
    finally:
        T.train_step = inner
        shutil.rmtree(tmp, ignore_errors=True)
    step_s = {k: [r["seconds"] for r in v] for k, v in runs.items()}
    row = {"phase": "nccl_one_rank", "card": card, "micro_steps": DIST_STEPS,
           "micro_step_s": step_s, "run_stage_wall_s": walls,
           "launches_per_micro_step": launches, "losses_last": runs["nccl"][-1]["losses"],
           "bit_equal": True, "evaluate_shard_s": shard_s, "evaluate_shard_timings":
           res["timings"], "evaluate_shard_images_bit_equal": EVAL_SAMPLES}
    log(row)
    return row


def gloo_worker(rank, port, out, data_root):
    """One rank of phase 6c (``chip_smoke.py --gloo-rank R PORT OUT DATA``)."""
    import torch.distributed as dist

    # Gloo, since NCCL refuses a second rank on one card; run_stage's own
    # initialize_distributed then finds the group and leaves it as it is
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    cfg = C.Config()
    records = []
    T.train_step = record_steps(records)
    reset_counts()
    T.run_stage(cfg, 2, init_params(cfg, seed=0, device="cuda"), data_root=data_root,
                max_steps=DIST_STEPS, checkpoint_dir=os.path.join(out, "ck"),
                log_dir=os.path.join(out, f"logs{rank}"), seed=0)
    # what run_stage's preemption agreement costs a micro-step: one MAX
    # all-reduce of one integer on the host
    flag, flag_s = torch.zeros(1, dtype=torch.int64), []
    for _ in range(50):
        t0 = time.perf_counter()
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        flag_s.append(time.perf_counter() - t0)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"records": records, "device": str(torch.cuda.current_device()),
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "flag_allreduce_ms_median": 1e3 * float(np.median(flag_s))}, f)
    return 0


def gloo_phase(data_root, card):
    """Phase 6c: two data-parallel ranks of stage 2 on the one card over
    Gloo, replicas and losses compared after every micro-step."""
    tmp = tempfile.mkdtemp(prefix="c2d_gloo_")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-rank",
                               str(r), port, tmp, data_root], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    outs = []
    t0 = time.perf_counter()
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    try:
        if any(p.returncode for p in procs):
            text = "\n".join(o[-3000:] for o in outs)
            raise AssertionError(f"phase 6c: a rank failed:\n{text}")
        ranks = []
        for r in (0, 1):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = (x["records"] for x in ranks)
    if len(a) != DIST_STEPS or len(b) != DIST_STEPS:
        raise AssertionError(f"phase 6c: {len(a)} and {len(b)} micro-steps")
    for i, (x, y) in enumerate(zip(a, b)):
        if x["losses"] != y["losses"] or x["digest"] != y["digest"]:
            raise AssertionError(f"phase 6c micro-step {i}: the ranks differ: {x} {y}")
    launches = step_launches(a)
    step_launches(b)
    row = {"phase": "gloo_two_ranks", "card": card, "micro_steps": DIST_STEPS,
           "devices": [x["device"] for x in ranks], "wall_s": wall,
           "micro_step_s": [[r["seconds"] for r in x["records"]] for x in ranks],
           "peak_mem_gb": [x["peak_mem_gb"] for x in ranks],
           "flag_allreduce_ms_median": [x["flag_allreduce_ms_median"] for x in ranks],
           "launches_per_micro_step": launches, "losses": [r["losses"] for r in a],
           "replicas_bit_identical": True}
    log(row)
    return row


# Phase 3d: a 50-step request makes 751 flash, 2,279 GN+SiLU and 801 GN
# launches (batch 1 or 2); phase 5c's 10-step request 151, 479 and 161.
REQUEST_LAUNCHES = {50: (751, 2279, 801), 10: (151, 479, 161)}
TEXT = "rain on a tin roof, distant thunder"


def write_float_wav(path, x, sr=48_000):
    """A mono IEEE-float WAV, so that ``load_audio`` gives back ``x``'s bits."""
    data = np.asarray(x, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, sr, sr * 4, 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(data)) + data)
    return path


def image_diff(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"max_abs_diff": int(d.max()), "mean_abs_diff": float(d.mean()),
            "frac_differing": float((d > 0).mean()), "bit_equal": bool(d.max() == 0)}


def hold(name, got, want, verdicts):
    """Record whether ``got`` equals ``want`` bit for bit; ``settle`` raises
    at the end of the phase, so that one run shows every comparison."""
    if got.shape != want.shape or got.dtype != np.uint8:
        verdicts[name] = {"fault": f"image {got.shape} {got.dtype}, want {want.shape}"}
        return
    verdicts[name] = image_diff(got, want)
    if not verdicts[name]["bit_equal"]:
        verdicts[name]["fault"] = "other bits"


def settle(phase, verdicts):
    faults = {k: v for k, v in verdicts.items() if "fault" in v}
    if faults:
        raise AssertionError(f"{phase}: {faults}")


def launches_since(before):
    after = counts()
    return tuple(after[k] - before[k]
                 for k in ("flash_attention", "group_norm_silu", "group_norm"))


def upstream_artifacts(pipe, out_dir):
    """Phase 3's weights in the published layouts: diffusers UNet and VAE
    and HF CLIP text (``text_model.``) as .safetensors, an HF ClapModel's
    audio tower (``audio_model.``, with text-tower keys and logit scales
    the converter skips) as .bin, the reference's nested .pth for the
    hierarchical encoder (with its level_prior and temperature buffers) and
    the adapter. Returns the converter's flags."""
    p = pipe.params
    paths = {k: os.path.join(out_dir, name) for k, name in (
        ("sd-unet", "diffusion_pytorch_model.safetensors"),
        ("sd-vae", "vae.safetensors"), ("clip-text", "model.safetensors"),
        ("clap", "clap_model.bin"), ("hierarchical", "hierarchical_v4_final.pth"),
        ("adapter", "audio_projector_stage2.pth"))}
    save_safetensors(paths["sd-unet"], {k: v for k, v in p["unet"].items()
                                        if not k.startswith("audio_inject.")})
    save_safetensors(paths["sd-vae"], p["vae"])
    clip = {"text_model." + k: v for k, v in p["clip_text"].items()}
    clip["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    save_safetensors(paths["clip-text"], clip)
    clap = {("audio_model." + k if k.startswith("audio_encoder.") else k): v.cpu()
            for k, v in p["clap_audio"].items()}
    clap.update({"text_model.embeddings.position_ids": torch.arange(514)[None],
                 "text_projection.linear1.weight": torch.zeros(512, 768),
                 "logit_scale_a": torch.tensor(2.0), "logit_scale_t": torch.tensor(2.0)})
    torch.save(clap, paths["clap"])
    hier = {k: v.cpu() for k, v in p["hierarchical"].items()}
    hier.update({"decomposer.level_prior": torch.tensor([0.5, 0.3, 0.2]),
                 "decomposer.temperature": torch.tensor(2.0)})
    torch.save({"step": 0, "hierarchical_state_dict": hier}, paths["hierarchical"])
    torch.save({"adapter_state_dict": {k: v.cpu() for k, v in p["adapter"].items()}},
               paths["adapter"])
    return [a for k, path in paths.items() for a in (f"--{k}", path)]


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def http(port, path, body=None):
    """(JSON or text answer, wall seconds) of one request to the server."""
    url = f"http://127.0.0.1:{port}{path}"
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        raw = r.read()
    wall = time.perf_counter() - t0
    return (json.loads(raw) if path != "/healthz" else raw.decode()), wall


def png_of(b64):
    return decode_png(base64.b64decode(b64))


@contextlib.contextmanager
def running(service):
    server = serve(service=service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def checkpoint_phase(pipe, wav, text, uncond, first_img, seeds_img, card, keep):
    """Phase 3d: phase 3's weights written in the published layouts, the
    port's converter tool, ``apps.main infer --checkpoint`` and the HTTP
    server over ``load_pipeline``, each image held against phase 3's or
    3c's bits, with exact launch counts. The converted checkpoint is moved
    to ``keep``'s ``pipeline`` (phase 7b loads it)."""
    tmp = tempfile.mkdtemp(prefix="c2d_ckpt_")
    verdicts, rows = {}, {}
    try:
        up = os.path.join(tmp, "upstream")
        os.makedirs(up)
        t0 = time.perf_counter()
        flags = upstream_artifacts(pipe, up)
        rows["upstream_write_s"] = time.perf_counter() - t0
        rows["upstream_bytes"] = dir_bytes(up)
        ck = os.path.join(tmp, "pipeline")
        t0 = time.perf_counter()
        if port_tool.main([*flags, "--out", ck]) != 0:
            raise AssertionError("convert_checkpoints failed")
        rows["convert_s"] = time.perf_counter() - t0
        rows["checkpoint_bytes"] = dir_bytes(ck)

        wav_path = write_float_wav(os.path.join(tmp, "phase3.wav"), wav)
        if not np.array_equal(pipe.load_audio(wav_path), wav):
            raise AssertionError("load_audio does not give phase 3's waveform back")
        png = os.path.join(tmp, "infer.png")
        before, t0 = counts(), time.perf_counter()
        M.main(["infer", "--checkpoint", ck, "--dtype", "bfloat16", "--audio", wav_path,
                "--text", TEXT, "--steps", "50", "--seed", "0", "--output", png])
        rows["cli_infer_s"] = time.perf_counter() - t0  # load + request + PNG
        got = launches_since(before)
        if got != REQUEST_LAUNCHES[50]:
            raise AssertionError(f"infer --checkpoint: launches {got}, want {REQUEST_LAUNCHES[50]}")
        with open(png, "rb") as f:
            hold("cli_infer_vs_phase3", decode_png(f.read()), first_img[0], verdicts)
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        loaded = load_pipeline(pipe.cfg, ck, dtype=torch.bfloat16, device=pipe.device)
        torch.cuda.synchronize()
        rows["load_pipeline_s"] = time.perf_counter() - t0
        with open(wav_path, "rb") as f:
            audio = base64.b64encode(f.read()).decode()
        req = {"audio_b64": audio, "text": TEXT, "steps": 50, "cfg": 7.5, "seed": 0}
        served = []
        with running(InferenceService(pipe=loaded)) as port:
            if http(port, "/healthz")[0] != "ok":
                raise AssertionError("/healthz")
            before = counts()
            out, wall = http(port, "/generate", req)
            served.append({"request": "generate", "wall_s": wall, "launches": launches_since(before),
                           "fetch_wait_s": out["info"]["fetch_wait_s"]})
            hold("server_generate_vs_phase3", png_of(out["image_b64"]), first_img[0], verdicts)
            before = counts()
            out, wall = http(port, "/generate_batch", {
                "requests": [{"audio_b64": audio, "text": TEXT, "seed": 7},
                             {"audio_b64": audio, "text": TEXT, "seed": 5}],
                "steps": 50, "cfg": 7.5})
            served.append({"request": "generate_batch", "wall_s": wall,
                           "launches": launches_since(before),
                           "fetch_wait_s": out["info"]["fetch_wait_s"]})
            batch_imgs = np.stack([png_of(b) for b in out["images_b64"]])
            hold("server_generate_batch_vs_phase3c", batch_imgs, seeds_img, verdicts)
            metrics = http(port, "/metrics")[0]
        if metrics["requests"] != 2 or metrics["errors"] or metrics["images"] != 3:
            raise AssertionError(f"/metrics: {metrics}")

        # two sounds (phase 3's and 3c's second, reversed) from two clients,
        # folded into one batch of two with per-lane seeds
        wav2_path = write_float_wav(os.path.join(tmp, "second.wav"),
                                    np.ascontiguousarray(waveform(seed=2)[::-1]))
        with open(wav2_path, "rb") as f:
            audio2 = base64.b64encode(f.read()).decode()
        sounds = {21: (audio, wav_path), 22: (audio2, wav2_path)}
        service = InferenceService(pipe=loaded, coalesce_ms=500, coalesce_max_batch=2)
        pair = {}
        with running(service) as port:
            def post(seed):
                pair[seed] = http(port, "/generate",
                                  dict(req, seed=seed, audio_b64=sounds[seed][0]))

            before = counts()
            threads = [threading.Thread(target=post, args=(s,)) for s in sounds]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            got = launches_since(before)
            metrics2 = http(port, "/metrics")[0]
        if len(pair) != 2:
            raise AssertionError("a coalesced request did not answer")
        lanes = sorted(pair, key=lambda s: pair[s][0]["info"]["coalesced_lane"])
        for s in lanes:
            info = pair[s][0]["info"]
            served.append({"request": f"coalesced seed {s}", "wall_s": pair[s][1],
                           "coalesced_batch": info["coalesced_batch"],
                           "lane": info["coalesced_lane"], "fetch_wait_s": info["fetch_wait_s"]})
            if info["coalesced_batch"] != 2:
                raise AssertionError(f"coalesced request {s}: {info}")
        if got != REQUEST_LAUNCHES[50]:
            raise AssertionError(f"coalesced pair: launches {got}, want {REQUEST_LAUNCHES[50]}")
        want = loaded.generate(
            waveform=np.stack([loaded.load_audio(sounds[s][1]) for s in lanes]), seeds=lanes,
            text_ids=np.repeat(text, 2, 0), uncond_ids=np.repeat(uncond, 2, 0),
            guidance_scale=7.5, num_steps=50, batch=2)
        hold("server_coalesced_vs_generate_seeds",
             np.stack([png_of(pair[s][0]["image_b64"]) for s in lanes]), want, verdicts)
        if metrics2["requests"] != 2 or metrics2["errors"] or \
                metrics2["coalesce"]["batches"] != 1:
            raise AssertionError(f"/metrics of the coalescing server: {metrics2}")
        for row in served:
            if "launches" in row and row["launches"] != REQUEST_LAUNCHES[50]:
                raise AssertionError(f"served request: {row}")
        del loaded
        torch.cuda.empty_cache()
        shutil.move(ck, os.path.join(keep, "pipeline"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log({"phase": "checkpoint_entry_points", "card": card, **rows, "served": served,
         "images": verdicts, "metrics": metrics, "coalescing_metrics": metrics2})
    settle("phase 3d", verdicts)
    return rows, served


def export_phase(cfg, ckdir, trained_hier, wav, card):
    """Phase 5c: ``apps.main export`` of the final stage-2 checkpoint to
    .pth and .safetensors, both read back through the converter to the
    trained ``hierarchical`` tower bit for bit; then one 10-step ``infer
    --stage-checkpoint --ema`` request with its launch counts."""
    tmp = tempfile.mkdtemp(prefix="c2d_export_")
    try:
        stage = os.path.join(ckdir, "stage2_final")
        pth, st = os.path.join(tmp, "stage2.pth"), os.path.join(tmp, "stage2.safetensors")
        t0 = time.perf_counter()
        for out in (pth, st):
            M.main(["export", "--stage-checkpoint", stage, "--out", out])
        export_s = time.perf_counter() - t0
        flat = load_safetensors(st)
        reads = {
            "pth": unwrap(load_torch_checkpoint(pth), "hierarchical_state_dict"),
            "safetensors": {k[len("hierarchical."):]: v for k, v in flat.items()
                            if k.startswith("hierarchical.")},
        }
        for fmt, sd in reads.items():
            back = convert_hierarchical_encoder(sd, cfg.condition)
            if sorted(back) != sorted(trained_hier) or not all(
                    torch.equal(back[k], trained_hier[k]) for k in back):
                raise AssertionError(f"export {fmt}: the hierarchical tower does not read back")
        wav_path = write_float_wav(os.path.join(tmp, "a.wav"), wav)
        png = os.path.join(tmp, "ema.png")
        before, t0 = counts(), time.perf_counter()
        M.main(["infer", "--stage-checkpoint", stage, "--ema", "--audio", wav_path,
                "--text", TEXT, "--steps", "10", "--output", png])
        wall = time.perf_counter() - t0
        got = launches_since(before)
        with open(png, "rb") as f:
            img = decode_png(f.read())
        size = cfg.diffusion.image_size
        if got != REQUEST_LAUNCHES[10] or img.shape != (size, size, 3) or img.std() == 0:
            raise AssertionError(f"infer --stage-checkpoint --ema: launches {got}, "
                                 f"image {img.shape} std {img.std()}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log({"phase": "export_way_back", "card": card, "export_s": export_s,
         "tensors": len(flat), "infer_stage_ema_s": wall, "launches": got})


# Phase 3e: best-of-n. The candidates run as one batch of BEST_OF_N (CFG
# batch 8), which makes as many launches as a batch of 1; the CLIP vision
# tower attends with the plain matmul path (the JAX tower calls mha without
# use_flash) and has no GroupNorm, so a 50-step best-of request makes 751 /
# 2,279 / 801 launches.
BEST_OF_N = 4
# CLIPScore points (0-100) between the path's scores (CLIP text in bf16, the
# vision tower in fp32) and the same towers' fp32 run. A score moves by at
# most 100 |t16 - t32| (unit image features), and the full-width CLIP text
# encoder's bf16 and fp32 text features differ by |t16 - t32| = 9.9e-3 on
# random weights (a CPU run of the two); over 1,000 random unit image
# features the largest move was 0.13 points.
SCORE_TOL = 1.0
# Phase 3f: four test samples of 10 s; the metric towers launch no kernel of
# the port (plain attention, convs, BatchNorm), so run_evaluation makes four
# 50-step requests' launches.
EVAL_SAMPLES = 4
# the metric towers on the card against the CPU, fp32 with TF32 off, per
# output of max|cpu|: the summation order of 12-24 layers of matmuls or 94
# convs (the largest seen in the CPU tests' fp32 towers is ~1e-6)
TOWER_TOL = 1e-3
# Phase 5d: stage 2 with LoRA (rank 8) at batch 4, launches per micro-step
# (flash forward, flash backward, GN+SiLU, GN). Without remat: phase 5's 15
# and 14, and the UNet forward's 45 and 16 (22 resnets x 2 + conv_norm_out;
# 16 transformers); LoRA adds only matmuls. With remat every ResnetBlock and
# Transformer2D whose output the backward needs is recomputed in the
# backward, its kernels launched again: every block but down block 0's first
# resnet (its inputs depend only on the latent, the timestep and frozen
# weights, as for the 14 backwards), so +21 x 2 GN+SiLU, +16 GN and the 15
# self-attentions (every one of them sits in a recomputed Transformer2D);
# the backward launches as before (tests/test_torch_lora.py counts the
# same recompute at the tiny size).
LORA_RANK = 8
LORA_STEPS = 8
LORA_STEP_LAUNCHES = {False: {"flash_attention": 15, "flash_attention_bwd": 14,
                              "group_norm_silu": 45, "group_norm": 16},
                      True: {"flash_attention": 30, "flash_attention_bwd": 14,
                             "group_norm_silu": 87, "group_norm": 32}}
LOSS_TOL = 1e-3  # remat on vs off, per micro-step, of max(1, |loss|)


def random_tower(module_cls, args, seed, dtype, he=False, dev="cuda"):
    """A tower's state dict drawn on the card from ``seed`` by the
    pipeline's rule (``random_init_``), in ``dtype``; ``he`` scales the conv
    kernels by sqrt(2) so that activations keep their scale through ReLUs."""
    with torch.device("meta"):
        m = module_cls(*args)
    m.to_empty(device=dev)
    random_init_(m, torch.Generator(device=dev).manual_seed(seed), _special_init(C.Config()))
    sd = {k: v.detach() for k, v in m.state_dict().items()}
    if he:
        sd = {k: v * 2 ** 0.5 if v.dim() == 4 else v for k, v in sd.items()}
    return {k: v.to(dtype) for k, v in sd.items()}


def best_of_phase(pipe, wav, text, uncond, checked, p50, card, dev="cuda"):
    """Phase 3e: ``generate_best_of(4)`` at full width with random CLIP
    vision weights and text projection (bf16, seed 0): the candidates
    against ``generate(seeds, batch=4)`` bit for bit, the winner the
    argmax, the scores against the towers' fp32 run, exact launches, the
    kernels at the new shapes, and one ``/generate`` with ``best_of: 2``
    against ``generate_best_of(2)``."""
    cfg = pipe.cfg
    n = BEST_OF_N
    t0 = time.perf_counter()
    pipe.extra_params["clip_vision"] = random_tower(
        CLIPVisionEncoder, (cfg.diffusion.clip_vision,), 0, torch.bfloat16, dev=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    width = cfg.diffusion.clip_text.hidden_size
    pipe.extra_params["clip_text_projection"] = {"weight": (torch.randn(
        cfg.diffusion.clip_vision.projection_dim, width, device=dev, generator=gen)
        / width ** 0.5).bfloat16()}
    towers_s = time.perf_counter() - t0
    captured = {}
    real = pipe._dispatch_generate

    def spy(**kw):
        captured["handle"] = real(**kw)
        return captured["handle"]

    pipe._dispatch_generate = spy
    try:
        reset_counts()
        torch.cuda.synchronize()
        before, t0 = counts(), time.perf_counter()
        best, scores = pipe.generate_best_of(n, waveform=wav, text_ids=text, uncond_ids=uncond,
                                             num_steps=50, guidance_scale=7.5, seed=0)
        wall = time.perf_counter() - t0
        got = launches_since(before)
    finally:
        del pipe._dispatch_generate
    seen = {fn.__name__: dict(fn.shapes) for fn in (fa.flash_attention, gn.group_norm_silu,
                                                    gn.group_norm)}
    if got != REQUEST_LAUNCHES[50]:
        raise AssertionError(f"best-of {n}: launches {got}, want {REQUEST_LAUNCHES[50]}")
    cands = captured["handle"].numpy()
    t0 = time.perf_counter()
    want = pipe.generate(waveform=wav, text_ids=np.repeat(text, n, 0),
                         uncond_ids=np.repeat(uncond, n, 0), seeds=list(range(n)), batch=n,
                         num_steps=50, guidance_scale=7.5)
    generate_wall = time.perf_counter() - t0
    verdicts = {}
    hold("candidates_vs_generate_seeds", cands, want, verdicts)
    winner = int(np.argmax(scores))
    hold("winner_is_the_argmax", best, cands[winner], verdicts)
    if scores.shape != (n,) or not np.isfinite(scores).all():
        raise AssertionError(f"best-of scores {scores}")

    # the same towers in fp32 (the vision tower's own type on the path; the
    # CLIP text encoder and the projection upcast) on the same candidates
    with torch.inference_mode():
        vision = build_tower(CLIPVisionEncoder, cfg.diffusion.clip_vision,
                             pipe.extra_params["clip_vision"], dev)
        text32 = copy.deepcopy(pipe.clip_text).float()
        ids = torch.as_tensor(np.asarray(text, np.int32), device=dev)
        feats = vision(preprocess_images_device(torch.from_numpy(cands).to(dev),
                                                cfg.diffusion.clip_vision.image_size))
        tf = clip_text_features(text32(ids), ids,
                                pipe.extra_params["clip_text_projection"]["weight"].float())
        ref = torch.clamp((feats * tf).sum(-1) * 100.0, min=0.0).cpu().numpy()
    del vision, text32
    score_err = float(np.abs(scores - ref).max())
    if score_err > SCORE_TOL:
        raise AssertionError(f"best-of scores {scores} vs the fp32 run {ref}: {score_err:.3g} "
                             f"> {SCORE_TOL}")
    errs, fresh = check_new_shapes(seen, checked, torch.Generator(device=dev).manual_seed(5))

    # the server: best_of 2 bypasses the coalescer, answers the winner and
    # the scores of generate_best_of(2)
    tmp = tempfile.mkdtemp(prefix="c2d_bestof_")
    try:
        wav_path = write_float_wav(os.path.join(tmp, "a.wav"), wav)
        with open(wav_path, "rb") as f:
            audio = base64.b64encode(f.read()).decode()
        with running(InferenceService(pipe=pipe)) as port:
            before = counts()
            out, server_wall = http(port, "/generate", {"audio_b64": audio, "text": TEXT,
                                                        "steps": 50, "cfg": 7.5, "seed": 0,
                                                        "best_of": 2})
            server_launches = launches_since(before)
        best2, scores2 = pipe.generate_best_of(2, waveform=pipe.load_audio(wav_path),
                                               text_ids=text, uncond_ids=uncond, num_steps=50,
                                               guidance_scale=7.5, seed=0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    hold("server_best_of_2_vs_generate_best_of_2", png_of(out["image_b64"]), best2, verdicts)
    if out["info"]["clip_scores"] != [round(float(v), 4) for v in scores2] or \
            server_launches != REQUEST_LAUNCHES[50]:
        raise AssertionError(f"server best_of 2: {out['info']}, launches {server_launches}; "
                             f"generate_best_of(2) scores {scores2}")
    log({"phase": "best_of", "card": card, "n": n, "wall_s": wall, "p50_s": p50,
         "wall_over_p50": wall / p50, "generate_batch_wall_s": generate_wall,
         "server_best_of_2_wall_s": server_wall, "towers_draw_s": towers_s,
         "scores": scores.tolist(), "fp32_scores": ref.tolist(), "score_err": score_err,
         "score_tol": SCORE_TOL, "winner": winner, "launches": got,
         "server_launches": server_launches, "images": verdicts,
         "shapes_first_checked_here": fresh, "errs": errs})
    settle("phase 3e", verdicts)
    return {"launches": got, "errs": errs}


def tower_vs_cpu(name, fn_card, fn_cpu):
    """A metric tower's fp32 outputs on the card against the CPU's."""
    got, want = fn_card(), fn_cpu()
    worst = 0.0
    for key in want:
        a, b = got[key].float().cpu(), want[key].float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} {key}: non-finite output on the card")
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if err > TOWER_TOL:
            raise AssertionError(f"{name} {key}: card vs CPU {err:.3g} of max|cpu| > {TOWER_TOL}")
        worst = max(worst, err)
    return worst


def evaluation_phase(pipe, frames, card, p50, dev="cuda", samples=EVAL_SAMPLES, steps=50):
    """Phase 3f: ``run_evaluation`` at full width on 4 test samples of 10 s
    with random CLIP vision (phase 3e's), Inception v3 (torchvision
    variant) and CLAP text weights drawn on the card, ``frames`` as PNG
    reference frames; every metric computed and finite, exact launches,
    each metric tower against its fp32 CPU output on 2 inputs, and the
    ``evaluate`` CLI on the same data, whose directory (``tmp``: the data
    ``root`` and the checkpoint ``ck``) the caller removes."""
    from clap2diffusion_tpu_torch.eval.evaluate import run_evaluation
    from clap2diffusion_tpu_torch.models.clap.text import ClapTextTower
    from clap2diffusion_tpu_torch.models.inception_v3 import (
        InceptionV3,
        build_inception,
        preprocess_images_inception_device,
    )
    from clap2diffusion_tpu_torch.models.roberta_tokenizer import RobertaTokenizer
    from clap2diffusion_tpu_torch.utils.png import encode_png

    cfg = pipe.cfg
    tmp = tempfile.mkdtemp(prefix="c2d_eval_")
    try:
        root = os.path.join(tmp, "data")
        fe = cfg.clap.frontend
        meta = make_fixture_dataset(root, n_train=0, n_val=0, n_test=samples,
                                    duration_s=fe.duration_s, sample_rate=fe.sample_rate,
                                    latent_hw=cfg.diffusion.image_size // 8)
        os.makedirs(os.path.join(root, "frames"))
        for smp, img in zip(meta["samples"], frames):
            with open(os.path.join(root, "frames", f"{smp['id']}.png"), "wb") as f:
                f.write(encode_png(img))
        params = {**pipe.params,
                  "clap_text": random_tower(ClapTextTower, (cfg.clap.text,), 1, torch.float32,
                                            dev=dev),
                  "inception_v3": random_tower(InceptionV3, (), 2, torch.float32, he=True,
                                               dev=dev)}
        reset_counts()
        torch.cuda.synchronize()
        before, t0 = counts(), time.perf_counter()
        res = run_evaluation(cfg, data_root=root, max_samples=samples, num_steps=steps,
                             seed=42, params=params, device=dev)
        wall = time.perf_counter() - t0
        got = launches_since(before)
        want = tuple(samples * k for k in REQUEST_LAUNCHES[steps])
        if got != want:
            raise AssertionError(f"run_evaluation: launches {got}, want {want}")
        s = res["summary"]
        values = {"fid": s.get("fid"), "kid": (s.get("kid") or {}).get("mean"),
                  "frechet_clip_vision": s.get("frechet_clip_vision"),
                  "kid_clip_vision": (s.get("kid_clip_vision") or {}).get("mean"),
                  "inception_score": (s.get("inception_score") or {}).get("mean"),
                  "clip_score": (s.get("clip_score") or {}).get("mean"),
                  "audio_text_alignment": (s.get("audio_text_alignment") or {}).get("mean")}
        if any(v is None or not np.isfinite(v) for v in values.values()) or \
                len(res["samples"]) != samples or res["clap_text_random_init"]:
            raise AssertionError(f"run_evaluation: metrics {values}, {len(res['samples'])} "
                                 f"samples, clap_text_random_init {res['clap_text_random_init']}")

        # each metric tower on the card against its fp32 CPU output, 2 inputs
        two = torch.from_numpy(np.stack(frames[:2]))
        size = cfg.diffusion.clip_vision.image_size
        towers = {}
        vis = {d: build_tower(CLIPVisionEncoder, cfg.diffusion.clip_vision,
                              params["clip_vision"], d) for d in (dev, "cpu")}
        with torch.inference_mode():
            towers["clip_vision"] = tower_vs_cpu(
                "clip_vision",
                lambda: {"features": vis[dev](preprocess_images_device(two.to(dev), size))},
                lambda: {"features": vis["cpu"](preprocess_images_device(two, size))})
            inc = {d: build_inception(params["inception_v3"], d) for d in (dev, "cpu")}
            towers["inception_v3"] = tower_vs_cpu(
                "inception_v3",
                lambda: inc[dev](preprocess_images_inception_device(two.to(dev))),
                lambda: inc["cpu"](preprocess_images_inception_device(two)))
            rt = RobertaTokenizer()([smp["caption"] for smp in meta["samples"][:2]])
            ids, mask = (torch.from_numpy(rt[k]) for k in ("input_ids", "attention_mask"))
            txt = {}
            for d in (dev, "cpu"):
                with torch.device("meta"):
                    txt[d] = ClapTextTower(cfg.clap.text)
                txt[d].to_empty(device=d).load_state_dict(
                    {k: v.to(d) for k, v in params["clap_text"].items()})
            towers["clap_text"] = tower_vs_cpu(
                "clap_text", lambda: {"embedding": txt[dev](ids.to(dev), mask.to(dev))},
                lambda: {"embedding": txt["cpu"](ids, mask)})
        del vis, inc, txt

        # the evaluate CLI on the same data, from a checkpoint of the same weights
        ck = os.path.join(tmp, "ck")
        from clap2diffusion_tpu_torch.diffusion.pipeline import save_pipeline

        save_pipeline(ck, params)
        out = os.path.join(tmp, "results.json")
        t0 = time.perf_counter()
        M.main(["evaluate", "--checkpoint", ck, "--data-root", root, "--max-samples",
                str(samples), "--steps", str(steps), "--output", out, "--device", str(dev)])
        cli_wall = time.perf_counter() - t0
        with open(out) as f:
            cli = json.load(f)
        cli_diff = {k: abs(cli["summary"][k]["mean"] - s[k]["mean"])
                    for k in ("audio_text_alignment", "clip_score", "image_std")}
        if [r["id"] for r in cli["samples"]] != [r["id"] for r in res["samples"]] or \
                any(v > 1e-4 * max(1.0, abs(s[k]["mean"])) for k, v in cli_diff.items()):
            raise AssertionError(f"evaluate CLI: {cli['summary']} vs run_evaluation {s}")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    log({"phase": "evaluation", "card": card, "samples": samples, "wall_s": wall,
         "p50_s": p50, "timings": res["timings"], "metrics": values, "launches": got,
         "tower_card_vs_cpu_of_max": towers, "tower_tol": TOWER_TOL,
         "evaluate_cli_wall_s": cli_wall, "evaluate_cli_vs_run_evaluation": cli_diff,
         "stamps": {k: res[k] for k in ("tokenizer_fallback", "roberta_fallback",
                                        "clap_text_random_init")}})
    # the data and the checkpoint stay for phase 6b's evaluate --shard (the
    # caller removes ``tmp``)
    return {"launches": got, "timings": res["timings"], "metrics": values, "root": root,
            "ck": ck, "tmp": tmp}


def lora_remat_phase(train_params, data_root, out_dir, wav, text, uncond, card, dev="cuda",
                     base=None):
    """Phase 5d: stage 2 with LoRA (rank 8) at batch 4, one update a micro-step, LORA_STEPS
    micro-steps with remat off, then the same with it on, from the same
    state and seed: losses, exact launches, A and B moved, frozen leaves
    unchanged, peak memory and micro-step time; then the remat run's final
    checkpoint folded from its EMA shadow and served for 10 steps, and its
    export read back without the fold."""
    from clap2diffusion_tpu_torch.models.condition.export import export_hierarchical_encoder
    from clap2diffusion_tpu_torch.train.checkpoint import load_payload, merge_stage_params
    from clap2diffusion_tpu_torch.train.lora import init_lora, merge_lora, target_names

    # one update a micro-step and no warmup: A's gradient is zero until B
    # has moved (B starts at zero), and with stage 2's grad_accum 4 and its
    # 100-step warmup the second update moves A by less than fp32 resolves
    base = base or C.Config()
    off = dataclasses.replace(base, train=dataclasses.replace(
        base.train, stage2=dataclasses.replace(base.train.stage2, lora_rank=LORA_RANK,
                                               grad_accum=1, warmup_steps=0)))
    on = dataclasses.replace(off, diffusion=dataclasses.replace(
        off.diffusion, unet=dataclasses.replace(off.diffusion.unet, remat=True)))
    first = init_lora(train_params["unet"], LORA_RANK,
                      torch.Generator(device=dev).manual_seed(0 + 0x10A5),
                      alpha=off.train.stage2.lora_alpha)
    ckdir = os.path.join(out_dir, "lora_ckpt")
    runs = {}
    for remat, cfg in ((False, off), (True, on)):
        torch.cuda.empty_cache()
        baseline_gb = torch.cuda.memory_allocated() / 2 ** 30
        state, steps, wall, peak = train_phase(cfg, train_params, 2, LORA_STEPS, data_root,
                                               os.path.join(out_dir, f"lora_remat_{remat}"),
                                               checkpoint_dir=ckdir if remat else None)
        want = LORA_STEP_LAUNCHES[remat]
        for i, rec in enumerate(steps):
            got = {k: rec["launches"][k] for k in want}
            if got != want or not all(np.isfinite(v) for v in rec["losses"].values()):
                raise AssertionError(f"LoRA stage 2 (remat {remat}) micro-step {i}: launches "
                                     f"{got}, want {want}; losses {rec['losses']}")
        trainable = S.make_stage2_step(cfg).trainable
        for tw in ("hierarchical", "unet"):
            for n, t in state.params[tw].items():
                if not trainable(f"{tw}.{n}") and not torch.equal(t.detach(), train_params[tw][n]):
                    raise AssertionError(f"LoRA stage 2 (remat {remat}): frozen {tw}.{n} changed")
        lora = {k: v.detach().clone() for k, v in state.params["lora"].items()}
        moved_a = sum(not torch.equal(lora[k], first[k]) for k in first if k.endswith(".a"))
        moved_b = sum(bool(lora[k].abs().max() > 0) for k in first if k.endswith(".b"))
        if not (moved_a and moved_b) or not torch.equal(lora["alpha"], first["alpha"]):
            raise AssertionError(f"LoRA stage 2 (remat {remat}): A moved {moved_a}, B moved "
                                 f"{moved_b}, alpha {lora['alpha']}")
        step_s = [r["seconds"] for r in steps]
        runs[remat] = {"losses": [r["losses"]["total"] for r in steps], "lora": lora,
                       "micro_step_s": step_s, "median_micro_step_s": statistics.median(step_s[2:]),
                       "peak_mem_gb": peak, "baseline_mem_gb": baseline_gb,
                       "run_stage_wall_s": wall,
                       "launches_per_step": steps[-1]["launches"], "moved_a": moved_a,
                       "moved_b": moved_b}
        del state
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(runs[True]["losses"], runs[False]["losses"]))
    if loss_err > LOSS_TOL:
        raise AssertionError(f"LoRA stage 2: remat on vs off losses differ by {loss_err:.3g}")
    losses_equal = runs[True]["losses"] == runs[False]["losses"]
    lora_equal = all(torch.equal(runs[True]["lora"][k], runs[False]["lora"][k])
                     for k in runs[True]["lora"])

    # the remat run's final checkpoint: the EMA shadow's adapters folded into
    # the UNet, served for 10 steps
    stage_dir = os.path.join(ckdir, "stage2_final")
    payload = load_payload(ckdir, "stage2_final")
    merged = merge_stage_params(train_params, payload, 2, use_ema=True, dtype=torch.bfloat16)
    if "lora" in merged:
        raise AssertionError("merge_stage_params returned the adapter tower")
    shadow = {**payload["params"]["lora"],
              **{k[len("lora."):]: v for k, v in payload["ema_params"].items()
                 if k.startswith("lora.")}}
    name = target_names(train_params["unet"])[0]
    # the stage's tensors are cast to bf16 and folded into the base weights
    # as the base holds them (fp32 here), as the JAX merge does
    folded = merge_lora({name: train_params["unet"][name]},
                        {k: v.to(dev, torch.bfloat16) for k, v in shadow.items()
                         if k == "alpha" or k.startswith(name)})
    if not torch.equal(merged["unet"][name], folded[name]):
        raise AssertionError(f"merge_stage_params(use_ema=True): {name} is not the EMA fold")
    fold_moved = sum(not torch.equal(merged["unet"][k], train_params["unet"][k])
                     for k in target_names(train_params["unet"]))
    serve_pipe = AudioToImagePipeline(off, params=merged, device=dev)
    del merged
    before, t0 = counts(), time.perf_counter()
    img = serve_pipe.generate(waveform=wav, text_ids=text, uncond_ids=uncond, num_steps=10,
                              guidance_scale=7.5, seed=0)
    serve_wall = time.perf_counter() - t0
    got = launches_since(before)
    if got != REQUEST_LAUNCHES[10] or img.std() == 0:
        raise AssertionError(f"LoRA-folded request: launches {got}, image std {img.std()}")
    del serve_pipe

    # export: the reference's formats hold the trained conditioning towers
    # and the injection processors; the adapters are not folded (no UNet body)
    tmp = tempfile.mkdtemp(prefix="c2d_lora_export_")
    try:
        pth = os.path.join(tmp, "stage2.pth")
        M.main(["export", "--stage-checkpoint", stage_dir, "--out", pth])
        nested = load_torch_checkpoint(pth)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sections = sorted(k for k in nested if k.endswith("_state_dict"))
    want_hier = export_hierarchical_encoder(payload["params"]["hierarchical"])
    if sections != ["hierarchical_state_dict", "unet_adapter_state_dict"] or any(
            "lora" in k or "attn2" in k for k in nested["unet_adapter_state_dict"]) or not all(
            torch.equal(nested["hierarchical_state_dict"][k].cpu(), v.cpu())
            for k, v in want_hier.items()):
        raise AssertionError(f"LoRA stage-2 export: sections {sections}")
    log({"phase": "lora_remat", "card": card, "rank": LORA_RANK, "micro_steps": LORA_STEPS,
         "batch": off.train.stage2.batch_size,
         **{f"remat_{'on' if r else 'off'}": {k: v for k, v in runs[r].items() if k != "lora"}
            for r in (False, True)},
         "loss_max_rel_diff": loss_err, "losses_bit_equal": losses_equal,
         "adapters_bit_equal": lora_equal, "ema_fold_changed_weights": fold_moved,
         "folded_request_s": serve_wall,
         "folded_request_launches": got, "export_sections": sections})
    return runs


# -- phase 7: W8A8 serving, the int8 weight wire, the port's tools ----------------

# One full-width UNet forward's int8 products under C2D_INT8=1, at JAX's
# sites: 46 Conv1x1 (proj_in and proj_out of 16 transformers, 14
# conv_shortcut), 6 products in each of the 16 transformers (self-attention's
# fused q/k/v and to_out, cross-attention's q and to_out, the feed-forward's
# two) and the 47 Conv3x3 whose widths pass the gate (not conv_in, conv_out).
INT8_GEMMS_PER_FORWARD = 189
INT8_ORDER = (True, False, False, True, True, False)  # int8 requests among default ones
INT8_COS_MIN = 0.99  # int8 eps against fp eps (JAX's tests/test_quant.py)
TOOLS_STEPS = 8  # stage-2 micro-steps with and without the embeddings cache
CACHE_LOSS_TOL = 1e-2  # first loss, cache against towers, of max(1, |loss|): fp16 text_ctx


def int8_census(unet, args):
    """The int8 products of one UNet forward under C2D_INT8=1:
    {("matmul", x shape, N, bias) or ("conv", x shape, Cout): calls}."""
    seen = {}
    lin, conv = pq.linear_q, pq.conv_q

    def rec_lin(x, xq, sx, wq, sw, bias=None):
        key = ("matmul", tuple(x.shape), wq.shape[0], bias is not None)
        seen[key] = seen.get(key, 0) + 1
        return lin(x, xq, sx, wq, sw, bias)

    def rec_conv(x, wq, sw, bias):
        key = ("conv", tuple(x.shape), wq.shape[0])
        seen[key] = seen.get(key, 0) + 1
        return conv(x, wq, sw, bias)

    pq.linear_q, pq.conv_q = rec_lin, rec_conv
    try:
        with flag("C2D_INT8"), torch.inference_mode():
            unet(*args)
        torch.cuda.synchronize()
    finally:
        pq.linear_q, pq.conv_q = lin, conv
    return seen


def int8_vs_cpu(census):
    """``int8_matmul`` and ``int8_conv`` on the card against the same
    functions on the CPU at every census shape (bf16 inputs from a CPU
    generator), at tolerance 0: the int32 products are exact and the fp32
    divisions and products correctly rounded on both. Raises naming the
    shape."""
    gen = torch.Generator().manual_seed(7)
    rows = []
    for key in sorted(census, key=str):
        if key[0] == "matmul":
            _, xs, n, has_bias = key
            w = (torch.randn(n, xs[-1], generator=gen) * xs[-1] ** -0.5).bfloat16()
            fn = pq.int8_matmul
        else:
            _, xs, n = key
            has_bias = True
            w = (torch.randn(n, xs[-1], 3, 3, generator=gen) * (9 * xs[-1]) ** -0.5).bfloat16()
            fn = pq.int8_conv
        x = torch.randn(xs, generator=gen).bfloat16()
        b = (torch.randn(n, generator=gen) * 0.1).bfloat16() if has_bias else None
        t0 = time.perf_counter()
        on_card = fn(x.cuda(), w.cuda(), None if b is None else b.cuda()).cpu()
        ref = fn(x, w, b)
        if on_card.dtype != ref.dtype or not torch.equal(on_card, ref):
            d = (on_card.float() - ref.float()).abs().max().item()
            raise AssertionError(f"{key[0]} at x {xs}, N {n}: card differs from the CPU "
                                 f"(max |d| {d:.3g})")
        rows.append({"kind": key[0], "x": list(xs), "n": n, "calls": census[key],
                     "check_s": time.perf_counter() - t0})
    return rows


def int8_kernels_in_trace(unet, args):
    """One UNet forward under C2D_INT8=1 in a profiler trace: the number of
    ``aten::_int_mm`` ops, the CUDA kernels launched under them (the int8
    GEMM) and how they were found, and the top kernels by count."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with flag("C2D_INT8"), torch.inference_mode(), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        unet(*args)
        torch.cuda.synchronize()
    events = prof.events()
    cuda = [e for e in events if e.device_type == DeviceType.CUDA]
    int_mm = [e for e in events if e.name == "aten::_int_mm"]

    def tally(names):
        out = {}
        for n in names:
            out[n] = out.get(n, 0) + 1
        return out

    def under_int_mm(e):
        parent = e.cpu_parent
        while parent is not None and parent.name != "aten::_int_mm":
            parent = parent.cpu_parent
        return parent is not None

    found, how = tally(e.name for e in cuda if under_int_mm(e)), "cpu_parent"
    if not found:  # kernels recorded on the CPU op
        found, how = tally(k.name for e in int_mm for k in getattr(e, "kernels", [])), "kernels"
    if not found:  # by name: cuBLASLt's int8 GEMMs
        found, how = tally(e.name for e in cuda if re.search(r"s8|i8|int8|imma", e.name)), "name"
    return {"int_mm_ops": len(int_mm), "gemm_kernels": found, "found_by": how,
            "cuda_kernels": len(cuda),
            "int8_gemm_device_ms": sum(e.device_time_total for e in cuda
                                       if e.name in found) / 1e3,
            "device_ms": sum(e.device_time_total for e in cuda) / 1e3,
            "top_kernels": sorted(tally(e.name for e in cuda).items(),
                                  key=lambda kv: -kv[1])[:12]}


def drop_int8_weights(unet):
    for m in unet.modules():
        if isinstance(getattr(m, "quant", None), pq.QuantCache):
            m.quant = pq.QuantCache()


def int8_phase(pipe, unet_args, wav, text, uncond, card):
    """Phase 7a: W8A8 serving at full width on phase 3's pipeline."""
    census = int8_census(pipe.unet, unet_args)
    calls = sum(census.values())
    if calls != INT8_GEMMS_PER_FORWARD:
        raise AssertionError(f"int8 sites: {calls} products in one forward, want "
                             f"{INT8_GEMMS_PER_FORWARD}: {census}")
    t0 = time.perf_counter()
    shapes = int8_vs_cpu(census)
    vs_cpu_s = time.perf_counter() - t0
    trace = int8_kernels_in_trace(pipe.unet, unet_args)
    gemm_launches = sum(trace["gemm_kernels"].values())
    log({"phase": "int8_trace", **trace})
    if trace["int_mm_ops"] != INT8_GEMMS_PER_FORWARD or gemm_launches < INT8_GEMMS_PER_FORWARD:
        raise AssertionError(f"int8 trace: {trace['int_mm_ops']} _int_mm ops, {gemm_launches} "
                             f"kernels under them; want {INT8_GEMMS_PER_FORWARD} each")

    with torch.inference_mode():
        fp = pipe.unet(*unet_args).float()
        with flag("C2D_INT8"):
            q = pipe.unet(*unet_args).float()
    cos = torch.nn.functional.cosine_similarity(q.flatten(), fp.flatten(), dim=0).item()
    if not torch.isfinite(q).all() or cos <= INT8_COS_MIN:
        raise AssertionError(f"int8 eps against fp eps: cosine {cos:.6f}")
    fwd_ms = {}
    for on in (False, True, True, False):
        with flag("C2D_INT8") if on else contextlib.nullcontext(), torch.inference_mode():
            fwd_ms.setdefault(on, []).append(time_ms(lambda: pipe.unet(*unet_args)))

    wall, imgs, per_request = {True: [], False: []}, {}, []
    reset_counts()
    pq.int8_gemm.reset()
    for i, on in enumerate(INT8_ORDER):
        before, gemms = counts(), pq.int8_gemm.calls
        with flag("C2D_INT8") if on else contextlib.nullcontext():
            t0 = time.perf_counter()
            img = pipe.generate(waveform=wav, text_ids=text, uncond_ids=uncond,
                                model_type="hierarchical", num_steps=50, guidance_scale=7.5,
                                seed=0)
            wall[on].append(time.perf_counter() - t0)
        got = launches_since(before)
        n_gemm = pq.int8_gemm.calls - gemms
        if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8 or img.std() == 0:
            raise AssertionError(f"int8-phase request {i}: image {img.shape} {img.dtype}")
        if got != REQUEST_LAUNCHES[50] or n_gemm != (50 * INT8_GEMMS_PER_FORWARD if on else 0):
            raise AssertionError(f"int8-phase request {i} (int8 {on}): launches {got}, "
                                 f"int8 products {n_gemm}")
        imgs.setdefault(on, []).append(img)
        per_request.append({"int8": on, "seconds": wall[on][-1], "launches": got,
                            "int8_products": n_gemm})
    launches = counts()
    drift = image_diff(imgs[True][0], imgs[False][0])
    repeat = {on: all(np.array_equal(im, ims[0]) for im in ims) for on, ims in imgs.items()}
    drop_int8_weights(pipe.unet)
    torch.cuda.empty_cache()
    out = {"card": card, "unet_forward_ms": {"int8": fwd_ms[True], "default": fwd_ms[False]},
           "p50_s": {"int8": statistics.median(wall[True]),
                     "default": statistics.median(wall[False])},
           "requests": per_request, "eps_cosine_int8_vs_fp": cos,
           "image_drift_vs_default": drift, "repeat_bit_equal": repeat,
           "products_per_forward": calls,
           "distinct_shapes": len(census), "card_vs_cpu_shapes": len(shapes),
           "card_vs_cpu_s": vs_cpu_s,
           "int8_request_launches": next(r["launches"] for r in per_request if r["int8"]),
           "launches_total": launches}
    log({"phase": "int8_serving", **out, "shapes": shapes})
    return out


def wire_phase(cfg, ck, wav, text, uncond, first_img, card):
    """Phase 7b: phase 3d's converted checkpoint (fp32) loaded in bf16 with
    and without C2D_INT8_WIRE=1: bytes and load seconds of each; the card's
    expanded towers equal to the CPU's expansion of the same payload at
    tolerance 0; one request of each, the wire's image drift logged."""
    from clap2diffusion_tpu_torch.utils import wire

    rows, kw = {}, dict(waveform=wav, text_ids=text, uncond_ids=uncond, num_steps=50,
                        guidance_scale=7.5, seed=0)
    for on in (False, True):
        with flag("C2D_INT8_WIRE") if on else contextlib.nullcontext():
            t0 = time.perf_counter()
            loaded = load_pipeline(cfg, ck, dtype=torch.bfloat16, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        before = counts()
        img = loaded.generate(**kw)
        got = launches_since(before)
        if got != REQUEST_LAUNCHES[50] or img.shape != (1, 512, 512, 3) or img.std() == 0:
            raise AssertionError(f"wire {on}: launches {got}, image {img.shape}")
        rows["wire" if on else "default"] = {"load_s": load_s, "stats": loaded.wire_stats,
                                             "image_vs_phase3": image_diff(img, first_img)}
        if on:
            host = P.restore_params_host(ck)
            host = {t: {k: v.to(torch.bfloat16) for k, v in sd.items()} for t, sd in host.items()}
            payload, stats = wire.quantize_wire(host, wire.tower_layouts(cfg, host))
            on_cpu = wire.dequantize_wire(payload, {t: torch.device("cpu") for t in payload})
            if stats != loaded.wire_stats:
                raise AssertionError(f"wire stats: {loaded.wire_stats} against the CPU's {stats}")
            for tower, sd in loaded.params.items():
                for k, t in sd.items():
                    want = on_cpu[tower][k]
                    if not torch.equal(t.cpu().to(want.dtype), want) or \
                            (tower not in P.FP32_TOWERS and t.dtype != want.dtype):
                        raise AssertionError(f"wire: {tower}.{k} on the card differs from the "
                                             "CPU's expansion")
            del host, payload, on_cpu
        del loaded
        torch.cuda.empty_cache()
    log({"phase": "int8_wire", "card": card, **rows})
    return rows


def tools_phase(cfg, params, data_root, out_dir, card):
    """Phase 7c: stage-2 micro-steps without the embeddings cache, the
    port's ``precompute_embeddings`` on phase 5's data, the same micro-steps
    with the cache (same seed: the first loss agrees within CACHE_LOSS_TOL);
    then ``run_lifecycle --scale 0.001 --skip-eval`` into a temporary root."""
    from clap2diffusion_tpu_torch.tools import run_lifecycle as RL
    from clap2diffusion_tpu_torch.tools.precompute_embeddings import precompute

    runs = {}
    for cached in (False, True):
        if cached:
            t0 = time.perf_counter()
            n_emb = precompute(cfg, params, data_root, device="cuda")
            torch.cuda.synchronize()
            precompute_s = time.perf_counter() - t0
        state, steps, wall, peak = train_phase(cfg, params, 2, TOOLS_STEPS, data_root,
                                               os.path.join(out_dir, f"cache_{cached}"))
        check_training(2, cfg, params, state, steps)
        del state
        runs[cached] = {"micro_step_s": [r["seconds"] for r in steps],
                        "median_after_first_s": statistics.median(
                            r["seconds"] for r in steps[1:]),
                        "launches_per_step": steps[-1]["launches"],
                        "first_loss": steps[0]["losses"]["total"], "run_stage_wall_s": wall}
    a, b = runs[False]["first_loss"], runs[True]["first_loss"]
    if abs(a - b) > CACHE_LOSS_TOL * max(1.0, abs(a)):
        raise AssertionError(f"first loss with the embeddings cache {b} against {a} without")
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="c2d_lifecycle_")
    try:
        reset_counts()
        t0 = time.perf_counter()
        if RL.main(["--scale", "0.001", "--skip-eval", "--root", root]) != 0:
            raise AssertionError("run_lifecycle failed")
        life_s = time.perf_counter() - t0
        with open(os.path.join(root, "lifecycle_summary.json")) as f:
            summary = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if set(summary["stages"]) != {"stage1", "stage2", "stage3"} or not all(
            np.isfinite(s.get("last_total", np.nan)) for s in summary["stages"].values()):
        raise AssertionError(f"run_lifecycle: {summary['stages']}")
    out = {"card": card, "embeddings_written": n_emb, "precompute_s": precompute_s,
           "without_cache": runs[False], "with_cache": runs[True],
           "lifecycle_wall_s": life_s, "lifecycle_budgets": summary["budgets"],
           "lifecycle_phases": {p["phase"]: p["wall_s"] for p in summary["phases"]},
           "lifecycle_stages": summary["stages"], "lifecycle_launches": counts()}
    log({"phase": "tools", **out})
    torch.cuda.empty_cache()
    return out


# Phase 8a: the shapes the measurement tools give the kernels, in this process
BENCH_SHAPE_BATCHES = (1, 2, 4, 8, 16)  # the coalescer's padded groups, the breakdown's batches
CLAP_ENCODE_BATCHES = (1, 8, 16)  # bench_breakdown's clap_encode
BENCH_SHAPE_STEPS = 2


def bench_shapes_phase(pipe, unet_args, wav, text, uncond, checked):
    """Phase 8a: drive phase 3's pipeline at the shapes phase 8's tools
    run (``generate`` at each of BENCH_SHAPE_BATCHES, the CLAP encode at
    CLAP_ENCODE_BATCHES, the UNet at 32x32 latents) and check each kernel
    against its plain version at every shape no earlier phase checked; the
    worst errors."""
    cfg = pipe.cfg
    reset_counts()
    t0 = time.perf_counter()
    for b in BENCH_SHAPE_BATCHES:
        img = pipe.generate(waveform=wav, text_ids=np.repeat(text, b, 0),
                            uncond_ids=np.repeat(uncond, b, 0), seeds=list(range(b)), batch=b,
                            num_steps=BENCH_SHAPE_STEPS, guidance_scale=7.5)
        if img.shape[0] != b or not np.isfinite(img).all():
            raise AssertionError(f"phase 8a: generate(batch={b}) gave {img.shape}")
    with torch.inference_mode():
        wav2d = np.asarray(wav, np.float32).reshape(1, -1)
        for b in CLAP_ENCODE_BATCHES:
            pipe._condition(pipe.encode_audio(np.repeat(wav2d, b, 0)), "hierarchical",
                            cfg.condition.audio_norm_target, 0.5)
        x, t, ctx, routed = unet_args
        lat = 256 // 8
        pipe.unet(torch.ones(x.shape[0], lat, lat, x.shape[-1], dtype=x.dtype, device=x.device),
                  t, ctx, routed)
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    seen = {fn.__name__: dict(fn.shapes) for fn in (fa.flash_attention, gn.group_norm_silu,
                                                    gn.group_norm)}
    t0 = time.perf_counter()
    errs, fresh = check_new_shapes(seen, checked, torch.Generator(device="cuda").manual_seed(8))
    log({"phase": "bench_shapes", "batches": BENCH_SHAPE_BATCHES,
         "clap_encode_batches": CLAP_ENCODE_BATCHES, "steps": BENCH_SHAPE_STEPS,
         "drive_s": drive_s, "check_s": time.perf_counter() - t0,
         "shapes": {k: len(v) for k, v in seen.items()},
         "shapes_first_checked_here": fresh, "errs": errs})
    torch.cuda.empty_cache()
    return errs


REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
TOOL_TIMEOUT_S = {"bench": 600, "bench_breakdown": 900, "bench_serving": 600, "bench_train": 300}
HEADLINE_KEYS = ["metric", "value", "unit", "vs_baseline"]
HEADLINE_METRIC = "p50 audio+text->512px image latency, 50-step DDIM+CFG, 1 chip"
SERVING_MAX_BATCH = 8  # bench_serving's default --max-batch


def run_tool(name):
    """``python -m clap2diffusion_tpu_torch.tools.<name>`` from the
    repository root, as a user runs it: (stdout, the JSON lines of stdout
    and of stderr, seconds). A tool that fails fails the phase."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"clap2diffusion_tpu_torch.tools.{name}"],
                          cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=TOOL_TIMEOUT_S[name])
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"tools.{name} exited {proc.returncode}:\n{proc.stderr[-4000:]}")

    def lines(text):
        return [json.loads(line) for line in text.splitlines() if line.startswith("{")]

    return proc.stdout, lines(proc.stdout), lines(proc.stderr), seconds


def bench_tools_phase(p50):
    """Phase 8: the port's four measurement tools on the card, each a
    process of its own with its defaults (the bench's ``.cache/params``
    weights are drawn by the first and read by the others)."""
    # the headline bench: the JAX bench's last line, this run's launch counts
    stdout, _, err, seconds = run_tool("bench")
    head = json.loads(stdout.strip().splitlines()[-1])
    if list(head) != HEADLINE_KEYS or head["metric"] != HEADLINE_METRIC \
            or head["unit"] != "s/image" or head["vs_baseline"] != round(2.0 / head["value"], 3):
        raise AssertionError(f"bench: headline {head}")
    diag = [line for line in err if line.get("diag") == "bench"][-1]
    got = tuple(diag["launches"][k] for k in ("flash_attention", "group_norm_silu", "group_norm"))
    if got != REQUEST_LAUNCHES[50]:
        raise AssertionError(f"bench: a request launched (flash, GN+SiLU, GN) {got}, "
                             f"want {REQUEST_LAUNCHES[50]}")
    if not diag["device_busy_s"] or diag["device_busy_s"] <= 0:
        raise AssertionError(f"bench: device busy {diag['device_busy_s']}")
    log({"phase": "bench", "seconds": seconds, "headline": head,
         "bench_wall_p50_s": diag["wall_p50_s"], "phase3_p50_s": p50,
         "bench_over_phase3": diag["wall_p50_s"] / p50,
         **{k: diag[k] for k in ("times", "device_busy_s", "idle_share", "device_events",
                                 "by_category_s", "launches", "build_s", "params_cache_hit",
                                 "warmup_s", "ttfi_s", "card", "power_limit")},
         **{k: diag[k] for k in ("load_s", "init_s") if k in diag}})

    # time by component and batch: configurations 1-4 on the card
    _, rows, _, seconds = run_tool("bench_breakdown")
    for r in rows:
        timed = [r["p50_ms"], r["min_ms"]] + ([r["device_ms"]] if "device_ms" in r else [])
        if not all(np.isfinite(t) and t > 0 for t in timed):
            raise AssertionError(f"bench_breakdown: {r}")
    names = {(r["component"], r["batch"]) for r in rows}
    want = {(c, b) for b in (1, 8, 16) for c in ("clap_encode", "unet_step_cfg",
                                                  "vae_decode_512", f"full_50step_b{b}")}
    if names != want | {("unet_step_256", 1)}:
        raise AssertionError(f"bench_breakdown: components {sorted(names)}")
    log({"phase": "bench_breakdown", "seconds": seconds, "rows": rows})

    # concurrent serving: pipelined against coalesced
    _, lines, _, seconds = run_tool("bench_serving")
    modes = {line["mode"]: line for line in lines if "mode" in line}
    if set(modes) != {"pipelined", "coalesced"} or not any("speedup" in line for line in lines):
        raise AssertionError(f"bench_serving: lines {lines}")
    for mode, line in modes.items():
        if line["served"] != line["requested"] or line["png_shapes"] != [[512, 512, 3]] \
                or not line["repeat_equal"] or line["max_coalesced_batch"] > SERVING_MAX_BATCH:
            raise AssertionError(f"bench_serving {mode}: {line}")
    if modes["pipelined"]["distinct_images"] != 1:
        raise AssertionError(f"bench_serving: equal batch-1 requests gave "
                             f"{modes['pipelined']['distinct_images']} images")
    log({"phase": "bench_serving", "seconds": seconds, "lines": lines})

    # configuration 5: stage-1 training
    _, lines, _, seconds = run_tool("bench_train")
    line = lines[-1]
    if not line["finite"] or not line["last_chunk_mean_loss"] < line["first_chunk_mean_loss"]:
        raise AssertionError(f"bench_train: {line}")
    log({"phase": "bench_train", **line, "seconds": seconds, "timed_chunks_s": line["seconds"]})


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
    train_params = init_params(train_cfg, seed=0, device="cuda")
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
    text, uncond = tok(TEXT), tok("")
    times, per_request, first_img, phase3_imgs = [], [], None, []
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
        phase3_imgs.append(img[0])
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

    # -- 3d. checkpoint and entry points at full width ---------------------------
    kept = tempfile.mkdtemp(prefix="c2d_kept_")  # phase 3d's checkpoint, for phase 7b
    checkpoint_phase(pipe, wav, text, uncond, first_img, gen_out["images"]["seeds"], card, kept)

    # -- 3e. best-of-n at full width ---------------------------------------------
    p50 = statistics.median(times[1:])
    best_out = best_of_phase(pipe, wav, text, uncond, checked, p50, card)
    for kind, err in best_out["errs"].items():
        errs[kind] = max(errs[kind], err)
    torch.cuda.empty_cache()

    # -- 3f. evaluation at full width --------------------------------------------
    eval_out = evaluation_phase(pipe, phase3_imgs + [gen_out["images"]["sonic"][0]], card, p50)
    # the CLIP towers of 3e and the scorer built from them are released, so
    # that the later phases' peak memory compares with earlier runs'
    pipe.extra_params.clear()
    pipe._scorer = None
    torch.cuda.empty_cache()

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
    ckdir = os.path.join(tmp, "ckpt")
    state, steps2, wall2, peak2 = train_phase(train_cfg, train_params, 2, TRAIN_STEPS,
                                              data_root, tmp, checkpoint_dir=ckdir)
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
    trained_hier = {k: v.detach().cpu().clone() for k, v in state.params["hierarchical"].items()}
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

    # -- 5c. the way back: export, re-ingest, infer --stage-checkpoint --ema ----
    export_phase(train_cfg, ckdir, trained_hier, wav, card)
    torch.cuda.empty_cache()

    # -- 5d. stage 2 with LoRA adapters, remat off then on ------------------------
    lora_runs = lora_remat_phase(train_params, data_root, tmp, wav, text, uncond, card)
    missing = set(fa.flash_attention_bwd.shapes) - {
        k for k in rows["flash_attention_bwd"] if "bfloat16" in k[2]}
    if missing:
        raise AssertionError(f"flash_attention_bwd: LoRA/remat shapes not checked: {missing}")
    torch.cuda.empty_cache()

    # -- 6. small training reference: fp32 step on the card vs the CPU --------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref6 = small_training_reference()
    log({"phase": "train_reference", **ref6, "tolerance": TRAIN_REL_TOL, "ok": True})

    # -- 6a. prepare and encode on the card ------------------------------------
    frames = (phase3_imgs + [im for imgs in gen_out["images"].values() for im in imgs])
    prep = prepare_phase(frames[:ENCODE_FRAMES], checked, card)
    for kind, err in prep["errs"].items():
        errs[kind] = max(errs[kind], err)
    torch.cuda.empty_cache()

    # -- 6b. one rank over NCCL: train --coordinator, evaluate --shard ----------
    nccl = nccl_phase(train_cfg, data_root, eval_out, card)
    shutil.rmtree(eval_out["tmp"], ignore_errors=True)
    torch.cuda.empty_cache()

    # -- 6c. two data-parallel ranks on the one card over Gloo -------------------
    gloo = gloo_phase(data_root, card)
    torch.cuda.empty_cache()

    # -- 7a. W8A8 serving (C2D_INT8=1) at full width ---------------------------------
    int8 = int8_phase(pipe, unet_args, wav, text, uncond, card)

    # -- 7b. the int8 weight wire (C2D_INT8_WIRE=1) -----------------------------------
    wire_phase(cfg, os.path.join(kept, "pipeline"), wav, text, uncond, first_img, card)
    shutil.rmtree(kept, ignore_errors=True)

    # -- 7c. the port's tools: precompute_embeddings, run_lifecycle ------------------
    tools = tools_phase(train_cfg, train_params, data_root, tmp, card)
    shutil.rmtree(tmp, ignore_errors=True)

    # -- 8a. the tools' shapes, checked in this process -------------------------------
    for kind, err in bench_shapes_phase(pipe, unet_args, wav, text, uncond, checked).items():
        errs[kind] = max(errs[kind], err)

    # -- 8. the measurement tools, each as a user runs it ---------------------------
    torch.cuda.empty_cache()  # the tools' processes share the card with this one
    bench_tools_phase(p50)

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
    for i, (kind, (route, src, replaces)) in enumerate(meta.items()):
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
            "best_of_launches": best_out["launches"][i],
            "evaluation_launches": eval_out["launches"][i],
            "lora_remat_launches_per_micro_step": lora_runs[True]["launches_per_step"][
                "flash_attention" if kind == "flash_attention_fwd" else kind],
            "prepare_encode_launches": prep["launches"][
                "flash_attention" if kind == "flash_attention_fwd" else kind],
            "process_group_launches_per_micro_step": nccl["launches_per_micro_step"][
                "flash_attention" if kind == "flash_attention_fwd" else kind],
            "int8_request_launches": int8["int8_request_launches"][i],
            "lifecycle_launches": tools["lifecycle_launches"][
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
        "lora_remat_launches_per_micro_step": lora_runs[True]["launches_per_step"][
            "flash_attention_bwd"],
        "process_group_launches_per_micro_step": nccl["launches_per_micro_step"][
            "flash_attention_bwd"],
        "gloo_two_ranks_launches_per_micro_step": gloo["launches_per_micro_step"][
            "flash_attention_bwd"],
        "lifecycle_launches": tools["lifecycle_launches"]["flash_attention_bwd"],
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
        "device_ms": packed_sum("device_ms"), "library_device_ms": packed_sum("library_device_ms"),
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
        "device_ms": wino_sum("device_ms"), "library_device_ms": wino_sum("library_device_ms"),
        "filter_ms": wino_sum("filter_ms"),
        "per": "UNet forward (batch 2, bf16), eligible Conv3x3 shapes",
        "bench": [{k: rows_w[(xs, co, dt)][k] for k in
                   ("x", "cout", "dtype", "blocks", "kernel_ms", "device_ms", "entry_ms",
                    "filter_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
                    "bound_by")}
                  for xs, co in BENCH_WINO_SHAPES for dt in ("torch.bfloat16", "torch.float32")],
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:  # one rank of phase 6c
        sys.exit(gloo_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]))
    sys.exit(main())
