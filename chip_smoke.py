#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py            # from the repository root

Phases (each raises on failure, so the exit code is non-zero):
  1. Environment and build: the card's name and power limit, the nvcc builds
     of the flash-attention forward and backward kernels (in parallel) and
     the Triton import, timed.
  2. A census UNet forward (CFG batch 2) and VAE decode at full SD v1.5
     geometry record the shapes the serving path gives each kernel; then
     every kernel is held against its plain PyTorch version at each of those
     shapes, in bf16 and fp32, plus ragged sequence lengths, and timed
     beside its roofline bound and one PyTorch library call.
  2b. A census stage-2 micro-step (batch 4) and stage-3 micro-step (batch 2)
     record the training path's shapes; the flash-attention backward kernel
     is held against its plain version at each (bf16 and fp32) and at ragged
     shapes (Sq != Sk, S off the tile, d = 8 and 16), run twice for
     bit-identical results, and timed beside its bound, the plain version
     and autograd through ``scaled_dot_product_attention``. A forward that
     writes the log-sum-exp must give the same bits as one that does not.
     The GroupNorm Functions' gradients are held against autograd of
     ``plain_group_norm``, and the GroupNorm kernels against their plain
     version at the training shapes.
  3. The serving path: 3 requests through ``AudioToImagePipeline.generate``
     (hierarchical, 50-step DDIM, CFG 7.5, 512x512, bf16 weights drawn from
     a seeded torch.Generator, a 10 s 48 kHz synthetic waveform, hash
     tokenizer ids). Counts are reset just before and read just after: each
     request must launch flash 751 times and group_norm_silu 2,279 times.
  4. Reference check: a small configuration (flash and GroupNorm kernels
     on) in fp32 on the card against the same pipeline on the CPU (plain
     versions), under the frozen-golden bounds of tests/test_image_golden.py.
  5. The training path at full width: ``run_stage(Config(), 2, ...)`` on a
     fixture dataset (8 samples of 10 s at 48 kHz, [4, 64, 64] latents),
     random seeded fp32 master weights with bf16 compute, batch 4, grad
     accumulation 4, 16 micro-steps (4 updates); then 2 micro-steps of
     stage 3. Counts are reset just before each and read per micro-step.
  6. Small training reference: one stage-2 micro-step of the small
     configuration in fp32 on the card (TF32 off, kernels on) against the
     same step on the CPU: loss and the gradient of every trainable leaf.

Timing: CUDA events around repeated launches after a warm-up (inputs stay
in L2 where they fit, as they do on the path, where the producer just wrote
them). Bounds use the H100 SXM data-sheet rates: 989 TFLOP/s bf16 tensor,
67 TFLOP/s fp32, 3.35 TB/s HBM3. The line before the last two is the
``kernels`` JSON: the forward and GroupNorm times are per image (sum over
the serving path's calls of one image), the backward's per stage-2
micro-step. The last line is the device JSON.
"""

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
from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline
from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer
from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset
from clap2diffusion_tpu_torch.ops import cuda_build
from clap2diffusion_tpu_torch.ops import flash_attention as fa
from clap2diffusion_tpu_torch.ops import groupnorm as gn
from clap2diffusion_tpu_torch.train import stages as S
from clap2diffusion_tpu_torch.train import trainer as T

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


def flash_case(qs, ks, dtype, gen):
    q = torch.randn(qs, device="cuda", generator=gen).to(dtype)
    k = torch.randn(ks, device="cuda", generator=gen).to(dtype)
    v = torch.randn(ks, device="cuda", generator=gen).to(dtype)
    scale = qs[-1] ** -0.5
    name = f"flash {list(qs)} k{list(ks)} {str(dtype)[6:]}"
    got = fa.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    err = check(name, got, fa.plain_flash_attention(q, k, v, scale), dtype)
    # the UNet's layout: heads of a [B, S, H*D] projection, read through strides
    strided = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    if not torch.equal(fa.flash_attention(*strided, scale), got):
        raise AssertionError(f"{name}: strided [B,S,H,D] inputs give another result")
    b, h, sq, d = qs
    sk = ks[2]
    bms, by = bound_ms(4 * b * h * sq * sk * d, 2 * b * h * (sq + sk) * d * q.element_size(),
                       dtype)
    row = {"kernel": "flash_attention_fwd", "q": list(qs), "k": list(ks),
           "dtype": str(dtype)[6:], "max_abs_err": err,
           "kernel_ms": time_ms(lambda: fa.flash_attention(q, k, v, scale)),
           "plain_ms": time_ms(lambda: fa.plain_flash_attention(q, k, v, scale)),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
           "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by}
    log(row)
    return row


def gn_case(kind, shape, dtype, groups, eps, gen):
    silu = kind == "group_norm_silu"
    x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    c = shape[-1]
    w = (torch.randn(c, device="cuda", generator=gen) * 0.1 + 1).to(dtype)
    b = (torch.randn(c, device="cuda", generator=gen) * 0.1).to(dtype)
    fn = gn.group_norm_silu if silu else gn.group_norm
    name = f"{kind} {list(shape)} {str(dtype)[6:]} eps={eps}"
    got = fn(x, w, b, groups, eps)
    torch.cuda.synchronize()
    err = check(name, got, gn.plain_group_norm(x, w, b, groups, eps, silu), dtype)
    nchw = x.permute(0, 3, 1, 2)  # channels_last view: the same memory
    n = x.numel()
    bms, by = bound_ms((9 if silu else 5) * n, (2 * n + 2 * c) * x.element_size(),
                       torch.float32)
    library = time_ms(lambda: F.group_norm(nchw, groups, w, b, eps))
    row = {"kernel": kind, "x": list(shape), "dtype": str(dtype)[6:], "eps": eps,
           "max_abs_err": err, "kernel_ms": time_ms(lambda: fn(x, w, b, groups, eps)),
           "plain_ms": time_ms(lambda: gn.plain_group_norm(x, w, b, groups, eps, silu)),
           "library_ms": None if silu else library, "bound_ms": bms, "bound_us": bms * 1e3,
           "bound_by": by}
    if silu:  # no single PyTorch call computes GN+SiLU; two calls, for scale
        row["group_norm_then_silu_ms"] = time_ms(
            lambda: F.silu(F.group_norm(nchw, groups, w, b, eps)))
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


def bwd_case(qs, ks, dtype, gen, timed=True):
    """The backward kernel against its plain version at one shape."""
    q, k, v, do = (torch.randn(sh, device="cuda", generator=gen).to(dtype)
                   for sh in (qs, ks, ks, qs))
    scale = qs[-1] ** -0.5
    name = f"flash_bwd {list(qs)} k{list(ks)} {str(dtype)[6:]}"
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
        row.update({
            "kernel_ms": time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, scale)),
            "plain_ms": time_ms(lambda: fa.plain_flash_attention_bwd(q, k, v, o, do, scale)),
            "library_ms": time_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                              retain_graph=True)),
            "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by})
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


def reset_counts():
    for fn in (fa.flash_attention, fa.flash_attention_bwd, gn.group_norm_silu, gn.group_norm):
        fn.launches = 0
        fn.shapes.clear()


def counts():
    return {fn.__name__: fn.launches for fn in
            (fa.flash_attention, fa.flash_attention_bwd, gn.group_norm_silu, gn.group_norm)}


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
        census[number] = {fn.__name__: dict(fn.shapes) for fn in
                          (fa.flash_attention, fa.flash_attention_bwd, gn.group_norm_silu,
                           gn.group_norm)}
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


def check_training(stage_no, cfg, params, state, steps_log):
    """Finite losses, exact per-step launch counts, frozen leaves unchanged
    (bit for bit), trainable groups moved."""
    for i, rec in enumerate(steps_log):
        if not all(np.isfinite(v) for v in rec["losses"].values()):
            raise AssertionError(f"stage {stage_no} micro-step {i}: non-finite loss {rec}")
        want = (FLASH_FWD_PER_STEP, FLASH_BWD_PER_STEP)
        got = (rec["launches"]["flash_attention"], rec["launches"]["flash_attention_bwd"])
        if got != want:
            raise AssertionError(f"stage {stage_no} micro-step {i}: flash (fwd, bwd) launches "
                                 f"{got}, want {want}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 1
    card = smi()
    log(card)
    log({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    fa.build()
    gn.build()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "sources": ["flash_attention.cu", "flash_attention_bwd.cu"]})
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
    reset_counts()
    with torch.inference_mode():
        pipe.unet(torch.randn(2, lat, lat, 4, device="cuda", generator=gen).bfloat16(),
                  torch.tensor([981, 981], device="cuda"),
                  torch.randn(2, 77, 768, device="cuda", generator=gen).bfloat16(),
                  {lvl: torch.randn(2, 10, 768, device="cuda", generator=gen).bfloat16()
                   for lvl in ("early", "mid", "late")})
        pipe.vae.decode_latent(torch.randn(1, lat, lat, 4, device="cuda",
                                           generator=gen).bfloat16())
    torch.cuda.synchronize()
    census = {fn.__name__: dict(fn.shapes)
              for fn in (fa.flash_attention, gn.group_norm_silu, gn.group_norm)}

    rows = {"flash_attention_fwd": {}, "group_norm_silu": {}, "group_norm": {}}
    errs = {k: 0.0 for k in rows}
    for dtype in (torch.bfloat16, torch.float32):
        for (qs, ks, _) in census["flash_attention"]:
            r = flash_case(qs, ks, dtype, gen)
            rows["flash_attention_fwd"][(qs, ks, str(dtype))] = r
            errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], r["max_abs_err"])
        for qs, ks in (((1, 2, 1000, 40), (1, 2, 1000, 40)), ((2, 3, 300, 80), (2, 3, 777, 80)),
                       ((1, 1, 333, 512), (1, 1, 130, 512))):  # ragged tiles
            r = flash_case(qs, ks, dtype, gen)
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
    for dtype in (torch.bfloat16, torch.float32):
        for (qs, ks, _) in bwd_shapes:
            r = bwd_case(qs, ks, dtype, gen,
                         timed=(qs, ks, "torch.bfloat16") in tcensus[2]["flash_attention_bwd"])
            rows["flash_attention_bwd"][(qs, ks, str(dtype))] = r
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], r["max_abs_err"])
        for qs, ks in (((1, 2, 1000, 40), (1, 2, 1000, 40)), ((2, 3, 300, 80), (2, 3, 777, 80)),
                       ((1, 2, 130, 8), (1, 2, 65, 8)), ((1, 2, 70, 16), (1, 2, 300, 16)),
                       ((1, 2, 200, 160), (1, 2, 100, 160))):  # ragged tiles, small d
            r = bwd_case(qs, ks, dtype, gen, timed=False)
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], r["max_abs_err"])
        # d > 160 (the VAE) has no backward; its forward writes lse from column chunk 0
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

    # -- 3. the main path ----------------------------------------------------
    tok = CLIPTokenizer(max_length=cfg.diffusion.clip_text.max_length)
    wav = waveform()
    text, uncond = tok("rain on a tin roof, distant thunder"), tok("")
    times, per_request = [], []
    reset_counts()
    for i in range(REQUESTS):
        before = (fa.flash_attention.launches, gn.group_norm_silu.launches)
        t0 = time.perf_counter()
        img = pipe.generate(waveform=wav, text_ids=text, uncond_ids=uncond,
                            model_type="hierarchical", num_steps=50, guidance_scale=7.5,
                            seed=i)
        times.append(time.perf_counter() - t0)
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
    reset_counts()
    outs = [p._generate_from_latents(
        lat_s, wav_s[None], ids, np.zeros_like(ids), num_steps=3, guidance_scale=7.5,
        norm_target=60.0, temperature=0.5, model_type="hierarchical", batch=1).cpu().numpy()
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
        "group_norm_silu": ("triton", "clap2diffusion_tpu_torch/ops/groupnorm.py",
                            "clap2diffusion_tpu/ops/groupnorm.py:31"),
        "group_norm": ("triton", "clap2diffusion_tpu_torch/ops/groupnorm.py",
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
            "training_launches": train_launches[
                "flash_attention" if kind == "flash_attention_fwd" else kind],
        })
    # the backward per stage-2 micro-step: the census's calls, bf16
    per_step = tcensus[2]["flash_attention_bwd"]  # {(q, k, dtype): calls in one micro-step}
    rows_b = rows["flash_attention_bwd"]

    def per_step_sum(key):
        return sum(rows_b[k][key] * n for k, n in per_step.items())

    share = {"bytes": 0.0, "operations": 0.0}
    for k, n in per_step.items():
        share[rows_b[k]["bound_by"]] += n * rows_b[k]["bound_ms"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "clap2diffusion_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "clap2diffusion_tpu/ops/flash_attention.py:394",
        "launches": train_launches["flash_attention_bwd"],
        "max_abs_err": errs["flash_attention_bwd"],
        "ms": per_step_sum("kernel_ms"), "plain_ms": per_step_sum("plain_ms"),
        "bound_ms": per_step_sum("bound_ms"), "bound_by": max(share, key=share.get),
        "library_ms": per_step_sum("library_ms"), "per": "micro-step, bf16",
        "gn_backward_ms": {str(r["x"]): r["backward_ms"] for r in gn_grad_rows},
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
