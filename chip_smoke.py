#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py            # from the repository root

Phases (each raises on failure, so the exit code is non-zero):
  1. Environment and build: the card's name and power limit, the nvcc build
     of the flash-attention kernel and the Triton import, timed.
  2. A census UNet forward (CFG batch 2) and VAE decode at full SD v1.5
     geometry record the shapes the main path gives each kernel; then every
     kernel is held against its plain PyTorch version at each of those
     shapes, in bf16 and fp32, plus ragged sequence lengths, and timed
     beside its roofline bound and one PyTorch library call.
  3. The main path: 3 requests through ``AudioToImagePipeline.generate``
     (hierarchical, 50-step DDIM, CFG 7.5, 512x512, bf16 weights drawn from
     a seeded torch.Generator, a 10 s 48 kHz synthetic waveform, hash
     tokenizer ids). Counts are reset just before and read just after: each
     request must launch flash 751 times and group_norm_silu 2,279 times.
  4. Reference check: a small configuration (flash and GroupNorm kernels
     on) in fp32 on the card against the same pipeline on the CPU (plain
     versions), under the frozen-golden bounds of tests/test_image_golden.py.

Timing: CUDA events around repeated launches after a warm-up (inputs stay
in L2 where they fit, as they do on the path, where the producer just wrote
them). Bounds use the H100 SXM data-sheet rates: 989 TFLOP/s bf16 tensor,
67 TFLOP/s fp32, 3.35 TB/s HBM3. The line before the last two is the
``kernels`` JSON, whose times are per image (sum over the main path's
calls of one image). The last line is the device JSON.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline
from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer
from clap2diffusion_tpu_torch.ops import flash_attention as fa
from clap2diffusion_tpu_torch.ops import groupnorm as gn

PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# kernel vs plain: |k - p| <= atol + rtol*|p|. bf16: both outputs are
# rounded to bf16 (2^-8 relative, one ulp apart at most where the fp32
# values straddle a rounding boundary), and the online softmax rounds P to
# bf16 against the running max, not the final one; fp32: summation order.
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
REQUESTS = 3
FLASH_PER_IMAGE = 751
GN_SILU_PER_IMAGE = 2279


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


def reset_counts():
    for fn in (fa.flash_attention, gn.group_norm_silu, gn.group_norm):
        fn.launches = 0
        fn.shapes.clear()


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
    log({"phase": "build", "seconds": time.perf_counter() - t0})

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
        counts = (fa.flash_attention.launches - before[0],
                  gn.group_norm_silu.launches - before[1])
        per_request.append(counts)
        if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8:
            raise AssertionError(f"request {i}: image {img.shape} {img.dtype}")
        if img.std() == 0:
            raise AssertionError(f"request {i}: constant image")
        if counts != (FLASH_PER_IMAGE, GN_SILU_PER_IMAGE):
            raise AssertionError(f"request {i}: launches (flash, gn_silu) = {counts}, "
                                 f"want ({FLASH_PER_IMAGE}, {GN_SILU_PER_IMAGE})")
        log({"phase": "request", "i": i, "seconds": times[-1], "image_mean": float(img.mean()),
             "image_std": float(img.std()), "flash_launches": counts[0],
             "group_norm_silu_launches": counts[1]})
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
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
