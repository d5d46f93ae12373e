"""Where one request's time goes on the card.

    python -m clap2diffusion_tpu_torch.tools.trace_request [--steps 50] [--out DIR]

Builds the full SD v1.5 stack (random bf16 weights from seed 0), serves one
warm-up request, then:
  1. times each stage of one request on the host clock, each ending in
     ``torch.cuda.synchronize()``: log-mel + CLAP tower, hierarchical
     conditioning, CLIP text, the DDIM loop (and so one step), VAE decode;
  2. profiles one whole request (on the card one replay of its CUDA graph,
     ``diffusion/program.py``) with ``torch.profiler`` and sums the device
     events of its chrome trace (kernels, memcpy, memset) by category; the
     device's idle share is 1 - kernel time / the unprofiled request's wall
     time (the profiler slows the host, not the kernels).
Prints one JSON line per result, with the card's name and power limit.
With ``--out`` the profiler's chrome trace is kept there (gzip); without,
it passes through ``build/trace/`` and is deleted.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import os
import time

import numpy as np
import torch

from clap2diffusion_tpu_torch.ops.cuda_build import build_dir
from clap2diffusion_tpu_torch.tools import bench_common

CATEGORIES = (
    ("flash_attention", ("flash_fwd",)),
    ("groupnorm", ("group_norm_fwd",)),
    ("convolution", ("fprop", "conv", "implicit", "nhwc")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
    ("layer_norm", ("layer_norm",)),
    ("elementwise_reduce", ("elementwise", "vectorized", "reduce")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other"


def summarise_trace(events) -> dict:
    """The device events of a chrome trace's ``traceEvents`` (kernels,
    memcpy, memset; durations in µs) summed by ``CATEGORIES``: launches,
    busy seconds, seconds and launches by category, the top kernels and
    the events of each kernel name."""
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_cat, calls, kernels = {}, {}, {}
    for e in device:
        cat = _category(e["name"])
        by_cat[cat] = by_cat.get(cat, 0.0) + e["dur"] / 1e6
        calls[cat] = calls.get(cat, 0) + 1
        kernels[e["name"][:90]] = kernels.get(e["name"][:90], 0.0) + e["dur"] / 1e6
    return {"launches": len(device), "device_kernel_s": sum(by_cat.values()),
            "by_category_s": by_cat, "launches_by_category": calls,
            "top_kernels": sorted(kernels.items(), key=lambda kv: -kv[1])[:12],
            "calls_by_kernel": dict(collections.Counter(
                e["name"][:90] for e in device if e.get("cat") == "kernel"))}


def device_summary(prof, out_dir=None) -> dict:
    """``summarise_trace`` of a finished ``torch.profiler`` run, read from
    its chrome trace; with ``out_dir`` the trace is kept there (gzip),
    without, it passes through ``build/trace/`` and is deleted."""
    out = out_dir or os.path.join(os.path.dirname(build_dir()), "trace")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"trace_request_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            trace = json.load(f)
        if out_dir:
            with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
                g.write(f.read())
    finally:
        os.remove(path)
    return summarise_trace(trace["traceEvents"] if isinstance(trace, dict) else trace)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> None:
    from clap2diffusion_tpu_torch.core.config import Config
    from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline
    from clap2diffusion_tpu_torch.models.clap.frontend import log_mel_spectrogram
    from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = bench_common.card(torch.device("cuda"))
    cfg = Config()
    pipe = AudioToImagePipeline(cfg, seed=0, dtype=torch.bfloat16)
    tok = CLIPTokenizer(max_length=cfg.diffusion.clip_text.max_length)
    rng = np.random.default_rng(0)
    wav = (rng.normal(size=cfg.clap.frontend.num_samples) * 0.1).astype(np.float32)
    text, uncond = tok("rain on a tin roof"), tok("")
    kw = dict(waveform=wav, text_ids=text, uncond_ids=uncond, num_steps=args.steps, seed=0)
    pipe.generate(**kw)  # warm-up: kernel builds, cuDNN plans, allocator

    # 1. stages, each synchronised
    stages = {}
    with torch.inference_mode():
        wf = torch.as_tensor(wav[None], device=pipe.device)
        emb, stages["logmel_clap_s"] = _timed(
            lambda: pipe.clap_audio(log_mel_spectrogram(wf, cfg.clap.frontend)))
        (t77, routed), stages["conditioning_s"] = _timed(
            lambda: pipe._condition(emb, "hierarchical", 60.0, 0.5))
        ids = torch.as_tensor(np.concatenate([text, uncond]), device=pipe.device)
        ehs, stages["clip_text_s"] = _timed(lambda: pipe.clip_text(ids))
        from clap2diffusion_tpu_torch.diffusion.ddim import cfg_eps_fn, ddim_sample

        eps_fn = cfg_eps_fn(pipe.unet, ehs[:1], ehs[1:], 7.5, routed, routed)
        size = cfg.diffusion.image_size // 8
        lat = pipe.draws(0).latents((1, size, size, 4)).to(pipe.compute_dtype)
        lat, stages["ddim_loop_s"] = _timed(
            lambda: ddim_sample(eps_fn, pipe.schedule, lat, args.steps))
        _, stages["vae_decode_s"] = _timed(lambda: pipe.vae.decode_latent(lat))
    stages["per_unet_step_s"] = stages["ddim_loop_s"] / args.steps
    _, stages["request_s"] = _timed(lambda: pipe.generate(**kw))
    print(json.dumps({"stages": stages, "steps": args.steps, "card": card}), flush=True)

    # 2. profiler over one request; kernel time from the trace's device events
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(lambda: pipe.generate(**kw))
    summary = device_summary(prof, args.out)
    print(json.dumps({
        "launches": summary["launches"], "device_kernel_s": summary["device_kernel_s"],
        "request_s_unprofiled": stages["request_s"],
        "device_idle_share": 1 - summary["device_kernel_s"] / stages["request_s"],
        "profile_wall_s": wall, "by_category_s": summary["by_category_s"],
        "launches_by_category": summary["launches_by_category"],
        "top_kernels": summary["top_kernels"], "card": card,
    }), flush=True)


if __name__ == "__main__":
    main()
