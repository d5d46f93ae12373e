"""Where one stage-2 training micro-step's time goes on the card.

    python -m clap2diffusion_tpu_torch.tools.trace_train_step [--batch 4] [--out DIR]

Builds stage 2 at full SD v1.5 width (random fp32 master weights from seed
0, bf16 compute, ``Config()`` defaults) on one random batch (CLAP
embeddings, 64x64 latents, text contexts: the frontend is left out), runs
four warm-up micro-steps through ``train.stages.train_step``, then:
  1. times the parts of one micro-step on the host clock, each ending in
     ``torch.cuda.synchronize()``: the loss forward, the backward, the
     optimizer step with the EMA update, and the whole micro-step;
  2. profiles one micro-step with ``torch.profiler`` and sums the device
     events of its chrome trace by category (the flash backward, the flash
     forward, GroupNorm, convolution, matmul, ...); the device's
     idle share is 1 - device time / the unprofiled micro-step's wall time.
Prints one JSON line per result, with the card's name and power limit.
With ``--out`` the chrome trace is kept there (gzip).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess

import torch

from clap2diffusion_tpu_torch.ops.cuda_build import build_dir
from clap2diffusion_tpu_torch.tools.trace_request import CATEGORIES, _timed

TRAIN_CATEGORIES = (("flash_attention_bwd", ("flash_bwd", "bwd_delta")),) + CATEGORIES


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in TRAIN_CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other"


def main() -> None:
    from clap2diffusion_tpu_torch.core.config import Config
    from clap2diffusion_tpu_torch.train import stages as S
    from clap2diffusion_tpu_torch.train.optim import ema_update
    from clap2diffusion_tpu_torch.diffusion.pipeline import init_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = Config()
    params = init_params(cfg, seed=0, device="cuda")
    st = S.make_stage2_step(cfg)
    state = st.create_state({tw: params[tw] for tw in st.towers})
    del params
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, lat = args.batch, cfg.diffusion.image_size // 8
    batch = {"clap": torch.randn(b, cfg.condition.clap_dim, device="cuda", generator=gen),
             "latent": torch.randn(b, lat, lat, 4, device="cuda", generator=gen),
             "text_ctx": torch.randn(b, 77, cfg.diffusion.unet.cross_attention_dim,
                                     device="cuda", generator=gen)}
    for _ in range(4):  # warm-up: kernel builds, cuDNN plans, allocator
        S.train_step(st, state, batch, gen)

    # 1. parts of one micro-step, each synchronised
    parts = {}
    (total, _), parts["loss_forward_s"] = _timed(lambda: st.loss(state, batch, gen))
    leaves = state.trainable_leaves()
    grads, parts["backward_s"] = _timed(lambda: S.grads_of(total, leaves))

    def update():
        state.opt.step(grads)
        ema_update(state.ema, leaves, st.scfg.ema_decay)

    _, parts["optimizer_ema_s"] = _timed(update)
    del total, grads
    _, parts["micro_step_s"] = _timed(lambda: S.train_step(st, state, batch, gen))
    print(json.dumps({"parts": parts, "batch": b, "card": card,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)

    # 2. profiler over one micro-step; device time from the trace's events
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(lambda: S.train_step(st, state, batch, gen))
    out_dir = args.out or os.path.join(os.path.dirname(build_dir()), "trace")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace_train_step.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_cat, calls, kernels = {}, {}, {}
    for e in device:
        cat = _category(e["name"])
        by_cat[cat] = by_cat.get(cat, 0.0) + e["dur"] / 1e6
        calls[cat] = calls.get(cat, 0) + 1
        kernels[e["name"][:90]] = kernels.get(e["name"][:90], 0.0) + e["dur"] / 1e6
    busy = sum(by_cat.values())
    print(json.dumps({
        "launches": len(device), "device_kernel_s": busy,
        "micro_step_s_unprofiled": parts["micro_step_s"],
        "device_idle_share": 1 - busy / parts["micro_step_s"],
        "profile_wall_s": wall, "by_category_s": by_cat, "launches_by_category": calls,
        "top_kernels": sorted(kernels.items(), key=lambda kv: -kv[1])[:12],
        "card": card,
    }), flush=True)
    if args.out:
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
            g.write(f.read())
    os.remove(path)


if __name__ == "__main__":
    main()
