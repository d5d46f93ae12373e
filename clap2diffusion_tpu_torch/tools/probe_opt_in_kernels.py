"""Measurements behind the opt-in kernels' launch plans, on the card, and
the probe of wgmma's register operand.

    python -m clap2diffusion_tpu_torch.tools.probe_opt_in_kernels [--parts sweep,route,qreg]

  1. The Winograd kernel's device time against the split of its Cin loop, at
     five shapes of the UNet's census (bf16, batch 2): ``launch_plan``'s cost
     model (waves x (steps per split + a block's fixed cost)) was fitted to
     this sweep. The split is forced by replacing the cached plan for the
     duration of one measurement; four sets of inputs and weights rotate, so
     that U comes from device memory as in a real forward, and the launches
     are queued behind a long matrix product, so that the events time the
     device and not the host.
  2. One full-width UNet forward (CFG batch 2, bf16, random weights from
     seed 0) with ``C2D_PACKED_FLASH=1`` and without it, alternating, on the
     host clock to a synchronize: whether the packed route moves a forward.
  3. ``csrc/wgmma_probe.cu``: S = Q K^T over 8 key tiles with Q's wgmma A
     fragments held in registers across the loop (pinned after each wait,
     or not), at 3, 4 and 5 k16 steps (d = 48, 64, 80) and with 0, 160 and
     224 more fp32 registers a thread live across the loop, each against Q
     read from shared memory (bits), with the registers and spills ptxas
     reported for each instance.
Prints one JSON line per result, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import time
from unittest import mock

import torch

from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline
from clap2diffusion_tpu_torch.ops import cuda_build
from clap2diffusion_tpu_torch.ops import winograd_pallas as wp

SWEEP = [((2, 8, 8, 1280), 1280, (3, 4, 6, 7, 10, 12, 13, 16)),
         ((2, 16, 16, 1280), 1280, (1, 2, 3, 4, 6, 8)),
         ((2, 32, 32, 640), 640, (1, 2, 3, 4, 5)),
         ((2, 64, 64, 320), 320, (1, 2, 3)),
         ((2, 32, 32, 1280), 1280, (1, 2, 3, 4))]
FLAG = "C2D_PACKED_FLASH"


def device_ms(fn, busy, n: int = 40) -> float:
    """Mean device time of ``fn`` by CUDA events, its launches queued behind
    ``busy`` (a few ms of device work) so that the host runs ahead."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        busy()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def split_sweep(gen) -> None:
    big = torch.randn(8192, 8192, device="cuda", generator=gen)
    plan_of = wp._plan.__wrapped__
    for x_shape, cout, splits in SWEEP:
        cin = x_shape[-1]
        xs = [torch.randn(x_shape, device="cuda", generator=gen).bfloat16() for _ in range(4)]
        us = [wp.winograd_filter((torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
                                  / (9 * cin) ** 0.5).bfloat16(), torch.bfloat16)
              for _ in range(4)]
        turn = [0]

        def conv():
            turn[0] += 1
            wp.winograd_conv_fwd(xs[turn[0] % 4], us[turn[0] % 4])

        times = {}
        for split in splits:
            def forced(shape, co, dtype, split=split):
                plan = dict(plan_of(shape, co, dtype))
                b, h, w, _ = shape
                plan["split"] = split
                plan["partial_elems"] = split * b * h * w * co if split > 1 else 0
                return plan

            with mock.patch.object(wp, "_plan", forced):
                times[split] = device_ms(conv, lambda: big @ big)
        chosen = wp.launch_plan(x_shape, cout, torch.bfloat16)
        print(json.dumps({"probe": "winograd_split_sweep", "x": list(x_shape), "cout": cout,
                          "tile_blocks": chosen["grid"][0] * chosen["grid"][1],
                          "plan_split": chosen["split"], "device_ms_by_split": times}),
              flush=True)


def unet_route(gen, rounds: int = 3, per_round: int = 6) -> None:
    pipe = AudioToImagePipeline(C.Config(), seed=0, device="cuda", dtype=torch.bfloat16)
    args = (torch.randn(2, 64, 64, 4, device="cuda", generator=gen).bfloat16(),
            torch.tensor([981, 981], device="cuda"),
            torch.randn(2, 77, 768, device="cuda", generator=gen).bfloat16(),
            {lvl: torch.randn(2, 10, 768, device="cuda", generator=gen).bfloat16()
             for lvl in ("early", "mid", "late")})

    def forwards(on: bool, n: int):
        if on:
            os.environ[FLAG] = "1"
        else:
            os.environ.pop(FLAG, None)
        out = []
        with torch.inference_mode():
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe.unet(*args)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
        return out

    was = os.environ.get(FLAG)
    try:
        forwards(False, 2)
        forwards(True, 2)
        ms = {"off": [], "on": []}
        for _ in range(rounds):
            ms["off"] += forwards(False, per_round)
            ms["on"] += forwards(True, per_round)
    finally:
        os.environ.pop(FLAG, None)
        if was is not None:
            os.environ[FLAG] = was
    print(json.dumps({"probe": "unet_forward_packed_route", "forwards_each": rounds * per_round,
                      "median_ms": {k: statistics.median(v) for k, v in ms.items()},
                      "min_ms": {k: min(v) for k, v in ms.items()},
                      "max_ms": {k: max(v) for k, v in ms.items()}}), flush=True)


def qreg(gen, ntiles: int = 8) -> None:
    lib = cuda_build.load("wgmma_probe.cu")
    lib.c2d_qreg_probe.restype = ctypes.c_int
    lib.c2d_qreg_probe.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                                               ctypes.c_void_p]
    regs = {k["kernel"]: k for k in cuda_build.ptxas_summary(
        cuda_build.BUILD_LOGS.get("wgmma_probe.cu", ""))}
    for ks in (3, 4, 5):
        q = torch.randn(64, 16 * ks, device="cuda", generator=gen).bfloat16()
        k = torch.randn(ntiles, 64, 16 * ks, device="cuda", generator=gen).bfloat16()
        for extra in (0, 160, 224):
            outs = {}
            for mode in (0, 1, 2):
                out = torch.full((ntiles, 128, 32), float("nan"), device="cuda")
                sink = torch.empty(128, device="cuda")
                err = lib.c2d_qreg_probe(mode, ks, extra, q.data_ptr(), k.data_ptr(),
                                         out.data_ptr(), sink.data_ptr(), ntiles,
                                         torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                outs[mode] = out if err == 0 else None
            ref = outs[0]
            row = {"probe": "wgmma_register_a", "k16_steps": ks, "d": 16 * ks,
                   "extra_live_registers": extra}
            for mode, name in ((1, "qreg_pinned"), (2, "qreg_unpinned")):
                got = outs[mode]
                row[name] = None if got is None or ref is None else {
                    "same_bits": torch.equal(got, ref),
                    "tiles_off": [j for j in range(ntiles) if not torch.equal(got[j], ref[j])],
                    "max_abs_err": (got - ref).abs().max().item()}
                meta = regs.get(f"qreg_probe<{ks},{extra},1,{int(mode == 1)}>", {})
                row[name + "_ptxas"] = meta
            row["reference_ptxas"] = regs.get(f"qreg_probe<{ks},{extra},0,0>", {})
            print(json.dumps(row), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parts", default="sweep,route,qreg",
                        help="comma-separated: sweep, route, qreg")
    parts = parser.parse_args().parts.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("probe_opt_in_kernels: CUDA is not available; this tool needs one GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "qreg" in parts:
        qreg(gen)
    if "sweep" in parts:
        split_sweep(gen)
    if "route" in parts:
        unet_route(gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
