"""This checkout's flash forward and backward and GroupNorm kernels against
another checkout's, on the card.

    python -m clap2diffusion_tpu_torch.tools.probe_against_baseline --baseline DIR \
        [--parts census,packed,bwd]

DIR is another checkout of the repository, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory; its CUDA sources
are built beside this checkout's (``cuda_build.load`` with its ``csrc/``),
and its ``ops/groupnorm.py`` is imported from its path. Steps:
  1. Census: one full-width UNet forward (CFG batch 2, bf16, random weights
     from seed 0) and one VAE decode record the shapes of the per-head flash
     forward and of GroupNorm(+SiLU).
  2. This checkout's kernels against their plain versions at each census
     shape (bf16, the chip_smoke tolerance), plus the ragged flash cases,
     and the log-sum-exp against torch.logsumexp: reported, not raised, so
     that one bad case does not hide the rest.
  3. Device time of one call (``utils.timing.graph_ms``: a CUDA graph of 20
     calls, replayed) at each census shape: the baseline's kernel, this
     checkout's, this checkout's, the baseline's, and one PyTorch call
     (SDPA, ``F.group_norm``) beside.
  4. The head-packed kernel of both checkouts on the same inputs at the
     cases of chip_smoke.py's phase 2c: the same bits, with and without the
     log-sum-exp?
  5. The flash backward at the three training shapes [4,8,{4096,1024,256},
     {40,80,160}] (bf16): this checkout's against its plain version
     (chip_smoke's BWD_TOL) and its launch plan against the built library's,
     the same bits as the baseline's?, and device time of one call: the
     baseline's, this checkout's, this checkout's, the baseline's, and
     autograd through SDPA beside.
``--parts`` picks steps: ``census`` (1-3), ``packed`` (4), ``bwd`` (5); all
by default.
Prints one JSON line per result, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
from unittest import mock

import torch
import torch.nn.functional as F

from clap2diffusion_tpu_torch.core import config as C
from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline
from clap2diffusion_tpu_torch.ops import cuda_build
from clap2diffusion_tpu_torch.ops import flash_attention as fa
from clap2diffusion_tpu_torch.ops import groupnorm as gn
from clap2diffusion_tpu_torch.utils.timing import graph_ms, sdpa_backward_device_ms

TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}  # as chip_smoke.py
BWD_TOL = (1e-2, 1e-2)  # bf16, atol of max|plain|, as chip_smoke.py
BWD_SHAPES = [(4, 8, 4096, 40), (4, 8, 1024, 80), (4, 8, 256, 160)]
RAGGED_FLASH = [((1, 2, 1000, 40), (1, 2, 1000, 40)), ((2, 3, 300, 80), (2, 3, 777, 80)),
                ((1, 1, 333, 512), (1, 1, 130, 512)), ((1, 2, 130, 8), (1, 2, 65, 8)),
                ((1, 2, 70, 16), (1, 2, 300, 16)), ((1, 2, 200, 160), (1, 2, 100, 160)),
                ((1, 2, 100, 24), (1, 2, 100, 24)), ((1, 1, 200, 256), (1, 1, 150, 256))]
PACKED_CASES = [(2, 4096, 8, 40), (4, 4096, 8, 40), (1, 1024, 5, 40), (1, 1024, 4, 32),
                (1, 1024, 2, 64), (1, 1024, 8, 40), (1, 1000, 3, 40), (1, 40, 3, 40),
                (1, 200, 5, 16), (1, 130, 6, 8), (1, 200, 3, 24), (1, 1024, 2, 48),
                (1, 1024, 2, 56)]


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def max_err(got, ref, dtype) -> tuple:
    atol, rtol = TOL[dtype]
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ok = bool(torch.isfinite(got).all() and (err <= atol + rtol * ref.abs()).all())
    return err.max().item(), ok


def baseline_libs(base: str):
    """The baseline's flash-forward and packed libraries, bound as this
    checkout's wrappers bind theirs, and its GroupNorm module."""
    csrc = os.path.join(base, "clap2diffusion_tpu_torch", "csrc")
    libs = {}
    for source, fn in (("flash_attention.cu", "c2d_flash_attention_fwd"),
                       ("packed_flash_attention.cu", "c2d_packed_flash_attention_fwd")):
        lib = cuda_build.load(source, csrc)
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                     + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
        for err in ("c2d_cuda_error_string", "c2d_cuda_error_string_packed"):
            if hasattr(lib, err):
                getattr(lib, err).restype = ctypes.c_char_p
                getattr(lib, err).argtypes = [ctypes.c_int]
        libs[source] = lib
    spec = importlib.util.spec_from_file_location(
        "baseline_groupnorm", os.path.join(base, "clap2diffusion_tpu_torch", "ops", "groupnorm.py"))
    gn_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gn_mod)
    return libs, gn_mod


def baseline_bwd_lib(base: str):
    """The baseline's backward library, bound by this checkout's binding."""
    return fa._bind_bwd(cuda_build.load(
        "flash_attention_bwd.cu", os.path.join(base, "clap2diffusion_tpu_torch", "csrc")))


def bwd_rows(base, gen) -> None:
    lib = baseline_bwd_lib(base)
    atol, rtol = BWD_TOL
    for qs in BWD_SHAPES:
        q, k, v, do = (torch.randn(qs, device="cuda", generator=gen).bfloat16() for _ in range(4))
        scale = qs[-1] ** -0.5
        row = {"probe": "flash_bwd", "q": list(qs)}
        try:
            o, lse = fa.flash_attention_fwd(q, k, v, scale, with_lse=True)

            def new():
                return fa.flash_attention_bwd(q, k, v, o, lse, do, scale)

            def old():
                with mock.patch.object(fa, "_bwd_lib", lambda: lib):
                    return new()

            got, old_out = new(), old()
            torch.cuda.synchronize()
            ref = fa.plain_flash_attention_bwd(q, k, v, o, do, scale)
            errs, ok = [], True
            for a, r in zip(got, ref):
                a, r = a.float(), r.float()
                err = (a - r).abs()
                ok = ok and bool(torch.isfinite(a).all()
                                 and (err <= atol * r.abs().max() + rtol * r.abs()).all())
                errs.append(err.max().item() / max(r.abs().max().item(), 1e-30))
            row.update({
                "rel_err_dq_dk_dv": errs, "ok": ok,
                "same_bits_as_baseline": all(torch.equal(a, b) for a, b in zip(got, old_out)),
                "baseline_rel_diff": [(a.float() - b.float()).abs().max().item()
                                      / max(r.float().abs().max().item(), 1e-30)
                                      for a, b, r in zip(got, old_out, ref)]})
            plan = fa.flash_bwd_launch_plan(*qs[:3], qs[2], qs[3])
            built = fa.flash_bwd_kernel_plan(*qs[:3], qs[2], qs[3])
            row["plan_ok"] = all(plan[key] == val for key, val in built.items())
            row.update({key: plan[key] for key in ("grid", "threads", "smem_bytes", "waves")})
            t = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
            row.update({"baseline_ms": [t[0], t[3]], "device_ms": [t[1], t[2]],
                        "sdpa_backward_ms": sdpa_backward_device_ms(q, k, v, do, scale)})
        except Exception as e:  # report and go on to the next shape
            row["error"] = repr(e)[:500]
        log(row)


def census(gen):
    cfg = C.Config()
    pipe = AudioToImagePipeline(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    lat = cfg.diffusion.image_size // 8
    for fn in (fa.flash_attention, gn.group_norm_silu, gn.group_norm):
        fn.shapes.clear()
    with torch.inference_mode():
        pipe.unet(torch.randn(2, lat, lat, 4, device="cuda", generator=gen).bfloat16(),
                  torch.tensor([981, 981], device="cuda"),
                  torch.randn(2, 77, 768, device="cuda", generator=gen).bfloat16(),
                  {lvl: torch.randn(2, 10, 768, device="cuda", generator=gen).bfloat16()
                   for lvl in ("early", "mid", "late")})
        pipe.vae.decode_latent(torch.randn(1, lat, lat, 4, device="cuda", generator=gen).bfloat16())
    torch.cuda.synchronize()
    out = {"flash": dict(fa.flash_attention.shapes),
           "group_norm_silu": dict(gn.group_norm_silu.shapes),
           "group_norm": dict(gn.group_norm.shapes)}
    del pipe
    torch.cuda.empty_cache()
    return out


def flash_rows(shapes, base_flash, gen) -> None:
    for qs, ks in shapes:
        q, k, v = (torch.randn(s, device="cuda", generator=gen).bfloat16() for s in (qs, ks, ks))
        scale = qs[-1] ** -0.5
        row = {"probe": "flash_fwd", "q": list(qs), "k": list(ks)}
        try:
            o, lse = fa.flash_attention_fwd(q, k, v, scale, with_lse=True)
            torch.cuda.synchronize()
            row["max_abs_err"], row["ok"] = max_err(o, fa.plain_flash_attention(q, k, v, scale),
                                                    torch.bfloat16)
            ref = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, -1)
            row["lse_ok"] = bool(((lse - ref).abs() <= 1e-4 * (1 + ref.abs())).all())
            row["same_bits_twice"] = torch.equal(o, fa.flash_attention_fwd(q, k, v, scale)[0])
            plan = fa.flash_launch_plan(*qs[:3], ks[2], qs[3])
            built = fa.flash_kernel_plan(*qs[:3], ks[2], qs[3])
            row["plan_ok"] = all(plan[key] == val for key, val in built.items())
            new = lambda: fa.flash_attention_fwd(q, k, v, scale)  # noqa: E731

            def old():
                with mock.patch.object(fa, "_lib", lambda: base_flash):
                    fa.flash_attention_fwd(q, k, v, scale)

            t = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
            row.update({"baseline_ms": [t[0], t[3]], "device_ms": [t[1], t[2]],
                        "sdpa_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                            q, k, v, scale=scale))})
        except Exception as e:  # report and go on to the next shape
            row["error"] = repr(e)[:500]
        log(row)


def gn_rows(shapes, base_gn, gen) -> None:
    for (shape, dtype_name, groups, eps), kind in shapes:
        dtype = getattr(torch, dtype_name.split(".")[-1])
        silu = kind == "group_norm_silu"
        x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
        c = shape[-1]
        w = (torch.randn(c, device="cuda", generator=gen) * 0.1 + 1).to(dtype)
        b = (torch.randn(c, device="cuda", generator=gen) * 0.1).to(dtype)
        row = {"probe": kind, "x": list(shape), "dtype": dtype_name}
        try:
            fn = gn.group_norm_silu if silu else gn.group_norm
            y = fn(x, w, b, groups, eps)
            torch.cuda.synchronize()
            row["max_abs_err"], row["ok"] = max_err(
                y, gn.plain_group_norm(x, w, b, groups, eps, silu), dtype)
            row["same_bits_twice"] = torch.equal(y, fn(x, w, b, groups, eps))
            plan = gn.launch_plan(tuple(shape), dtype, groups, gn.device_capacity(0))
            built = gn.kernel_plan(shape, dtype, groups)
            row["plan_ok"] = all(plan[key] == val for key, val in built.items())
            row.update({k: plan[k] for k in ("grid", "resident", "x_reads")})
            new = lambda: fn(x, w, b, groups, eps)  # noqa: E731
            old = lambda: base_gn._launch(x, w, b, groups, eps, silu)  # noqa: E731
            t = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
            nchw = x.permute(0, 3, 1, 2)
            row.update({"baseline_ms": [t[0], t[3]], "device_ms": [t[1], t[2]],
                        "library_ms": graph_ms(lambda: F.group_norm(nchw, groups, w, b, eps))})
        except Exception as e:
            row["error"] = repr(e)[:500]
        log(row)


def packed_bits(base_packed, gen) -> None:
    for b, s, h, d in PACKED_CASES:
        pack = min(128 // d, h)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(b, s, h * d, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))

            def heads(x):
                return x.unflatten(2, (h, d)).transpose(1, 2)

            def run():
                return fa.packed_flash_attention_fwd(heads(q), heads(k), heads(v), d ** -0.5,
                                                     pack, with_lse=True)

            row = {"probe": "packed_bits", "x": [b, s, h * d], "pack": pack,
                   "dtype": str(dtype)[6:]}
            try:
                o_new, l_new = run()
                with mock.patch.object(fa, "_packed_lib", lambda: base_packed):
                    o_old, l_old = run()
                torch.cuda.synchronize()
                row["same_out"] = torch.equal(o_new, o_old)
                row["same_lse"] = torch.equal(l_new, l_old)
            except Exception as e:
                row["error"] = repr(e)[:500]
            log(row)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", required=True, help="another checkout of the repository")
    parser.add_argument("--parts", default="census,packed,bwd",
                        help="comma-separated: census, packed, bwd")
    args = parser.parse_args()
    parts = set(args.parts.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("probe_against_baseline: CUDA is not available; this tool needs one GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all([*fa.SOURCES, gn.SOURCE])
    base_csrc = os.path.join(args.baseline, "clap2diffusion_tpu_torch", "csrc")
    base_sources = (["flash_attention.cu", "packed_flash_attention.cu"]
                    if parts & {"census", "packed"} else []) + (
                        ["flash_attention_bwd.cu"] if "bwd" in parts else [])
    cuda_build.build_all(base_sources, base_csrc)
    libs, base_gn = (baseline_libs(args.baseline) if parts & {"census", "packed"}
                     else (None, None))
    for source, text in cuda_build.BUILD_LOGS.items():
        log({"probe": "ptxas", "source": source, "kernels": cuda_build.ptxas_summary(text)})
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "bwd" in parts:
        bwd_rows(args.baseline, gen)
    if "census" in parts:
        shapes = census(gen)
        log({"probe": "census", "flash": [list(map(list, k[:2])) for k in shapes["flash"]],
             "group_norm_silu": len(shapes["group_norm_silu"]),
             "group_norm": len(shapes["group_norm"])})
        flash_rows([k[:2] for k in shapes["flash"]] + RAGGED_FLASH, libs["flash_attention.cu"],
                   gen)
        gn_rows([(k, kind) for kind in ("group_norm_silu", "group_norm") for k in shapes[kind]],
                base_gn, gen)
    if "packed" in parts:
        packed_bits(libs["packed_flash_attention.cu"], gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
