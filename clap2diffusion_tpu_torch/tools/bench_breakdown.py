"""Time by component and batch on one card: the counterpart of the JAX
package's ``tools/bench_breakdown.py`` (BASELINE.md configs 1-4), with
``tools/bench_scaling.py`` (batch 1 against 8) and ``tools/bench_batch16.py``
(img/s at batch 8 against 16) folded in as ``--batches``.

    python -m clap2diffusion_tpu_torch.tools.bench_breakdown [--batches 1,8,16]
        [--iters 10] [--steps 50] [--only NAME,...]
    python -m clap2diffusion_tpu_torch.tools.bench_breakdown --device cpu --dtype fp32 \\
        --only clap_encode --batches 1           # config 1 as BASELINE.md states it

Components (the JAX tool's names and inputs, weights from
``cached_init_params(seed 0)``):
  clap_encode      config 1: log-mel, the HTSAT CLAP tower and the
                   hierarchical conditioning (the audio tokens, Norm-60) of
                   ``batch`` copies of a 10 s waveform (``normal * 0.1``,
                   ``default_rng(0)``)
  unet_step_cfg    one folded-CFG UNet forward at CFG batch 2 x ``batch``,
                   latents of the image (64x64 at 512²), t = 500, text
                   context and routed audio tokens of ones
  unet_step_256    config 2: the same at 256² (32x32 latents, whatever the
                   configuration's image size), CFG batch 2
  vae_decode_512   ``decode_latent`` of ``batch`` latents of ones
  full_<steps>step_b<batch>
                   ``generate`` of ``batch`` images (``--steps`` DDIM
                   steps, CFG 7.5): config 3 at batch 1, config 4 at 8;
                   also images/s

Each component reports its host pace: CUDA events around each of
``--iters`` calls (``FULL_REQUESTS`` for ``full_*``) after one warm-up, the
p50 and the min. The UNet step and the VAE decode also report their device
pace, ``device_ms``: one call's share of a CUDA graph of ``GRAPH_CALLS``
calls replayed ``GRAPH_REPLAYS`` times (``utils/timing.py::graph_ms``), the
card's counterpart of ``bench_scaling.py``'s T(2K) - T(K) differencing.
One JSON line per component and batch on stdout, with the card's name and
power limit; on the CPU ``device_ms`` is None (not measured).
"""

from __future__ import annotations

import statistics
from typing import Iterable, List, Optional

import numpy as np
import torch

from clap2diffusion_tpu_torch.tools import bench_common as B

COMPONENTS = ("clap_encode", "unet_step_cfg", "unet_step_256", "vae_decode_512",
              "full_50step")
GRAPH_CALLS = 4
GRAPH_REPLAYS = 3
TIMESTEP = 500
FULL_REQUESTS = 3  # timed requests of full_* (the JAX tool's)


def run(cfg=None, device=None, steps: int = 50, iters: int = 10,
        batches: Iterable[int] = (1, 8, 16), only: Optional[Iterable[str]] = None,
        dtype: torch.dtype = torch.bfloat16,
        cache_dir: str = B.PARAM_CACHE) -> List[dict]:
    """Time each component of ``only`` (all by default) at each batch; print
    and return one row each."""
    from clap2diffusion_tpu_torch.core.config import Config
    from clap2diffusion_tpu_torch.core.device import resolve_device
    from clap2diffusion_tpu_torch.utils.timing import graph_ms

    dev = resolve_device(device)
    cfg = cfg or Config()
    only = tuple(only or COMPONENTS)
    unknown = set(only) - set(COMPONENTS)
    if unknown:
        raise ValueError(f"unknown components {sorted(unknown)}; known: {COMPONENTS}")
    batches = tuple(batches)
    head = {"device": str(dev), **B.card(dev), "dtype": str(dtype)[6:]}
    B.build_kernels(dev)
    pipe, info = B.bench_pipeline(cfg, dev, dtype, cache_dir)
    B.say(f"breakdown on {dev} ({head['card']}); weights "
          f"{'loaded' if info['params_cache_hit'] else 'drawn'}")

    rng = np.random.default_rng(0)
    wav = (rng.normal(size=(1, cfg.clap.frontend.num_samples)) * 0.1).astype(np.float32)
    ids = B.text_ids(rng, cfg)
    norm = cfg.condition.audio_norm_target
    rows: List[dict] = []

    def report(name: str, batch: int, times: List[float], **extra) -> dict:
        row = {"component": name, "batch": batch, **extra, "iters": len(times),
               "p50_ms": statistics.median(times) * 1e3, "min_ms": min(times) * 1e3, **head}
        rows.append(row)
        B.emit(row)
        return row

    def device_ms(fn) -> Optional[float]:
        if dev.type != "cuda":
            return None
        with torch.inference_mode():
            ms = graph_ms(fn, n=GRAPH_CALLS, replays=GRAPH_REPLAYS)
        torch.cuda.empty_cache()
        return ms

    @torch.inference_mode()
    def clap_encode(w: np.ndarray):
        return pipe._condition(pipe.encode_audio(w), "hierarchical", norm, 0.5)

    # the UNet's conditioning shapes at batch 1, from one real pass
    ctx1 = pipe.encode_text(np.concatenate([ids, np.zeros_like(ids)]))[:1]
    _, routed1 = clap_encode(wav)

    def unet_args(cfg_batch: int, lat: int):
        cdt = pipe.compute_dtype
        return (torch.ones(cfg_batch, lat, lat, 4, dtype=cdt, device=dev),
                torch.full((cfg_batch,), TIMESTEP, dtype=torch.long, device=dev),
                torch.ones(cfg_batch, *ctx1.shape[1:], dtype=cdt, device=dev),
                {k: torch.ones(cfg_batch, *v.shape[1:], dtype=cdt, device=dev)
                 for k, v in routed1.items()})

    def unet_row(name: str, batch: int, cfg_batch: int, lat: int):
        args = unet_args(cfg_batch, lat)

        @torch.inference_mode()
        def step():
            return pipe.unet(*args)

        report(name, batch, B.host_times(step, dev, iters), cfg_batch=cfg_batch, latent=lat,
               device_ms=device_ms(step))

    lat = cfg.diffusion.image_size // 8
    for b in batches:
        if "clap_encode" in only:
            wb = np.repeat(wav, b, axis=0)
            report("clap_encode", b, B.host_times(lambda: clap_encode(wb), dev, iters))
        if "unet_step_cfg" in only:
            unet_row("unet_step_cfg", b, 2 * b, lat)
        if "vae_decode_512" in only:
            z = torch.ones(b, lat, lat, 4, dtype=pipe.compute_dtype, device=dev)

            @torch.inference_mode()
            def decode():
                return pipe.vae.decode_latent(z)

            report("vae_decode_512", b, B.host_times(decode, dev, iters),
                   image=cfg.diffusion.image_size, device_ms=device_ms(decode))
            del z
        if "full_50step" in only:
            idsb = np.repeat(ids, b, axis=0)
            times = B.host_times(lambda: pipe.generate(waveform=wav[0], text_ids=idsb,
                                                       num_steps=steps, seed=0, batch=b),
                                 dev, FULL_REQUESTS)
            p50 = statistics.median(times)
            report(f"full_{steps}step_b{b}", b, times, steps=steps, images_per_s=b / p50)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if "unet_step_256" in only:
        unet_row("unet_step_256", 1, 2, 256 // 8)
    return rows


def main(argv=None) -> int:
    ap = B.parser(__doc__)
    ap.add_argument("--batches", default="1,8,16", help="user batches, comma-separated")
    ap.add_argument("--steps", type=int, default=50, help="DDIM steps of full_*")
    ap.add_argument("--iters", type=int, default=10, help="timed calls of a component")
    ap.add_argument("--only", default=None, help=f"comma-separated, of {','.join(COMPONENTS)}")
    ap.add_argument("--dtype", choices=sorted(B.DTYPES), default="bf16")
    args = ap.parse_args(argv)
    run(device=args.device, steps=args.steps, iters=args.iters,
        batches=[int(b) for b in args.batches.split(",")],
        only=args.only.split(",") if args.only else None, dtype=B.DTYPES[args.dtype])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
