"""Training throughput on one card (BASELINE.md config 5): stage-1 adapter
training over (CLAP, text embedding) batches; the counterpart of the JAX
package's ``tools/bench_train.py``.

    python -m clap2diffusion_tpu_torch.tools.bench_train [--device cpu]

The configuration is ``Config()`` with ``train.stage1.grad_accum=1`` (an
update every micro-step) and ``train.stage1.use_ema=false`` (the JAX tool's
state carries no EMA shadow), batch ``train.stage1.batch_size`` (8). The
batch is the JAX tool's: ``clap`` [8, 512] from ``default_rng(0)`` and
``text_emb`` [8, 768] from ``default_rng(1)``, standard normal, the same
batch every step. The adapter's weights are drawn on the card from seed 0
(``random_init_``), fp32.

Each step is ``train/stages.py::make_stage1_step`` through ``train_step``
(loss, gradients, AdamW); dropout draws from one ``torch.Generator``. The
JAX tool scans ``K`` = 50 steps in one program; the port runs them eagerly
and synchronises once at a chunk's end, when its ``K`` losses are fetched
(ROADMAP known delta 6). One warm chunk, then 4 timed chunks:
steps/s, samples/s (``dp`` is 1 on one card), the first and last chunk's
mean loss and the last loss. One JSON line on stdout.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from clap2diffusion_tpu_torch.tools import bench_common as B

OVERRIDES = ["train.stage1.grad_accum=1", "train.stage1.use_ema=false"]


def run(cfg=None, device=None, steps: int = 50, iters: int = 4,
        params: Optional[dict] = None) -> dict:
    """One warm chunk and ``iters`` timed chunks of ``steps`` micro-steps;
    prints and returns the line (with every loss under ``"losses"``).
    ``params`` ({"adapter": state dict}) replaces the seeded draw."""
    from clap2diffusion_tpu_torch.core.config import Config, apply_overrides
    from clap2diffusion_tpu_torch.core.device import resolve_device
    from clap2diffusion_tpu_torch.diffusion.pipeline import _special_init, random_init_
    from clap2diffusion_tpu_torch.models.condition.adapter import AudioAdapter
    from clap2diffusion_tpu_torch.train.stages import make_stage1_step, train_step

    dev = resolve_device(device)
    cfg = apply_overrides(cfg or Config(), OVERRIDES)
    bs = cfg.train.stage1.batch_size
    if params is None:
        with torch.device("meta"):
            adapter = AudioAdapter(cfg.condition)
        adapter.to_empty(device=dev)
        random_init_(adapter, torch.Generator(device=dev).manual_seed(0), _special_init(cfg))
        params = {"adapter": adapter.state_dict()}
    stage = make_stage1_step(cfg)
    state = stage.create_state({tw: {n: t.detach().to(dev, torch.float32).clone()
                                     for n, t in sd.items()} for tw, sd in params.items()})
    batch = {
        "clap": torch.from_numpy(np.random.default_rng(0).normal(
            size=(bs, cfg.condition.clap_dim)).astype(np.float32)).to(dev),
        "text_emb": torch.from_numpy(np.random.default_rng(1).normal(
            size=(bs, cfg.condition.token_dim)).astype(np.float32)).to(dev),
    }
    gen = torch.Generator(device=dev).manual_seed(0)

    def chunk() -> np.ndarray:
        losses = [train_step(stage, state, batch, gen)["total"] for _ in range(steps)]
        return torch.stack(losses).cpu().numpy()  # the chunk's one synchronisation

    losses = [chunk()]
    t0 = time.perf_counter()
    for _ in range(iters):
        losses.append(chunk())
    dt = time.perf_counter() - t0
    line = {
        "config": 5, "stage": 1, "batch": bs, "dp": 1, "steps_per_chunk": steps,
        "timed_chunks": iters, "seconds": dt, "steps_per_s": iters * steps / dt,
        "samples_per_s": iters * steps * bs / dt,
        "first_chunk_mean_loss": float(losses[0].mean()),
        "last_chunk_mean_loss": float(losses[-1].mean()),
        "last_loss": float(losses[-1][-1]), "finite": bool(np.isfinite(losses).all()),
        "device": str(dev), **B.card(dev),
    }
    B.emit(line)
    return {**line, "losses": np.concatenate(losses).tolist()}


def main(argv=None) -> int:
    args = B.parser(__doc__).parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
