"""Precompute the frozen towers' embeddings of a training set (counterpart of
``tools/precompute_embeddings.py``).

    python -m clap2diffusion_tpu_torch.tools.precompute_embeddings \
        --data-root data/audiocaps [--config cfg.yaml] [--batch-size 16] [--device cpu]

The CLAP-audio and CLIP-text towers are frozen in every stage, so their
outputs are the same each epoch. This writes them to ``emb/{id}.npz``
(``clap`` fp32, ``text_ctx`` fp16, ``text_emb`` fp32) through the trainer's
``EmbeddingFrontend`` on ``--device`` (CUDA unless ``--device cpu``), and
``run_stage`` then reads them in place of the towers. As in the JAX tool,
the towers are ``init_params(cfg, seed=cfg.train.seed)``'s; ``precompute``
takes any towers (``tools/run_lifecycle.py`` passes the ones it holds).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from clap2diffusion_tpu_torch.core.config import Config


def precompute(cfg: Config, params: Dict, data_root: str, batch_size: int = 16,
               splits=("train", "val", "test"), device=None) -> int:
    """Write ``emb/{id}.npz`` for every sample of ``splits`` under
    ``data_root``; returns the number of files written."""
    from clap2diffusion_tpu_torch.data.latent_dataset import AudioCapsLatentDataset
    from clap2diffusion_tpu_torch.train.trainer import EmbeddingFrontend
    from clap2diffusion_tpu_torch.utils.native_audio import load_audio

    frontend = EmbeddingFrontend(cfg, params, device=device)
    out_dir = os.path.join(data_root, "emb")
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for split in splits:
        try:
            ds = AudioCapsLatentDataset(data_root, split=split,
                                        audio_duration=cfg.data.duration_s,
                                        sample_rate=cfg.data.sample_rate,
                                        latent_hw=cfg.data.latent_shape[1])
        except (ValueError, FileNotFoundError):
            continue
        for i in range(0, len(ds.samples), batch_size):
            chunk = ds.samples[i:i + batch_size]
            audio = np.stack([load_audio(str(ds.audio_dir / f"{s['id']}.wav"),
                                         ds.sample_rate, ds.target_length) for s in chunk])
            clap = frontend.encode_audio(audio).cpu().numpy()
            ctx, emb = frontend.encode_text(frontend.tokenizer(
                [s.get("caption", "") for s in chunk]))
            # text_ctx is most of the cache (77 x 768 a sample) and is read
            # cast to the compute type: fp16 halves its disk and transfer
            ctx = ctx.cpu().numpy().astype(np.float16)
            emb = emb.cpu().numpy()
            for j, s in enumerate(chunk):
                np.savez(os.path.join(out_dir, f"{s['id']}.npz"),
                         clap=clap[j], text_ctx=ctx[j], text_emb=emb[j])
                written += 1
    return written


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--config", default=None, help="YAML config path (needs PyYAML)")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (the default; raises without a GPU) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    from clap2diffusion_tpu_torch.core.config import load_config
    from clap2diffusion_tpu_torch.diffusion.pipeline import init_params

    args = build_parser().parse_args(argv)
    cfg = load_config(args.config)
    params = init_params(cfg, seed=cfg.train.seed, device=args.device)
    n = precompute(cfg, params, args.data_root, args.batch_size, device=args.device)
    print(f"wrote {n} embedding files to {args.data_root}/emb")
    return 0


if __name__ == "__main__":
    sys.exit(main())
