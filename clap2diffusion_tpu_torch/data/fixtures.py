"""Synthetic fixture data for the training path (port of
``clap2diffusion_tpu/data/fixtures.py``): tone (or silent) WAVs, random
latents and ``metadata_unified.json`` for train/val/test splits."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

from clap2diffusion_tpu_torch.utils.audio_io import write_wav

_CAPTIONS = [
    "a dog barks while a man speaks in the background",
    "rain falls softly as thunder rumbles in the distance",
    "a car engine revs and a horn honks",
    "birds chirping in a quiet forest",
    "music playing with people talking and laughing",
    "waves crashing on the beach",
    "a machine humming inside a factory",
    "children playing at a playground",
]


def make_fixture_dataset(root: str, n_train: int = 5, n_val: int = 2, n_test: int = 1,
                         duration_s: float = 10.0, sample_rate: int = 48_000,
                         latent_hw: int = 64, tone: bool = True, seed: int = 0) -> Dict:
    """Write wavs + latents + metadata_unified.json under ``root``; the same
    files, byte for byte, as the JAX package's fixture."""
    root_p = Path(root)
    (root_p / "audio").mkdir(parents=True, exist_ok=True)
    (root_p / "latents").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_samples = int(duration_s * sample_rate)
    samples = []
    i = 0
    for split, count in (("train", n_train), ("val", n_val), ("test", n_test)):
        for _ in range(count):
            sid = f"sample_{i:05d}"
            if tone:
                t = np.arange(n_samples) / sample_rate
                wav = (0.1 * np.sin(2 * np.pi * 110.0 * (1 + i % 8) * t)).astype(np.float32)
            else:
                wav = np.zeros(n_samples, np.float32)
            write_wav(str(root_p / "audio" / f"{sid}.wav"), wav, sample_rate)
            latent = rng.normal(size=(4, latent_hw, latent_hw)).astype(np.float32)
            np.save(root_p / "latents" / f"{sid}.npy", latent)
            samples.append({"id": sid, "caption": _CAPTIONS[i % len(_CAPTIONS)],
                            "split": split})
            i += 1
    metadata = {"samples": samples, "info": {"fixture": True, "seed": seed}}
    with open(root_p / "metadata_unified.json", "w") as f:
        json.dump(metadata, f, indent=2)
    return metadata
