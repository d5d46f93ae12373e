"""Data preparation (port of ``clap2diffusion_tpu/data/prepare.py``): an
AudioCaps CSV to 48 kHz WAVs with an 80/10/10 split, and image frames to
VAE latents.

- ``prepare_audiocaps``: for each CSV row (``youtube_id`` / ``id`` /
  ``audiocap_id``, ``caption``) the first ``{id}{ext}`` of
  ``SOURCE_EXTENSIONS`` under the source directory is decoded
  (``utils/audio_io.py::read_audio``: WAV in numpy, FLAC and mp3 through
  the native loader, the rest through ffmpeg), mixed to mono,
  peak-normalised, resampled to 48 kHz, cropped or padded to 10 s and
  written as 16-bit WAV; the split is drawn by
  ``np.random.RandomState(seed).permutation``, as in JAX, and written to
  ``metadata_unified.json``.
- ``encode_latents``: ``{id}.png/.jpg/.jpeg`` frames -> ``latents/{id}.npy``
  ([4, 64, 64] NCHW at 512²) through the VAE encoder's ``sample_latent``,
  in batches of ``batch_size`` on CUDA unless ``device="cpu"``. The last
  chunk is padded with zero frames to ``batch_size``, as JAX pads it, so a
  frame's latent does not depend on how many frames remain (on the card a
  lane's bits depend on its batch, ROADMAP known delta 14). Without
  ``vae_params`` the VAE is drawn at random (seed 0), as JAX initialises it.
  The posterior noise comes from ``latent_draws`` (a ``torch.Generator``
  seeded with ``seed``, one draw per chunk; ROADMAP known delta 19), not
  from threefry; a test replaces it to feed the JAX draws. An fp32 encode
  runs in full fp32: TF32 is off for its convolutions and matmuls (cuDNN
  takes fp32 convolutions to TF32 by PyTorch's default) and the flags are
  restored afterwards, so a latent is the CPU encode's to rounding.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from clap2diffusion_tpu_torch.models.clap.frontend import resample_poly
from clap2diffusion_tpu_torch.utils.audio_io import read_audio, write_wav


def process_audio_file(in_path: str, out_path: str, target_sr: int = 48_000,
                       duration_s: float = 10.0) -> bool:
    """Decode -> mono -> peak-normalise -> resample -> crop/pad -> 16-bit
    WAV; False when the source cannot be read."""
    try:
        wav, sr = read_audio(in_path)
        if wav.ndim == 2:
            wav = wav.mean(axis=0)
        peak = np.abs(wav).max()
        if peak > 0:
            wav = wav / peak
        n = int(target_sr * duration_s)
        if sr != target_sr:
            wav = resample_poly(wav, sr, target_sr, keep=n)
        if len(wav) < n:
            wav = np.pad(wav, (0, n - len(wav)))
        write_wav(out_path, wav[:n], target_sr)
        return True
    except Exception:
        return False


# The source containers prepare takes, in order of preference.
SOURCE_EXTENSIONS = (".wav", ".flac", ".mp3", ".m4a", ".ogg", ".opus", ".webm")


def find_source(audio_src_dir: str, sid: str) -> Optional[str]:
    """The first existing ``{sid}{ext}`` under ``audio_src_dir``, in
    ``SOURCE_EXTENSIONS`` order."""
    for ext in SOURCE_EXTENSIONS:
        cand = os.path.join(audio_src_dir, f"{sid}{ext}")
        if os.path.exists(cand):
            return cand
    return None


def prepare_audiocaps(csv_path: str, audio_src_dir: str, out_root: str,
                      target_sr: int = 48_000, seed: int = 42,
                      max_samples: Optional[int] = None) -> Dict:
    """CSV (youtube_id, caption, ...) -> processed WAVs + the unified
    metadata; returns the metadata."""
    out = Path(out_root)
    (out / "audio").mkdir(parents=True, exist_ok=True)
    with open(csv_path) as f:
        rows: List[Dict] = list(csv.DictReader(f))
    if max_samples:
        rows = rows[:max_samples]

    samples = []
    for row in rows:
        sid = row.get("youtube_id") or row.get("id") or row.get("audiocap_id")
        src = find_source(audio_src_dir, sid)
        if src is not None and process_audio_file(src, str(out / "audio" / f"{sid}.wav"),
                                                  target_sr):
            samples.append({"id": sid, "caption": row.get("caption", "")})

    idx = np.random.RandomState(seed).permutation(len(samples))
    n_train, n_val = int(0.8 * len(samples)), int(0.1 * len(samples))
    for pos, i in enumerate(idx):
        samples[i]["split"] = ("train" if pos < n_train else
                               "val" if pos < n_train + n_val else "test")
    metadata = {"samples": samples}
    with open(out / "metadata_unified.json", "w") as f:
        json.dump(metadata, f, indent=2)
    return metadata


def latent_draws(seed: int, device) -> Callable[[tuple], torch.Tensor]:
    """The posterior noise of ``encode_latents``: fp32 standard normals of
    the asked shape from one ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return lambda shape: torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


@contextlib.contextmanager
def _full_fp32():
    """TF32 off for cuDNN and cuBLAS inside the scope, then as it was."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def encode_latents(data_root: str, frames_dir: Optional[str] = None,
                   vae_params: Optional[Dict[str, torch.Tensor]] = None, vae_cfg=None,
                   batch_size: int = 8, image_size: int = 512, seed: int = 0,
                   device=None) -> int:
    """Encode ``{id}.png/.jpg/.jpeg`` frames -> ``latents/{id}.npy`` (NCHW)
    through the VAE; returns the number written. ``vae_params``: the port's
    VAE state dict (its type is the compute type); None draws it at random.
    With no frames directory nothing is written."""
    from clap2diffusion_tpu_torch.core.config import VAEConfig
    from clap2diffusion_tpu_torch.core.device import resolve_device
    from clap2diffusion_tpu_torch.diffusion.pipeline import random_init_
    from clap2diffusion_tpu_torch.models.vae import AutoencoderKL
    from clap2diffusion_tpu_torch.utils.png import read_rgb

    root = Path(data_root)
    frames = Path(frames_dir) if frames_dir else root / "frames"
    latents_dir = root / "latents"
    latents_dir.mkdir(parents=True, exist_ok=True)
    if not frames.exists():
        return 0

    dev = resolve_device(device)
    with torch.device("meta"):
        vae = AutoencoderKL(vae_cfg or VAEConfig())
    vae.to_empty(device=dev)
    if vae_params is None:
        random_init_(vae, torch.Generator(device=dev).manual_seed(0), {})
    else:
        vae.to(next(iter(vae_params.values())).dtype)
        vae.load_state_dict({k: v.to(dev) for k, v in vae_params.items()}, strict=True)
    vae.eval().requires_grad_(False).to(memory_format=torch.channels_last)
    dtype = next(vae.parameters()).dtype

    paths = sorted(p for p in frames.iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    draw = latent_draws(seed, dev)
    written = 0
    for i in range(0, len(paths), batch_size):
        chunk = paths[i:i + batch_size]
        arr = np.zeros((batch_size, image_size, image_size, 3), np.float32)
        for j, p in enumerate(chunk):
            arr[j] = read_rgb(str(p), (image_size, image_size)).astype(np.float32) / 127.5 - 1.0
        with torch.inference_mode(), _full_fp32():
            z = vae.sample_latent(torch.from_numpy(arr).to(dev, dtype), draw)
        lat = z.float().cpu().numpy()[:len(chunk)]
        for p, zi in zip(chunk, lat):
            np.save(latents_dir / f"{p.stem}.npy", zi.transpose(2, 0, 1))  # NCHW file
            written += 1
    return written
