"""AudioCaps latent dataset and prefetching loader (port of
``clap2diffusion_tpu/data/latent_dataset.py``).

- ``metadata_unified.json`` with a ``samples`` list; the per-sample
  ``split`` field is honoured, with a seeded 80/10/10 split when no sample
  has one;
- samples are kept only when their latent (``.npy``, or ``.pt``) and WAV
  exist; pairing strategies matching / shifted / random;
- audio decodes through the native loader (``utils/native_audio.py``),
  as the JAX dataset's does; unreadable audio or latents become zeros;
  latents are stored NCHW [4, 64, 64] and returned NHWC.

``PrefetchLoader`` decodes the next batches in a background thread while
the device runs the current step. Every shard shuffles the full index list
with the same seed (per epoch), truncates it to a multiple of
``num_shards`` and takes ``order[shard_index::num_shards]``: the same order
as the JAX loader. A failure in the thread is raised in the consumer.
"""

from __future__ import annotations

import json
import pickle
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from clap2diffusion_tpu_torch.utils.native_audio import load_audio


class AudioCapsLatentDataset:
    def __init__(self, data_root: str, split: str = "train",
                 max_samples: Optional[int] = None, audio_duration: float = 10.0,
                 sample_rate: int = 48_000, composition_strategy: str = "matching",
                 composition_shift: int = 0, seed: int = 42, latent_hw: int = 64):
        self.data_root = Path(data_root)
        self.split = split
        self.sample_rate = sample_rate
        self.target_length = int(sample_rate * audio_duration)
        self.latent_hw = latent_hw
        self.audio_dir = self.data_root / "audio"
        self.latents_dir = self.data_root / "latents"
        if not self.latents_dir.exists():
            raise ValueError(f"Latents directory not found: {self.latents_dir}")
        with open(self.data_root / "metadata_unified.json") as f:
            all_samples = json.load(f).get("samples", [])

        samples = [s for s in all_samples if s.get("split") == split]
        if not samples:
            indices = np.random.RandomState(seed).permutation(len(all_samples))
            n_train, n_val = int(0.8 * len(all_samples)), int(0.1 * len(all_samples))
            sel = {"train": indices[:n_train], "val": indices[n_train:n_train + n_val],
                   "test": indices[n_train + n_val:]}[split]
            samples = [all_samples[i] for i in sel]
        self.samples = [s for s in samples if self._latent_path(s["id"]) is not None
                        and (self.audio_dir / f"{s['id']}.wav").exists()]
        if max_samples:
            self.samples = self.samples[:max_samples]
        self.pairs = self._create_pairs(composition_strategy, composition_shift)

    def _latent_path(self, sample_id: str) -> Optional[Path]:
        for ext in (".npy", ".pt"):
            p = self.latents_dir / f"{sample_id}{ext}"
            if p.exists():
                return p
        return None

    def _create_pairs(self, strategy: str, shift: int) -> List[Tuple[int, int]]:
        n = len(self.samples)
        if strategy == "matching":
            return [(i, i) for i in range(n)]
        if strategy == "shifted":
            return [(i, (i + shift) % n) for i in range(n)]
        if strategy == "random":
            perm = np.random.RandomState(42).permutation(n)
            return [(i, int(perm[i])) for i in range(n)]
        raise ValueError(f"unknown composition strategy {strategy!r}")

    def __len__(self) -> int:
        return len(self.pairs)

    def _load_latent(self, sample_id: str) -> np.ndarray:
        path = self._latent_path(sample_id)
        expected = (4, self.latent_hw, self.latent_hw)
        try:
            if path is None:
                raise FileNotFoundError(sample_id)
            if path.suffix == ".npy":
                lat = np.load(path)
            else:
                import torch

                lat = torch.load(path, map_location="cpu", weights_only=True).numpy()
            lat = np.asarray(lat, np.float32)
            if lat.shape != expected:
                raise ValueError(f"bad latent shape {lat.shape}")
            return lat
        except (OSError, ValueError, RuntimeError, EOFError, pickle.UnpicklingError):
            return np.zeros(expected, np.float32)

    def __getitem__(self, idx: int) -> Dict:
        ai, li = self.pairs[idx]
        a, im = self.samples[ai], self.samples[li]
        return {
            "audio": load_audio(str(self.audio_dir / f"{a['id']}.wav"), self.sample_rate,
                                self.target_length),
            "latent": self._load_latent(im["id"]).transpose(1, 2, 0),  # NHWC
            "caption": a.get("caption", ""),
            "audio_id": a["id"],
            "image_id": im["id"],
        }


class PrefetchLoader:
    def __init__(self, dataset: AudioCapsLatentDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 42, prefetch: int = 2, drop_last: bool = True,
                 shard_index: int = 0, num_shards: int = 1):
        if not (0 <= shard_index < num_shards):
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards

    def _shard_size(self) -> int:
        return len(self.dataset) // self.num_shards

    def __len__(self) -> int:
        n = self._shard_size()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @staticmethod
    def _collate(items: List[Dict]) -> Dict:
        return {
            "audio": np.stack([it["audio"] for it in items]),
            "latent": np.stack([it["latent"] for it in items]),
            "caption": [it["caption"] for it in items],
            "audio_id": [it["audio_id"] for it in items],
            "image_id": [it["image_id"] for it in items],
        }

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch_idx).shuffle(order)
        usable = self._shard_size() * self.num_shards
        order = order[:usable][self.shard_index::self.num_shards]
        n_batches = len(self)
        if n_batches == 0:
            raise ValueError(
                f"shard {self.shard_index}/{self.num_shards} has {len(order)} samples — "
                f"fewer than batch_size {self.batch_size}; shrink the batch or the shard count")
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in range(n_batches):
                    idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                    if self.drop_last and len(idxs) < self.batch_size:
                        break
                    if not put(self._collate([self.dataset[int(i)] for i in idxs])):
                        return
                put(done)
            except Exception as e:  # handed to the consumer, which raises it
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
