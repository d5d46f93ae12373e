"""AudioCaps raw-media dataset: audio, image frames and hierarchy labels
(port of ``clap2diffusion_tpu/data/raw_dataset.py``).

- audio: decoded by the native loader (``utils/native_audio.py``), mono,
  48 kHz, then a random crop (augmentation) or a centre crop, or zero
  padding, to the target length; gain 0.8-1.2 (p = 0.5) and noise of sigma
  0.005 (p = 0.3) as augmentation;
- images: ``{id}.jpg/.jpeg/.png`` frames, LANCZOS-resized, in [-1, 1],
  NHWC; horizontal flip (p = 0.5) and brightness 0.9-1.1 (p = 0.3) as
  augmentation. A PNG already at the image size is read without Pillow
  (``utils/png.py::read_rgb``); a JPEG or a resize needs Pillow;
- captions parsed into foreground / background / ambience labels at
  construction (``data/caption_parser.py``);
- pairings: ``matching``; ``balanced`` = matching + complementary (the next
  sample's image) + creative (a random image, with more than 10 samples);
  ``creative`` = three random images per sample;
- ``load_images=False`` for stage 1.

Every random draw is the JAX package's: one ``np.random.RandomState(seed)``
drawn in the same order, so both packages give the same pairs and samples
from the same seed.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from clap2diffusion_tpu_torch.data.caption_parser import AudioCaptionParser


class AudioCapsHierarchicalDataset:
    def __init__(self, data_root: str, split: str = "train", sample_rate: int = 48_000,
                 audio_duration: float = 10.0, image_size: int = 512,
                 composition_strategy: str = "balanced", use_augmentation: bool = True,
                 load_images: bool = True, max_samples: Optional[int] = None, seed: int = 42):
        self.data_root = Path(data_root)
        self.sample_rate = sample_rate
        self.audio_length = int(sample_rate * audio_duration)
        self.image_size = image_size
        self.use_augmentation = use_augmentation and split == "train"
        self.load_images = load_images
        self.audio_dir = self.data_root / "audio"
        self.frames_dir = self.data_root / "frames"
        self._rng = np.random.RandomState(seed)

        with open(self.data_root / "metadata_unified.json") as f:
            metadata = json.load(f)
        samples = [s for s in metadata.get("samples", []) if s.get("split", split) == split]
        samples = [s for s in samples if (self.audio_dir / f"{s['id']}.wav").exists()]
        if max_samples:
            samples = samples[:max_samples]
        self.samples = samples

        parser = AudioCaptionParser()
        self.parsed_captions = {}
        for s in self.samples:
            try:
                parsed = parser.parse_caption(s.get("caption", ""))
                self.parsed_captions[s["id"]] = {"parsed": parsed,
                                                 "labels": parser.get_hierarchy_labels(parsed)}
            except Exception:  # a caption the parser fails on gets no labels
                self.parsed_captions[s["id"]] = {"parsed": None, "labels": None}
        self.composition_pairs = self._create_pairs(composition_strategy)

    def _create_pairs(self, strategy: str) -> List[Dict]:
        pairs: List[Dict] = []
        n = len(self.samples)
        for i, sample in enumerate(self.samples):
            base = {"audio_id": sample["id"], "image_id": sample["id"],
                    "caption": sample.get("caption", ""), "composition_type": "matching"}
            if strategy == "balanced":
                pairs.append(base)
                if i + 1 < n:
                    pairs.append(dict(base, image_id=self.samples[i + 1]["id"],
                                      composition_type="complementary"))
                if n > 10:
                    j = int(self._rng.randint(0, n))
                    if j != i:
                        pairs.append(dict(base, image_id=self.samples[j]["id"],
                                          composition_type="creative"))
            elif strategy == "creative":
                for _ in range(3):
                    j = int(self._rng.randint(0, n))
                    pairs.append(dict(base, image_id=self.samples[j]["id"],
                                      composition_type="creative" if j != i else "matching"))
            else:
                pairs.append(base)
        return pairs

    def __len__(self) -> int:
        return len(self.composition_pairs)

    def _load_audio(self, sample_id: str) -> np.ndarray:
        from clap2diffusion_tpu_torch.utils.native_audio import load_audio

        # decode to twice the length, then crop or pad (with augmentation)
        raw = load_audio(str(self.audio_dir / f"{sample_id}.wav"), self.sample_rate,
                         self.audio_length * 2)
        nz = np.nonzero(raw)[0]
        current = int(nz[-1]) + 1 if len(nz) else self.audio_length
        audio = raw[:current]
        if current > self.audio_length:
            if self.use_augmentation:
                start = int(self._rng.randint(0, current - self.audio_length + 1))
            else:
                start = (current - self.audio_length) // 2
            audio = audio[start:start + self.audio_length]
        elif current < self.audio_length:
            audio = np.pad(audio, (0, self.audio_length - current))
        if self.use_augmentation:
            if self._rng.rand() < 0.5:
                audio = audio * self._rng.uniform(0.8, 1.2)
            if self._rng.rand() < 0.3:
                audio = audio + self._rng.randn(len(audio)).astype(np.float32) * 0.005
            audio = np.clip(audio, -1.0, 1.0)
        return audio.astype(np.float32)

    def _load_image(self, sample_id: str) -> np.ndarray:
        from clap2diffusion_tpu_torch.utils.png import read_rgb

        path = None
        for ext in (".jpg", ".jpeg", ".png"):
            p = self.frames_dir / f"{sample_id}{ext}"
            if p.exists():
                path = p
                break
        if path is None:
            return np.zeros((self.image_size, self.image_size, 3), np.float32)
        lanczos = 1  # PIL.Image.LANCZOS
        img = read_rgb(str(path), (self.image_size, self.image_size), resample=lanczos)
        x = np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0  # NHWC in [-1, 1]
        if self.use_augmentation:
            if self._rng.rand() < 0.5:
                x = x[:, ::-1, :].copy()
            if self._rng.rand() < 0.3:
                x = np.clip(x * self._rng.uniform(0.9, 1.1), -1.0, 1.0)
        return x

    def __getitem__(self, idx: int) -> Dict:
        pair = self.composition_pairs[idx]
        item = {
            "audio": self._load_audio(pair["audio_id"]),
            "caption": pair["caption"],
            "audio_id": pair["audio_id"],
            "image_id": pair["image_id"],
            "composition_type": pair["composition_type"],
            "hierarchy": self.parsed_captions[pair["audio_id"]]["labels"],
        }
        if self.load_images:
            item["image"] = self._load_image(pair["image_id"])
        return item

    def composition_statistics(self) -> Dict[str, int]:
        stats: Dict[str, int] = {}
        for p in self.composition_pairs:
            stats[p["composition_type"]] = stats.get(p["composition_type"], 0) + 1
        return stats
