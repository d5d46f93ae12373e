"""WAV read/write and file loading for the training data path (copies of
``clap2diffusion_tpu/utils/audio_io.py::read_wav``/``write_wav`` and the
numpy path of ``clap2diffusion_tpu/utils/native_audio.py::load_audio``).

``load_audio`` decodes a WAV, mono-averages, resamples with the port's
polyphase resampler (``models/clap/frontend.py::resample_poly``), pads or
crops to the target length, and returns zeros when the file cannot be
read, as the JAX package's fallback does. Its peak-normalising option (no
training caller uses it) and the native C++ loader are not ported yet.
"""

from __future__ import annotations

import struct
import wave
from typing import Tuple

import numpy as np

from clap2diffusion_tpu_torch.models.clap.frontend import resample_poly


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 [channels, samples] or [samples], sr)."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            payload = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 3:  # IEEE float
        x = np.frombuffer(data, dtype=np.float32 if bits == 32 else np.float64).astype(np.float32)
    elif audio_format in (1, 0xFFFE):  # PCM (or extensible, read as PCM)
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            vals = (raw[:, 0].astype(np.int32) | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")
    if channels > 1:
        x = x.reshape(-1, channels).T
    return x, sr


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Write float32 [-1, 1] mono [samples] or [channels, samples] as 16-bit PCM."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 2:
        x = x.T
        channels = x.shape[1]
    else:
        channels = 1
    pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def load_audio(path: str, target_sr: int, target_len: int) -> np.ndarray:
    """Decode + resample + zero-pad/crop one WAV -> float32 [target_len];
    zeros when the file cannot be read."""
    try:
        wav, sr = read_wav(path)
    except (OSError, ValueError, struct.error):
        return np.zeros(target_len, np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=0)
    if sr != target_sr:
        wav = resample_poly(wav, sr, target_sr)
    if len(wav) < target_len:
        wav = np.pad(wav, (0, target_len - len(wav)))
    return wav[:target_len].astype(np.float32)
