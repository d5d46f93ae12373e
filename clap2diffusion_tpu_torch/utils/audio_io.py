"""Audio file reading and writing (port of
``clap2diffusion_tpu/utils/audio_io.py``: ``read_wav``, ``read_wav_pcm16``,
``read_audio``, ``write_wav``, ``peak_normalize``).

``read_wav`` reads PCM 8/16/24/32-bit and IEEE-float WAVs in numpy;
``read_audio`` sniffs the container from its magic bytes: RIFF goes to
``read_wav``, FLAC and mp3 to the native loader (``utils/native_audio.py``,
mono-averaged), anything else (and mp3 without the system's libmpg123) to
the ffmpeg command line when it is on ``PATH``. A corrupt FLAC raises. The
polyphase resampler is ``models/clap/frontend.py::resample_poly``, the
port's one copy.
"""

from __future__ import annotations

import struct
import wave
from typing import Optional, Tuple

import numpy as np


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


def read_wav_pcm16(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """The serving fast path: a mono 16-bit PCM WAV -> (int16 [samples],
    sr); None for anything that needs a conversion (another format, bit
    depth or channel count) or cannot be read as one."""
    try:
        with open(path, "rb") as f:
            header = f.read(12)
            if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
                return None
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
    except (OSError, struct.error):  # struct.error: a fmt chunk under 16 bytes
        return None
    if fmt is None or data is None or len(data) % 2:
        return None
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format not in (1, 0xFFFE) or bits != 16 or channels != 1:
        return None
    return np.frombuffer(data, dtype="<i2"), sr


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode any supported container -> (float32 samples, sr): a WAV as
    ``read_wav`` gives it ([channels, samples] for stereo), FLAC and mp3
    mono-averaged [samples] through the native loader, anything else
    through the ffmpeg command line."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"RIFF":
        return read_wav(path)
    is_mp3 = magic[:3] == b"ID3" or (
        len(magic) >= 2 and magic[0] == 0xFF and (magic[1] & 0xE0) == 0xE0)
    if magic == b"fLaC" or is_mp3:
        from clap2diffusion_tpu_torch.utils.native_audio import decode_audio

        try:
            out = decode_audio(path)
        except ValueError:
            if magic == b"fLaC":
                raise  # a corrupt FLAC stream fails here, not through ffmpeg
            out = None  # mp3 without the system codec
        if out is not None:
            return out
    return _read_via_ffmpeg(path, magic)


def _read_via_ffmpeg(path: str, magic: bytes) -> Tuple[np.ndarray, int]:
    import shutil
    import subprocess
    import tempfile

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise ValueError(
            f"{path}: unsupported audio container (magic {magic!r}). "
            "WAV and FLAC decode natively; for mp3/ogg/m4a install ffmpeg "
            "(the prepare CLI then converts through it automatically).")
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        subprocess.run([ffmpeg, "-v", "error", "-y", "-i", path, "-f", "wav", tmp.name],
                       check=True)
        return read_wav(tmp.name)


def peak_normalize(x: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """Divide by the peak, as the reference's inference path does."""
    peak = np.abs(x).max()
    return (x / (peak + eps)).astype(np.float32) if peak > 0 else x.astype(np.float32)


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
