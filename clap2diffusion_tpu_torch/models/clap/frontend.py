"""Audio frontend: waveform -> log-mel spectrogram (port of
``clap2diffusion_tpu/models/clap/frontend.py``), matching HF
ClapFeatureExtractor's unfused path.

48 kHz, n_fft 1024, hop 480, 64 slaney mels over 0..14 kHz, periodic Hann,
center=True reflect padding, power 2, dB floor 1e-10; 10 s -> 1001 frames.
The windowed real DFT and the filterbank are two fp32 matmuls with
constants built in float64 numpy, as in the JAX package, which runs them at
``precision="highest"``. TF32 stays off here: the matmuls run through
``torch.matmul`` in full fp32 (PyTorch's default).
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch

from clap2diffusion_tpu_torch.core.config import AudioFrontendConfig
from clap2diffusion_tpu_torch.core.device import device_constant


def hertz_to_mel_slaney(freq) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    mels = 3.0 * freq / 200.0
    logstep = 27.0 / np.log(6.4)
    return np.where(
        freq >= 1000.0,
        15.0 + np.log(np.maximum(freq, 1000.0) / 1000.0) * logstep,
        mels,
    )


def mel_to_hertz_slaney(mels) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freq = 200.0 * mels / 3.0
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= 15.0, 1000.0 * np.exp(logstep * (np.maximum(mels, 15.0) - 15.0)), freq
    )


def mel_filter_bank_slaney(num_frequency_bins: int, num_mel_filters: int,
                           min_frequency: float, max_frequency: float,
                           sampling_rate: int) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular filters [freq_bins, mels]."""
    mel_freqs = np.linspace(hertz_to_mel_slaney(min_frequency),
                            hertz_to_mel_slaney(max_frequency), num_mel_filters + 2)
    filter_freqs = mel_to_hertz_slaney(mel_freqs)
    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)
    fdiff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (filter_freqs[2:num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    return (fb * enorm[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_and_filterbank(cfg: AudioFrontendConfig) -> Tuple[np.ndarray, np.ndarray]:
    """[n_fft, 2*bins] windowed cos|sin DFT matrix and [bins, mels] filterbank."""
    n_fft = cfg.n_fft
    n = np.arange(n_fft, dtype=np.float64)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * n / n_fft)
    bins = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.outer(n, np.arange(bins, dtype=np.float64)) / n_fft
    dft = np.concatenate([(np.cos(ang) * window[:, None]).astype(np.float32),
                          (np.sin(ang) * window[:, None]).astype(np.float32)], axis=1)
    fb = mel_filter_bank_slaney(bins, cfg.num_mel_bins, cfg.f_min, cfg.f_max, cfg.sample_rate)
    return dft, fb


def mel_constants(cfg: AudioFrontendConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_dft_and_filterbank(cfg)`` on ``device``, made once per device."""
    return tuple(device_constant((name, cfg), lambda _, i=i: _dft_and_filterbank(cfg)[i], device)
                 for i, name in enumerate(("mel_dft", "mel_filterbank")))


def log_mel_spectrogram(waveform: torch.Tensor,
                        cfg: AudioFrontendConfig | None = None) -> torch.Tensor:
    """[..., samples] -> [..., frames, mels] log-mel in dB (fp32)."""
    cfg = cfg or AudioFrontendConfig()
    dft, fb = mel_constants(cfg, waveform.device)
    x = waveform.float()
    pad = cfg.n_fft // 2
    lead = x.shape[:-1]
    x = torch.nn.functional.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                                mode="reflect").reshape(*lead, -1)
    frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)  # [..., F, n_fft]
    spec = torch.matmul(frames, dft)
    bins = cfg.n_fft // 2 + 1
    re, im = spec[..., :bins], spec[..., bins:]
    mel = torch.matmul(re * re + im * im, fb)
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def fit_to_length(x: np.ndarray, target: int) -> np.ndarray:
    """Repeat-pad shorter audio, crop longer audio, to ``target`` samples."""
    if len(x) < target:
        if len(x) > 0:
            x = np.tile(x, max(target // len(x), 1))
        x = np.pad(x, (0, target - len(x)))
    elif len(x) > target:
        x = x[:target]
    return x


# outputs gathered at once: [chunk, taps] float64 products (~17 MB at 33 taps)
RESAMPLE_CHUNK = 65_536


def resample_poly(x: np.ndarray, orig_sr: int, target_sr: int,
                  keep: Optional[int] = None) -> np.ndarray:
    """Polyphase resampling of 1-D float audio (kaiser-windowed sinc, beta
    8.555): the function of ``clap2diffusion_tpu/utils/audio_io.py::
    resample_poly`` (the same filter, gain, delay and ``ceil(len*up/down)``
    outputs), but only the first ``keep`` outputs (all when None) and only
    the products with input samples. JAX's zero-stuffs the signal by ``up``
    and convolves all of it; output m is

        y[m] = sum_i x[i] * h[half + m*down - i*up],  0 <= half + m*down - i*up <= 2*half,

    about 32*max(up, down)/up + 1 products (33 at 44.1 kHz). Summed in
    float64 and cast to float32 once, as JAX's."""
    if orig_sr == target_sr:
        return np.asarray(x, dtype=np.float32)[:keep]
    frac = Fraction(target_sr, orig_sr)
    up, down = frac.numerator, frac.denominator
    x = np.asarray(x, dtype=np.float64)
    cutoff = min(1.0 / up, 1.0 / down)
    half = 16 * max(up, down)
    n = np.arange(-half, half + 1, dtype=np.float64)
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(len(n), 8.555) * up
    n_out = int(math.ceil(len(x) * up / down))
    if keep is not None:
        n_out = min(n_out, keep)
    # output m's first input is lo = ceil((m*down - half) / up), in
    # [-half/up, len(x)]; its taps t = half + m*down - (lo + k)*up fall in
    # (-up, 2*half] for k < taps, so h is zero-padded by up below, and x by
    # taps on both sides
    taps = 2 * half // up + 1
    hp = np.concatenate([np.zeros(up), h])
    xp = np.concatenate([np.zeros(taps), x, np.zeros(taps)])
    k = np.arange(taps)
    y = np.empty(n_out, dtype=np.float64)
    for start in range(0, n_out, RESAMPLE_CHUNK):
        m = np.arange(start, min(start + RESAMPLE_CHUNK, n_out))
        lo = -((half - m * down) // up)
        i = lo[:, None] + k  # [chunk, taps] input indices
        t = half + m[:, None] * down - i * up
        y[start:start + len(m)] = (xp[i + taps] * hp[t + up]).sum(1)
    return y.astype(np.float32)


def prepare_waveform(waveform: np.ndarray, sample_rate: int,
                     cfg: AudioFrontendConfig | None = None) -> np.ndarray:
    """Host side: mono-ize, resample to the configured rate, repeat-pad or
    crop to the configured length. A longer source is resampled only as far
    as the crop keeps."""
    cfg = cfg or AudioFrontendConfig()
    x = np.asarray(waveform, dtype=np.float32)
    if x.ndim == 2:
        x = x.mean(axis=0)
    if sample_rate != cfg.sample_rate:
        x = resample_poly(x, sample_rate, cfg.sample_rate, keep=cfg.num_samples)
    return fit_to_length(x, cfg.num_samples)
