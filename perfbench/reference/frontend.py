"""The CLAP log-mel frontend, in plain PyTorch and numpy: reflect-padded
frames, a periodic Hann window, the power spectrum by a DFT product, the
Slaney-scale, Slaney-normalised mel filterbank, and 10 * log10 clamped at
1e-10 (the HF ``ClapFeatureExtractor``'s ``fusion=False`` path)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.plain import device_constant


def hertz_to_mel_slaney(freq) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    mels = 3.0 * freq / 200.0
    logstep = 27.0 / np.log(6.4)
    return np.where(freq >= 1000.0,
                    15.0 + np.log(np.maximum(freq, 1000.0) / 1000.0) * logstep, mels)


def mel_to_hertz_slaney(mels) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freq = 200.0 * mels / 3.0
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= 15.0, 1000.0 * np.exp(logstep * (np.maximum(mels, 15.0) - 15.0)),
                    freq)


def mel_filter_bank_slaney(bins: int, mels: int, f_min: float, f_max: float,
                           rate: int) -> np.ndarray:
    """Triangular filters [bins, mels]."""
    mel_freqs = np.linspace(hertz_to_mel_slaney(f_min), hertz_to_mel_slaney(f_max), mels + 2)
    filter_freqs = mel_to_hertz_slaney(mel_freqs)
    fft_freqs = np.linspace(0, rate // 2, bins)
    fdiff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (filter_freqs[2:mels + 2] - filter_freqs[:mels])
    return (fb * enorm[None, :]).astype(np.float32)


def _constants(n_fft: int, mels: int, f_min: float, f_max: float, rate: int):
    n = np.arange(n_fft, dtype=np.float64)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * n / n_fft)
    bins = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.outer(n, np.arange(bins, dtype=np.float64)) / n_fft
    dft = np.concatenate([(np.cos(ang) * window[:, None]).astype(np.float32),
                          (np.sin(ang) * window[:, None]).astype(np.float32)], axis=1)
    return dft, mel_filter_bank_slaney(bins, mels, f_min, f_max, rate)


def log_mel_spectrogram(waveform: torch.Tensor, fe) -> torch.Tensor:
    """[B, samples] -> [B, frames, mels] log-mel in dB (fp32); ``fe`` is the
    configuration's ``clap.frontend`` group."""
    key = (fe.n_fft, fe.num_mel_bins, fe.f_min, fe.f_max, fe.sample_rate)
    dft, fb = (device_constant(("ref_mel", key, i), lambda _, i=i: _constants(*key)[i],
                               waveform.device) for i in range(2))
    x = waveform.float()
    pad = fe.n_fft // 2
    x = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, fe.n_fft, fe.hop_length)
    spec = torch.matmul(frames, dft)
    bins = fe.n_fft // 2 + 1
    re, im = spec[..., :bins], spec[..., bins:]
    mel = torch.matmul(re * re + im * im, fb)
    return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
