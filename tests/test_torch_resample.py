"""The port's polyphase resampler and host audio frontend against the JAX
package's, at tolerance 0 (float32 out).

The port's ``resample_poly`` sums only the products of each kept output
with input samples; JAX's zero-stuffs the signal and convolves all of it.
Both sum in float64 and cast once, so the float32 outputs are equal. The
JAX function is the slow one (len * up * (32 * max(up, down) + 1)
products), so its inputs here are short: 0.1 s at 44.1 kHz, 0.03 s at
22.05 kHz, 0.01 s at 11.025 kHz."""

import dataclasses
import time
from fractions import Fraction

import numpy as np
import pytest

from clap2diffusion_tpu.core.config import AudioFrontendConfig as JFront
from clap2diffusion_tpu.data import prepare as JPrep
from clap2diffusion_tpu.models.clap.frontend import prepare_waveform as jprepare
from clap2diffusion_tpu.utils import audio_io as JA
from clap2diffusion_tpu.utils import native_audio as JN
from clap2diffusion_tpu_torch.core.config import AudioFrontendConfig, Config
from clap2diffusion_tpu_torch.data import prepare as PPrep
from clap2diffusion_tpu_torch.models.clap.frontend import prepare_waveform, resample_poly
from clap2diffusion_tpu_torch.utils import audio_io as PA
from clap2diffusion_tpu_torch.utils import native_audio as PN

# (source rate, target rate, seconds of the longest input)
RATES = [(8_000, 48_000, 0.1), (11_025, 48_000, 0.01), (16_000, 48_000, 0.1),
         (22_050, 48_000, 0.03), (32_000, 48_000, 0.1), (44_100, 48_000, 0.1),
         (88_200, 48_000, 0.05), (96_000, 48_000, 0.1), (16_000, 24_000, 0.1)]


def taps(sr, target):
    """Input samples one output's filter spans (2 * half / up + 1)."""
    f = Fraction(target, sr)
    return 2 * 16 * max(f.numerator, f.denominator) // f.numerator + 1


def signal(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 1000.0
    return (0.5 * np.sin(2 * np.pi * 3.3 * t) + 0.2 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("length", ["1", "7", "half_filter", "filter_plus_3", "longest"])
@pytest.mark.parametrize("sr,target,seconds", RATES, ids=[f"{a}to{b}" for a, b, _ in RATES])
def test_resample_poly_equals_jax(sr, target, seconds, length):
    n = {"1": 1, "7": 7, "half_filter": taps(sr, target) // 2,
         "filter_plus_3": taps(sr, target) + 3, "longest": int(sr * seconds)}[length]
    x = signal(n, seed=n + sr)
    ours, ref = resample_poly(x, sr, target), JA.resample_poly(x, sr, target)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.shape == ref.shape == (int(np.ceil(n * target / sr)),)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("keep", [0, 1, 100, 4_800, 10_000])
def test_resample_poly_keep_is_a_prefix(keep):
    x = signal(4_410, seed=3)
    full = JA.resample_poly(x, 44_100, 48_000)
    ours = resample_poly(x, 44_100, 48_000, keep=keep)
    np.testing.assert_array_equal(ours, full[:keep])


def test_resample_poly_at_the_target_rate_is_a_cast():
    x = signal(100, seed=4).astype(np.float64)
    np.testing.assert_array_equal(resample_poly(x, 48_000, 48_000), x.astype(np.float32))
    np.testing.assert_array_equal(resample_poly(x, 48_000, 48_000, keep=10),
                                  x[:10].astype(np.float32))


# 44.1 kHz sources against a 0.1 s target (4,800 samples): 0.2 s is cropped,
# 0.05 s tiled; [channels, samples] is mixed to mono first
SOURCES = {"cropped": (8_820,), "tiled": (2_205,), "stereo": (2, 8_820)}


@pytest.mark.parametrize("kind", list(SOURCES))
def test_prepare_waveform_equals_jax(kind):
    shape = SOURCES[kind]
    x = np.random.default_rng(len(shape) + shape[-1]).normal(size=shape).astype(np.float32)
    fe = dataclasses.replace(AudioFrontendConfig(), duration_s=0.1)
    jfe = dataclasses.replace(JFront(), duration_s=0.1)
    ours, ref = prepare_waveform(x, 44_100, fe), jprepare(x, 44_100, jfe)
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape == (4_800,)
    np.testing.assert_array_equal(ours, ref)


def test_prepare_waveform_ten_seconds_at_44k_is_fast():
    """The fault stays gone: the zero-stuffed convolution took ~90 s for
    10 s of 44.1 kHz audio; summing only the kept products takes well
    under a second."""
    cfg = Config().clap.frontend
    x = signal(44_100 * 10, seed=5)
    t0 = time.perf_counter()
    out = prepare_waveform(x, 44_100, cfg)
    wall = time.perf_counter() - t0
    assert out.shape == (cfg.num_samples,) and np.isfinite(out).all()
    assert wall < 10.0, f"prepare_waveform took {wall:.1f} s for 10 s at 44.1 kHz"


@pytest.mark.parametrize("seconds", [0.2, 0.05])
def test_process_audio_file_equals_jax(tmp_path, seconds):
    """``prepare``'s per-file step resamples only the kept 0.1 s of a
    longer 44.1 kHz source, and all of a shorter one (then pads)."""
    src = str(tmp_path / "src.wav")
    PA.write_wav(src, signal(int(44_100 * seconds), seed=6), 44_100)
    outs = {}
    for name, fn in (("port", PPrep.process_audio_file), ("jax", JPrep.process_audio_file)):
        outs[name] = str(tmp_path / f"{name}.wav")
        assert fn(src, outs[name], 48_000, 0.1)
    with open(outs["port"], "rb") as a, open(outs["jax"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("peak_norm", [False, True])
def test_native_fallback_equals_jax(tmp_path, peak_norm):
    src = str(tmp_path / "src.wav")
    PA.write_wav(src, signal(8_820, seed=7), 44_100)
    np.testing.assert_array_equal(PN._fallback_one(src, 48_000, 4_800, peak_norm),
                                  JN._fallback_one(src, 48_000, 4_800, peak_norm))


@pytest.mark.slow
def test_ten_second_44k_file_equals_jax():
    """A whole 10 s 44.1 kHz clip against JAX's (~90 s for the JAX side)."""
    x = signal(44_100 * 10, seed=8)
    np.testing.assert_array_equal(resample_poly(x, 44_100, 48_000),
                                  JA.resample_poly(x, 44_100, 48_000))
