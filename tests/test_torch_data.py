"""Host-side data and IO of the port against the JAX package: ``read_audio``
(WAV, FLAC, mp3, ffmpeg), the native loader built from ``native/`` by the
port (against the JAX package's library and against the numpy path),
malformed media, the caption parser, the raw-media dataset, the AudioCaps
preparation, ``encode_latents`` on a tiny VAE with the JAX draws, and the
``prepare`` CLI.

The port builds its own native library here with ``g++`` at first use,
into the build directory (``utils/native_audio.py``)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.data import caption_parser as JCP
from clap2diffusion_tpu.data import prepare as JPrep
from clap2diffusion_tpu.data import raw_dataset as JRaw
from clap2diffusion_tpu.utils import audio_io as JA
from clap2diffusion_tpu.utils import native_audio as JN
from clap2diffusion_tpu_torch import convert
from clap2diffusion_tpu_torch.data import caption_parser as PCP
from clap2diffusion_tpu_torch.data import prepare as PPrep
from clap2diffusion_tpu_torch.data import raw_dataset as PRaw
from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset
from clap2diffusion_tpu_torch.utils import audio_io as PA
from clap2diffusion_tpu_torch.utils import native_audio as PN
from clap2diffusion_tpu_torch.utils.png import encode_png
from tests.flac_fixture import write_flac
from tests.mp3_fixture import write_mp3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tone(n, sr=48_000, f=440.0, seed=5, amp=0.4):
    rng = np.random.default_rng(seed)
    x = amp * np.sin(2 * np.pi * f * np.arange(n) / sr) + 0.05 * rng.normal(size=n)
    return np.clip(x * 32767, -32768, 32767).astype(np.int16)


FLAC_STREAMS = {  # name -> (kind, channels, stereo_mode, partition_order)
    "verbatim": ("verbatim", 1, None, 0),
    "fixed1": ("fixed1", 1, None, 0),
    "fixed1_partitions": ("fixed1", 1, None, 2),
    "lpc2": ("lpc2", 1, None, 0),
    "lpc2_partitions": ("lpc2", 1, None, 1),
    "stereo_independent": ("verbatim", 2, None, 0),
    "left_side": ("fixed1", 2, "left_side", 0),
    "right_side": ("fixed1", 2, "right_side", 0),
    "mid_side": ("verbatim", 2, "mid_side", 0),
    "constant": None,
}


def _write_flac_case(path, name):
    if FLAC_STREAMS[name] is None:
        write_flac(path, np.full(6000, 123, np.int16), 48_000)
        return
    kind, channels, mode, order = FLAC_STREAMS[name]
    x = _tone(10_000)
    if channels == 2:
        x = np.stack([x, (x // 2).astype(np.int16)])
    write_flac(path, x, 48_000, kind=kind, stereo_mode=mode, partition_order=order)


@pytest.mark.parametrize("name", list(FLAC_STREAMS))
def test_read_audio_flac_matches_jax(tmp_path, name):
    path = str(tmp_path / f"{name}.flac")
    _write_flac_case(path, name)
    got, got_sr = PA.read_audio(path)
    want, want_sr = JA.read_audio(path)
    assert got_sr == want_sr == 48_000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["pcm16_mono", "pcm16_stereo", "pcm16_44k1", "float32"])
def test_read_audio_wav_matches_jax(tmp_path, kind):
    path = str(tmp_path / f"{kind}.wav")
    x = _tone(9_000).astype(np.float32) / 32768.0
    if kind == "pcm16_stereo":
        PA.write_wav(path, np.stack([x, 0.5 * x]), 48_000)
    elif kind == "float32":
        import struct

        data = x.astype("<f4").tobytes()
        fmt = struct.pack("<HHIIHH", 3, 1, 48_000, 48_000 * 4, 4, 32)
        with open(path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
            f.write(b"fmt " + struct.pack("<I", 16) + fmt + b"data"
                    + struct.pack("<I", len(data)) + data)
    else:
        PA.write_wav(path, x, 44_100 if kind == "pcm16_44k1" else 48_000)
    got, got_sr = PA.read_audio(path)
    want, want_sr = JA.read_audio(path)
    assert got_sr == want_sr
    np.testing.assert_array_equal(got, want)


def test_read_audio_mp3_and_ffmpeg_match_jax(tmp_path, monkeypatch):
    """mp3 through the system's libmpg123 as JAX reads it; an unknown
    container raises the same error without ffmpeg and goes through a fake
    ffmpeg with it."""
    x = _tone(44_100, sr=44_100).astype(np.float32) / 32768.0
    mp3 = str(tmp_path / "tone.mp3")
    if write_mp3(mp3, x, 44_100):
        got, want = PA.read_audio(mp3), JA.read_audio(mp3)
        assert got[1] == want[1] == 44_100
        np.testing.assert_array_equal(got[0], want[0])
    fake = tmp_path / "clip.ogg"
    fake.write_bytes(b"OggS" + bytes(64))
    real_path = os.environ.get("PATH", "")
    monkeypatch.setenv("PATH", str(tmp_path / "nobin"))
    for read in (PA.read_audio, JA.read_audio):
        with pytest.raises(ValueError, match="unsupported audio container"):
            read(str(fake))
    ref = str(tmp_path / "decoded.wav")
    PA.write_wav(ref, x[:4800], 48_000)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    ffmpeg = bindir / "ffmpeg"
    ffmpeg.write_text(f"#!/bin/sh\nfor last; do :; done\ncp {ref} \"$last\"\n")
    ffmpeg.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{real_path}")
    np.testing.assert_array_equal(PA.read_audio(str(fake))[0], JA.read_audio(str(fake))[0])


def test_native_library_is_built_from_the_shared_sources():
    """The port's library is built under build/ from native/'s sources (the
    committed native/libc2d_audio.so is not the one loaded), keyed by the
    sources' hash; a failed build raises with the compiler's output."""
    lib = PN.load_library()
    path = PN.library_path()
    assert os.path.exists(path) and path.startswith(os.path.join(REPO, "build"))
    assert os.path.basename(path).startswith("libc2d_audio_")
    assert lib.c2d_abi_version() == 3
    committed = os.path.realpath(os.path.join(REPO, "native", "libc2d_audio.so"))
    assert os.path.realpath(path) != committed


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("C2D_TORCH_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="building the native audio loader failed"):
        PN.build()


def test_native_load_matches_jax_and_numpy(tmp_path):
    """load_audio and load_audio_batch of the port's library against the
    JAX package's on WAV (resampled and not), FLAC, a stereo WAV and a
    missing file; the WAVs against the numpy path within the JAX test's
    tolerance (tests/test_native_audio.py:44)."""
    paths = []
    for sr in (44_100, 48_000, 32_000):
        p = str(tmp_path / f"tone_{sr}.wav")
        PA.write_wav(p, _tone(sr // 2, sr=sr).astype(np.float32) / 32768.0, sr)
        paths.append(p)
    stereo = str(tmp_path / "stereo.wav")
    x = _tone(20_000).astype(np.float32) / 32768.0
    PA.write_wav(stereo, np.stack([x, -0.5 * x]), 48_000)
    flac = str(tmp_path / "clip.flac")
    write_flac(flac, _tone(30_000, sr=44_100), 44_100, kind="fixed1")
    paths += [stereo, flac, str(tmp_path / "missing.wav")]
    for peak in (False, True):
        for p in paths:
            got = PN.load_audio(p, 48_000, 36_000, peak_norm=peak)
            want = JN.load_audio(p, 48_000, 36_000, peak_norm=peak)
            np.testing.assert_allclose(got, want, atol=1e-6, err_msg=f"{p} {peak}")
            if p.endswith(".wav"):
                ref = PN._fallback_one(p, 48_000, 36_000, peak)
                assert np.abs(got - ref).max() < 5e-3, p
    got, got_st = PN.load_audio_batch(paths, 48_000, 24_000, num_threads=3)
    want, want_st = JN.load_audio_batch(paths, 48_000, 24_000, num_threads=3)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got_st, want_st)
    assert got_st.tolist() == [0, 0, 0, 0, 0, 1] and not got[-1].any()


def test_malformed_inputs_fail_as_in_jax(tmp_path):
    """Corrupt media: load_audio gives zeros, decode_audio raises (or returns
    the frames before a cut) in both packages alike; read_audio of a
    corrupt FLAC raises ValueError."""
    rng = np.random.default_rng(0)
    x = (np.sin(np.linspace(0, 80 * np.pi, 2_000)) * 0.5).astype(np.float32)
    wav_p, flac_p = tmp_path / "ok.wav", tmp_path / "ok.flac"
    PA.write_wav(str(wav_p), x, 48_000)
    write_flac(str(flac_p), x, 48_000, kind="fixed")
    wav_b, flac_b = wav_p.read_bytes(), flac_p.read_bytes()
    corpus = {
        "empty": b"", "short": b"RI", "noise": rng.bytes(4096),
        "riff_garbage": b"RIFF" + rng.bytes(512),
        "wav_size_lie": wav_b[:40] + b"\xf0\xff\xff\x0f" + wav_b[44:],
        "flac_garbage": b"fLaC" + rng.bytes(512), "id3_garbage": b"ID3" + rng.bytes(512),
        "flac_trunc": flac_b[:len(flac_b) // 2], "wav_trunc": wav_b[:len(wav_b) // 3],
    }
    for name, blob in corpus.items():
        p = str(tmp_path / f"{name}.bin")
        with open(p, "wb") as f:
            f.write(blob)
        np.testing.assert_array_equal(PN.load_audio(p, 48_000, 1_000),
                                      JN.load_audio(p, 48_000, 1_000), err_msg=name)
        outcomes = []
        for dec in (PN.decode_audio, JN.decode_audio):
            try:
                outcomes.append(dec(p)[0])
            except ValueError:
                outcomes.append("raised")
        if isinstance(outcomes[0], str) or isinstance(outcomes[1], str):
            assert outcomes[0] == outcomes[1], name
        else:
            np.testing.assert_array_equal(outcomes[0], outcomes[1], err_msg=name)
    bad = str(tmp_path / "bad.flac")
    with open(bad, "wb") as f:
        f.write(b"fLaC" + rng.bytes(512))
    for read in (PA.read_audio, JA.read_audio):
        with pytest.raises(ValueError):
            read(bad)


CAPTIONS = [
    "A woman speaks while a dog barks in the background",
    "a cat meows and a door opens",
    "a man talks at a concert",
    "thunder rumbles loudly",
    "Music playing with people talking and laughing",
    "rain falls",
    "a dog barks and rain falls and wind blows",
    "Birds chirping in the distance as a car passes by",
    "An engine revving, faintly, near a busy road.",
    "",
]


@pytest.mark.parametrize("caption", CAPTIONS)
def test_caption_parser_matches_jax(caption):
    got, want = PCP.AudioCaptionParser(), JCP.AudioCaptionParser()
    parsed = got.parse_caption(caption)
    assert parsed == want.parse_caption(caption)
    assert got.get_hierarchy_labels(parsed) == want.get_hierarchy_labels(parsed)
    assert PCP._clean_text(f" the {caption}. ") == JCP._clean_text(f" the {caption}. ")


@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    r = tmp_path_factory.mktemp("raw")
    make_fixture_dataset(str(r), n_train=12, n_val=2, n_test=1, duration_s=0.3, latent_hw=8)
    frames = r / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):  # PNG frames at the dataset's image size: read without Pillow
        (frames / f"sample_{i:05d}.png").write_bytes(
            encode_png(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)))
    return str(r)


@pytest.mark.parametrize("strategy", ["balanced", "creative", "matching"])
def test_raw_dataset_matches_jax(raw_root, strategy):
    """Pairs, labels, statistics and every seeded augmentation (crop, gain,
    noise, flip, brightness) equal to the JAX dataset's."""
    kw = dict(split="train", sample_rate=48_000, audio_duration=0.2, image_size=32,
              composition_strategy=strategy, seed=7)
    got, want = PRaw.AudioCapsHierarchicalDataset(raw_root, **kw), \
        JRaw.AudioCapsHierarchicalDataset(raw_root, **kw)
    assert got.composition_pairs == want.composition_pairs
    assert got.composition_statistics() == want.composition_statistics()
    assert got.parsed_captions == want.parsed_captions
    for i in range(min(len(got), 10)):
        a, b = got[i], want[i]
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=f"{i} {k}")
            else:
                assert a[k] == b[k], (i, k)


def test_raw_dataset_without_images_and_eval_split(raw_root):
    kw = dict(split="val", audio_duration=0.4, image_size=32, load_images=False)
    got, want = PRaw.AudioCapsHierarchicalDataset(raw_root, **kw), \
        JRaw.AudioCapsHierarchicalDataset(raw_root, **kw)
    assert len(got) == len(want) > 0
    for i in range(len(got)):
        assert "image" not in got[i]
        np.testing.assert_allclose(got[i]["audio"], want[i]["audio"], atol=1e-6)


def test_prepare_audiocaps_matches_jax(tmp_path):
    """A CSV of WAV (44.1 and 48 kHz, stereo) and FLAC sources, one row
    without a source: the same metadata and the same WAV bytes."""
    src = tmp_path / "src"
    src.mkdir()
    rows = []
    for i in range(12):
        sid = f"vid_{i:02d}"
        x = _tone(12_000 + 500 * i, sr=44_100 if i % 3 else 48_000, seed=i)
        if i % 4 == 0:
            write_flac(str(src / f"{sid}.flac"), x, 44_100 if i % 3 else 48_000, kind="lpc2")
        elif i % 4 == 1:
            PA.write_wav(str(src / f"{sid}.wav"),
                         np.stack([x, x // 3]).astype(np.float32) / 32768.0, 48_000)
        elif i != 7:
            PA.write_wav(str(src / f"{sid}.wav"), x.astype(np.float32) / 32768.0,
                         44_100 if i % 3 else 48_000)
        rows.append(f"{sid},caption number {i},0")
    (tmp_path / "a.csv").write_text("youtube_id,caption,start_time\n" + "\n".join(rows) + "\n")
    assert PPrep.SOURCE_EXTENSIONS == JPrep.SOURCE_EXTENSIONS
    assert PPrep.find_source(str(src), "vid_00") == JPrep.find_source(str(src), "vid_00")
    got = PPrep.prepare_audiocaps(str(tmp_path / "a.csv"), str(src), str(tmp_path / "p"))
    want = JPrep.prepare_audiocaps(str(tmp_path / "a.csv"), str(src), str(tmp_path / "j"))
    assert got == want and len(got["samples"]) == 11
    for s in got["samples"]:
        assert (tmp_path / "p" / "audio" / f"{s['id']}.wav").read_bytes() == \
            (tmp_path / "j" / "audio" / f"{s['id']}.wav").read_bytes(), s["id"]
    assert json.loads((tmp_path / "p" / "metadata_unified.json").read_text()) == want


def _frames(root, n=3, size=32):
    frames = root / "frames"
    frames.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        (frames / f"vid_{i}.png").write_bytes(
            encode_png(rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)))
    return frames


def test_encode_latents_matches_jax(tmp_path, monkeypatch):
    """A tiny VAE (8/16/16/16), 32² frames, batch 2 over 3 frames (the last
    chunk padded), the JAX weights through from_flax and the JAX draws:
    every latent within 1e-4 of JAX's, NCHW."""
    import jax.numpy as jnp

    from clap2diffusion_tpu.core.config import VAEConfig as JVAEConfig
    from clap2diffusion_tpu.models.vae import AutoencoderKL
    from clap2diffusion_tpu_torch.core.config import VAEConfig

    jcfg = JVAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4)
    pcfg = VAEConfig(**dataclasses.asdict(jcfg))
    params = AutoencoderKL(cfg=jcfg).init(jax.random.key(3), jnp.ones((1, 32, 32, 3)),
                                          jax.random.key(1))["params"]
    for root in (tmp_path / "j", tmp_path / "p"):
        _frames(root)

    def jax_draws(seed, device):  # the JAX loop's split sequence, one draw per chunk
        state = {"rng": jax.random.key(seed)}

        def draw(shape):
            state["rng"], sub = jax.random.split(state["rng"])
            return torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32)))
        return draw

    monkeypatch.setattr(PPrep, "latent_draws", jax_draws)
    n_j = JPrep.encode_latents(str(tmp_path / "j"), vae_params=params, vae_cfg=jcfg,
                               batch_size=2, image_size=32, seed=4)
    n_p = PPrep.encode_latents(str(tmp_path / "p"), vae_params=convert.vae_from_flax(params),
                               vae_cfg=pcfg, batch_size=2, image_size=32, seed=4, device="cpu")
    assert n_j == n_p == 3
    for i in range(3):
        got = np.load(tmp_path / "p" / "latents" / f"vid_{i}.npy")
        want = np.load(tmp_path / "j" / "latents" / f"vid_{i}.npy")
        assert got.shape == want.shape == (4, 4, 4)
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=str(i))
    assert PPrep.encode_latents(str(tmp_path / "none"), device="cpu") == 0


def test_encode_latents_runs_full_fp32(tmp_path, monkeypatch):
    """Under PyTorch's defaults (cuDNN's TF32 on) the encode runs with TF32
    off for cuDNN and cuBLAS, and the caller's flags come back afterwards."""
    from clap2diffusion_tpu_torch.core.config import VAEConfig
    from clap2diffusion_tpu_torch.models.vae import AutoencoderKL

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    inner, during = AutoencoderKL.sample_latent, []

    def spy(self, x, draw):
        during.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return inner(self, x, draw)

    monkeypatch.setattr(AutoencoderKL, "sample_latent", spy)
    _frames(tmp_path)
    assert PPrep.encode_latents(str(tmp_path), batch_size=2, image_size=32, device="cpu",
                                vae_cfg=VAEConfig(block_out_channels=(8, 16, 16, 16),
                                                  norm_num_groups=4)) == 3
    assert during == [(False, False)] * 2
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == \
        (True, False)


def test_prepare_cli_csv_and_encode_latents(tmp_path, monkeypatch):
    """``prepare --csv --audio-dir --encode-latents --frames-dir --device
    cpu`` end to end (the VAE cut to the tiny geometry: the CLI's is the
    full SD VAE at 512²)."""
    from clap2diffusion_tpu_torch.apps import main as M
    from clap2diffusion_tpu_torch.core.config import VAEConfig

    src = tmp_path / "src"
    src.mkdir()
    write_flac(str(src / "a.flac"), _tone(20_000), 48_000, kind="lpc2")
    PA.write_wav(str(src / "b.wav"), _tone(20_000, sr=44_100).astype(np.float32) / 32768.0,
                 44_100)
    (tmp_path / "a.csv").write_text("youtube_id,caption\na,one\nb,two\n")
    frames = _frames(tmp_path / "f")
    orig = PPrep.encode_latents
    seen = {}

    def small(data_root, frames_dir=None, device=None, **kw):
        seen["device"] = device
        return orig(data_root, frames_dir=frames_dir, device=device, batch_size=2,
                    image_size=32, vae_cfg=VAEConfig(block_out_channels=(8, 16, 16, 16),
                                                     norm_num_groups=4))

    monkeypatch.setattr(PPrep, "encode_latents", small)
    out = tmp_path / "out"
    assert M.main(["prepare", "--csv", str(tmp_path / "a.csv"), "--audio-dir", str(src),
                   "--out", str(out), "--encode-latents", "--frames-dir", str(frames),
                   "--device", "cpu"]) == 0
    meta = json.loads((out / "metadata_unified.json").read_text())
    assert sorted(s["id"] for s in meta["samples"]) == ["a", "b"]
    assert sorted(os.listdir(out / "latents")) == [f"vid_{i}.npy" for i in range(3)]
    assert seen["device"] == "cpu"
    wav, sr = PA.read_wav(str(out / "audio" / "a.wav"))
    assert sr == 48_000 and wav.shape == (480_000,)
