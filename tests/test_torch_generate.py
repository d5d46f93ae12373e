"""The rest of ``generate`` in the port, against the JAX package, on the CPU.

At ``tests/test_pipeline.py::tiny_config`` in fp32, from the same weights
(``convert.from_flax``):

- the VAE encoder (``encode``, ``sample_latent`` and the whole VAE with the
  posterior noise fed in) against the JAX VAE, within 2e-4 as the decode
  test;
- whole requests through the port's ``generate`` against the JAX
  ``_generate_jit`` through its ``generate``, with every random draw of the
  port replaced by the JAX program's own threefry draws (``key(seed)``,
  ``split`` into the VAE and img2img noise, ``fold_in(key, 0x5A)`` for the
  sampler, ``vmap(key)(seeds)`` per lane), held to the frozen image
  golden's bounds (mean |d| < 0.5, under 1% of pixels off by more than 2):
  sonic, img2img, inpainting, euler_a, dpmpp_2m_karras, two-audio mixing,
  per-lane seeds, dpmpp_2m, text only, PCM16, baseline and audio_tokens
  (each through the port's device program, ``diffusion/program.py``);
- every argument check of ``_dispatch_generate`` with the JAX tests'
  ``match=`` strings, the per-lane-seed and inpainting properties of
  ``tests/test_pipeline.py``, ``generate_stream``, the host-side loaders
  against the JAX ones, the adapter's weights from a stage-1 checkpoint,
  and the registration order that keeps a seed's decoder and UNet weights.
"""

import io
import struct
import sys

import jax
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.diffusion.pipeline import AudioToImagePipeline as JaxPipeline
from clap2diffusion_tpu.diffusion.pipeline import init_params
from clap2diffusion_tpu_torch import convert
from clap2diffusion_tpu_torch.data.fixtures import make_fixture_dataset
from clap2diffusion_tpu_torch.diffusion import pipeline as P
from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline, RequestDraws
from clap2diffusion_tpu_torch.utils.audio_io import write_wav
from tests.test_pipeline import tiny_config
from tests.test_torch_models import port_cfg

torch.set_num_threads(2)

SIZE = 64  # tiny_config's image size
MAX_LEN = 7  # its CLIP length


def to_torch(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    params = jax.tree.map(np.asarray, init_params(cfg, seed=0))
    port = AudioToImagePipeline(port_cfg(cfg), params=convert.from_flax(params), device="cpu")
    return cfg, params, JaxPipeline(cfg, params=params), port


class JaxDraws(RequestDraws):
    """The draws of the JAX program ``_generate_jit`` for ``seed`` (or
    ``seeds``), as the port's ``RequestDraws``."""

    def __init__(self, seed, seeds=None):
        self.key = jax.random.key(np.int32(seed))
        self.rng_enc, self.rng_noise = jax.random.split(self.key)
        self.keys = None if seeds is None else jax.vmap(jax.random.key)(
            np.asarray(seeds, np.int32))

    def latents(self, shape):
        if self.keys is None:
            return to_torch(jax.random.normal(self.key, shape))
        return to_torch(jax.vmap(lambda k: jax.random.normal(k, shape[1:]))(self.keys))

    def vae(self, shape):
        return to_torch(jax.random.normal(self.rng_enc, shape, np.float32))

    def img2img(self, shape):
        return to_torch(jax.random.normal(self.rng_noise, shape))

    def sampler(self):
        if self.keys is None:
            samp = jax.random.fold_in(self.key, 0x5A)
            return lambda i, shape: to_torch(
                jax.random.normal(jax.random.fold_in(samp, i), shape))
        samp = jax.vmap(lambda k: jax.random.fold_in(k, 0x5A))(self.keys)
        return lambda i, shape: to_torch(jax.vmap(
            lambda k: jax.random.normal(jax.random.fold_in(k, i), shape[1:]))(samp))


def _wav(seed, n=24_000):
    return (np.random.default_rng(seed).normal(size=n) * 0.1).astype(np.float32)


def _init(seed):
    return np.random.default_rng(seed).integers(0, 255, size=(SIZE, SIZE, 3)).astype(np.uint8)


def _half_mask():
    m = np.zeros((SIZE, SIZE), np.uint8)
    m[:, SIZE // 2:] = 255  # regenerate the right half
    return m


IDS = (np.arange(MAX_LEN)[None] % 97).astype(np.int32)  # differs from the empty uncond

REQUESTS = {
    "sonic": dict(waveform=_wav(0), text_ids=IDS, model_type="sonic", seed=3),
    "img2img": dict(waveform=_wav(1), text_ids=IDS, init_image=_init(7), strength=0.67, seed=3),
    "inpainting": dict(waveform=_wav(2), text_ids=IDS, init_image=_init(13), strength=1.0,
                       mask_image=_half_mask(), seed=9),
    "euler_a": dict(waveform=_wav(3), text_ids=IDS, sampler="euler_a", seed=4),
    "dpmpp_2m_karras": dict(waveform=_wav(4), text_ids=IDS, sampler="dpmpp_2m_karras", seed=4),
    "audio_mix": dict(waveform=_wav(5), waveform2=_wav(6), audio_mix=0.5, text_ids=IDS, seed=5),
    "seeds": dict(waveform=_wav(7), text_ids=np.repeat(IDS, 2, 0), batch=2, seeds=[5, 7]),
    "seeds_euler_a": dict(waveform=_wav(8), text_ids=np.repeat(IDS, 2, 0), batch=2,
                          seeds=[5, 7], sampler="euler_a"),
    # the rest of tests/test_torch_program.py's request kinds (hierarchical
    # DDIM is tests/test_torch_pipeline.py's golden)
    "dpmpp_2m": dict(waveform=_wav(9), text_ids=IDS, sampler="dpmpp_2m", seed=6),
    "text_only": dict(text_ids=IDS, seed=7),
    "pcm16": dict(waveform=(_wav(10) * 3e4).astype(np.int16), text_ids=IDS, seed=8),
    "baseline": dict(waveform=_wav(11), text_ids=IDS, model_type="baseline", seed=9),
    "audio_tokens": dict(waveform=_wav(12), text_ids=IDS, model_type="audio_tokens", seed=10),
}


def _port_with_jax_draws(port, monkeypatch):
    monkeypatch.setattr(port, "draws", lambda seed, seeds=None: JaxDraws(seed, seeds))
    return port


@pytest.mark.parametrize("name", list(REQUESTS))
def test_request_matches_jax_with_its_draws(tiny, monkeypatch, name):
    _, _, jpipe, port = tiny
    kw = dict(REQUESTS[name], num_steps=3)
    want = jpipe.generate(**kw)
    got = _port_with_jax_draws(port, monkeypatch).generate(**kw)
    assert got.shape == want.shape and got.dtype == np.uint8 and got.std() > 0
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    # the frozen image golden's bounds (tests/test_image_golden.py)
    assert float(diff.mean()) < 0.5 and float((diff > 2).mean()) < 0.01, (
        f"mean|d|={diff.mean():.3f}, >2 {(diff > 2).mean():.2%}")


def test_vae_encoder_matches_jax(tiny):
    from clap2diffusion_tpu.models.vae import AutoencoderKL as JVAE

    cfg, params, _, port = tiny
    x = np.random.default_rng(8).uniform(-1, 1, size=(2, SIZE, SIZE, 3)).astype(np.float32)
    jv, p = JVAE(cfg=cfg.diffusion.vae), {"params": params["vae"]}
    rng = jax.random.key(21)
    draw = lambda shape: to_torch(jax.random.normal(rng, shape, np.float32))  # noqa: E731
    mean, logvar = jv.apply(p, x, method=JVAE.encode)
    with torch.no_grad():
        pm, plv = port.vae.encode(to_torch(x))
        z = port.vae.sample_latent(to_torch(x), draw)
        rec = port.vae(to_torch(x), draw)
    assert pm.shape == (2, SIZE // 8, SIZE // 8, 4)
    for ours, ref in ((pm, mean), (plv, logvar),
                      (z, jv.apply(p, x, rng, method=JVAE.sample_latent)),
                      (rec, jv.apply(p, x, rng))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)


VALIDATION = [
    (dict(sampler="euler"), "unknown sampler"),
    (dict(model_type="sonicdiffusion"), "unknown model_type"),
    (dict(init_image=np.zeros((32, 32, 3), np.uint8)), "init_image must be"),
    (dict(init_image=np.zeros((SIZE, SIZE, 3), np.uint8), strength=0.0), "strength"),
    (dict(init_image=np.zeros((SIZE, SIZE, 3), np.float32)), "uint8"),
    (dict(waveform2=_wav(1)), "waveform2 requires"),
    (dict(waveform=np.stack([_wav(1)] * 2), waveform2=_wav(2), batch=2), "must match"),
    (dict(mask_image=_half_mask()), "mask_image requires"),
    (dict(init_image=_init(1), strength=1.0, mask_image=np.zeros((16, 16), np.uint8)),
     "mask_image must be"),
    (dict(seeds=[1, 2]), "seeds has"),
    (dict(seeds=[1], init_image=_init(1)), "per-lane seeds"),
    (dict(guidance_rescale=1.5), "guidance_rescale"),
]


@pytest.mark.parametrize("kw,match", VALIDATION, ids=[m for _, m in VALIDATION])
def test_dispatch_validates_like_jax(tiny, kw, match):
    port = tiny[3]
    with pytest.raises(ValueError, match=match):
        port.generate(num_steps=2, **kw)


def test_per_lane_seeds_batch_invariant(tiny):
    """tests/test_pipeline.py's property on the port: a lane's image is its
    seed's alone. Its initial latents are the solo draw bit for bit, and
    lanes of one batch with one seed are equal bit for bit. Solo against a
    lane of batch 2 is not bit-equal on the CPU: the UNet runs at CFG
    batch 2 against 4, PyTorch's CPU matmuls and convs block their fp32
    sums by batch, and a value on the edge of a uint8 level can move one
    level (as JAX notes for its per-shape compilations, "<= 1 uint8
    step"). Bound held: at most one level, on under 0.1% of the values."""
    port = tiny[3]
    solo = port.generate(text_ids=IDS, num_steps=2, seeds=[5])
    duo = port.generate(text_ids=np.repeat(IDS, 2, 0), batch=2, num_steps=2, seeds=[7, 5])
    d = np.abs(solo[0].astype(int) - duo[1].astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    assert np.abs(duo[0].astype(int) - duo[1].astype(int)).max() > 0
    twin = port.generate(text_ids=np.repeat(IDS, 2, 0), batch=2, num_steps=2, seeds=[5, 5])
    np.testing.assert_array_equal(twin[0], twin[1])
    # a lane's initial latents are the solo draw of its seed, bit for bit
    lanes = port.draws(0, [7, 5]).latents((2, 8, 8, 4))
    torch.testing.assert_close(lanes[1:], port.draws(5).latents((1, 8, 8, 4)), rtol=0, atol=0)


def test_inpainting_mask_semantics(tiny):
    """tests/test_pipeline.py's property on the port: an all-255 mask is
    img2img bit for bit, the regenerated half tracks plain img2img more
    closely than the kept half, and a request repeats bit for bit."""
    port = tiny[3]
    kw = dict(waveform=_wav(13), num_steps=3, seed=9, init_image=_init(13), strength=1.0)
    plain = port.generate(**kw)
    ones = port.generate(**kw, mask_image=np.full((SIZE, SIZE), 255, np.uint8))
    np.testing.assert_array_equal(plain, ones)
    half = port.generate(**kw, mask_image=_half_mask())
    d_right = np.abs(half[0, :, 32:].astype(int) - plain[0, :, 32:].astype(int)).mean()
    d_left = np.abs(half[0, :, :32].astype(int) - plain[0, :, :32].astype(int)).mean()
    assert d_right < d_left, (d_right, d_left)
    np.testing.assert_array_equal(half, port.generate(**kw, mask_image=_half_mask()))
    # bool and float masks mean what uint8 means
    np.testing.assert_array_equal(half, port.generate(**kw, mask_image=_half_mask() > 0))
    np.testing.assert_array_equal(
        half, port.generate(**kw, mask_image=_half_mask().astype(np.float32) / 255.0))


def test_latent_mask_matches_jax_preparation():
    m = np.random.default_rng(3).integers(0, 256, size=(2, SIZE, SIZE)).astype(np.uint8)
    got = P._latent_mask(m, SIZE)
    want = (m.astype(np.float32) / 255.0).reshape(2, 8, 8, 8, 8).mean(axis=(2, 4))[..., None]
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert P._latent_mask(m[0] > 127, SIZE).shape == (1, 8, 8, 1)


def test_sonic_and_modes(tiny):
    port = tiny[3]
    wav = _wav(0)
    a = port.generate(waveform=wav, num_steps=2, seed=3, model_type="hierarchical")
    b = port.generate(waveform=wav, num_steps=2, seed=3, model_type="sonic")
    assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() > 0
    # the blend is exact at audio_mix=1: the single-audio image, within 2 levels
    mixed = port.generate(waveform=wav, waveform2=_wav(6), audio_mix=1.0, num_steps=2, seed=3)
    np.testing.assert_allclose(a.astype(np.float32), mixed.astype(np.float32), atol=2)


def test_generate_stream_gives_generate_bits(tiny):
    port = tiny[3]
    reqs = [dict(waveform=_wav(i), seed=i) for i in range(3)]
    solo = [port.generate(num_steps=2, **r) for r in reqs]
    streamed = list(port.generate_stream(reqs, depth=2, num_steps=2))
    assert len(streamed) == 3
    for a, b in zip(solo, streamed):
        np.testing.assert_array_equal(a, b)
    timed = list(port.generate_stream_timed(reqs[:2], depth=1, num_steps=2))
    np.testing.assert_array_equal(timed[1][0], solo[1])
    assert all(s > 0 for _, s in timed)


def test_random_init_order_keeps_decoder_and_unet(tiny):
    """The encoder and the adapter are registered after what a seed drew
    before them: with or without them, seed 0 gives the decoder and the
    UNet the same weights."""
    cfg = port_cfg(tiny[0])
    full = P.build_modules(cfg)
    old = P.build_modules(cfg)
    del old["adapter"]
    del old["vae"].encoder, old["vae"].quant_conv
    for mods in (full, old):
        gen = torch.Generator().manual_seed(0)
        for m in mods.values():
            P.random_init_(m, gen, P._special_init(cfg))
    for tower in ("unet", "vae"):
        want = old[tower].state_dict()
        got = {k: v for k, v in full[tower].state_dict().items() if k in want}
        assert len(got) == len(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    # the pipeline draws them this way
    pipe = AudioToImagePipeline(cfg, seed=0, device="cpu")
    k = "decoder.conv_in.weight"
    torch.testing.assert_close(pipe.vae.state_dict()[k], old["vae"].state_dict()[k],
                               rtol=0, atol=0)


def test_stage1_adapter_serves_sonic(tiny, tmp_path):
    """Stage 1 trains the adapter; ``merge_stage_params(..., stage=1)``
    hands it to a pipeline whose params had none, which then loads it
    strictly and serves ``sonic``. Without it, sonic raises."""
    from clap2diffusion_tpu_torch.core import config as C
    from clap2diffusion_tpu_torch.train import checkpoint as ckpt
    from clap2diffusion_tpu_torch.train.trainer import run_stage
    from tests.test_torch_trainer import OVERRIDES

    cfg, params, _, _ = tiny
    full = convert.from_flax(params)
    serving = {k: v for k, v in full.items() if k != "adapter"}
    bare = AudioToImagePipeline(port_cfg(cfg), params=serving, device="cpu")
    assert bare.adapter is None
    with pytest.raises(ValueError, match="adapter"):
        bare.generate(waveform=_wav(0), num_steps=2, model_type="sonic")
    root, ck = str(tmp_path / "data"), str(tmp_path / "ck")
    make_fixture_dataset(root, n_train=4, n_val=0, n_test=0, duration_s=0.5, latent_hw=8)
    run_stage(C.apply_overrides(port_cfg(cfg), OVERRIDES), 1, full, data_root=root,
              max_steps=4, checkpoint_dir=ck, log_dir=str(tmp_path / "logs"), device="cpu")
    merged = ckpt.merge_stage_params(serving, ckpt.load_payload(ck, "stage1_final"), 1)
    pipe = AudioToImagePipeline(port_cfg(cfg), params=merged, device="cpu")
    key = "token_generator.output_proj.0.weight"
    assert not torch.equal(pipe.adapter.state_dict()[key], full["adapter"][key])  # trained
    img = pipe.generate(waveform=_wav(0), num_steps=2, seed=1, model_type="sonic")
    assert img.shape == (1, SIZE, SIZE, 3) and img.dtype == np.uint8 and img.std() > 0


# -- host-side loaders ---------------------------------------------------------

def _write_float_wav(path, x, sr):
    """A 32-bit IEEE-float mono WAV (format code 3)."""
    data = np.asarray(x, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, sr, sr * 4, 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + 16 + 8 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(data)))
        f.write(data)


def test_load_audio_matches_jax(tiny, tmp_path):
    _, _, jpipe, port = tiny
    t = np.arange(30_000) / 48_000
    tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    loud_tail = tone.copy()
    loud_tail[-100:] *= 1.9  # a crop would lose the peak: the float path
    cases = {
        "pcm16_48k_short": (tone[:9000], 48_000, "pcm16"),  # repeat-padded, stays int16
        "pcm16_48k_crop": (tone, 48_000, "pcm16"),
        "pcm16_loud_tail": (loud_tail, 48_000, "pcm16"),
        "pcm16_44k1": (tone, 44_100, "pcm16"),  # resampled: the float path
        "stereo": (np.stack([tone, 0.5 * tone]), 48_000, "pcm16"),
        "float32": (tone[:20_000] * 0.8, 48_000, "float"),
    }
    paths = {}
    for name, (x, sr, kind) in cases.items():
        paths[name] = str(tmp_path / f"{name}.wav")
        (write_wav if kind == "pcm16" else _write_float_wav)(paths[name], x, sr)
    # the fixture dataset's WAVs (PCM16 tones): at the CLAP rate, and resampled
    for sr, seconds in ((48_000, 10.0), (48_000, 0.3), (44_100, 1.0)):
        root = tmp_path / f"fixture_{sr}_{seconds}"
        make_fixture_dataset(str(root), n_train=2, n_val=0, n_test=0, duration_s=seconds,
                             sample_rate=sr, latent_hw=8)
        for wav in sorted((root / "audio").iterdir()):
            paths[f"fixture {sr} {seconds} s {wav.name}"] = str(wav)
    for name, path in paths.items():
        got, want = port.load_audio(path), jpipe.load_audio(path)
        assert got.dtype == want.dtype and got.shape == want.shape == (24_000,), name
        if got.dtype == np.int16:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:  # the same numpy steps; the resampler is a copy
            np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
    assert port.load_audio(paths["pcm16_48k_crop"]).dtype == np.int16
    assert port.load_audio(paths["pcm16_44k1"]).dtype == np.float32
    # FLAC (and a corrupt one) through the native loader, as JAX reads them
    from tests.flac_fixture import write_flac

    flac = str(tmp_path / "a.flac")
    write_flac(flac, (tone * 32767).astype(np.int16), 48_000, kind="lpc2")
    got, want = port.load_audio(flac), jpipe.load_audio(flac)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (24_000,)
    np.testing.assert_allclose(got, want, atol=1e-6)
    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"fLaC" + bytes(64))
    for pipe in (port, jpipe):
        with pytest.raises(ValueError):
            pipe.load_audio(str(bad))


def _arrays():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, size=(SIZE, SIZE, 3)).astype(np.uint8)
    return {
        "rgb_at_size": rgb,
        "rgba_at_size": rng.integers(0, 256, size=(SIZE, SIZE, 4)).astype(np.uint8),
        "grey_at_size": rgb[..., 0].copy(),
        "float_at_size": rng.uniform(-0.2, 1.2, size=(SIZE, SIZE, 3)).astype(np.float32),
        "bool_at_size": rgb[..., 1] > 127,
        "rgb_small": rgb[:32, :48].copy(),
        "float_small": np.full((32, 32, 3), 0.5, np.float32),
    }


@pytest.mark.parametrize("mask", [False, True], ids=["image", "mask"])
def test_load_init_image_matches_jax(tiny, mask):
    from PIL import Image

    _, _, jpipe, port = tiny
    for name, arr in _arrays().items():
        got, want = port.load_init_image(arr, mask=mask), jpipe.load_init_image(arr, mask=mask)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    buf = io.BytesIO()
    Image.fromarray(_arrays()["rgb_small"]).save(buf, format="PNG")
    buf.seek(0)
    got = port.load_init_image(buf, mask=mask)
    buf.seek(0)
    np.testing.assert_array_equal(got, jpipe.load_init_image(buf, mask=mask))


def test_load_init_image_imports_pil_only_when_needed(tiny, monkeypatch):
    port = tiny[3]
    monkeypatch.setitem(sys.modules, "PIL", None)  # an environment without Pillow
    arrays = _arrays()
    assert port.load_init_image(arrays["rgb_at_size"]).shape == (SIZE, SIZE, 3)
    assert port.load_init_image(arrays["rgba_at_size"], mask=True).shape == (SIZE, SIZE)
    with pytest.raises(ImportError, match="PIL"):
        port.load_init_image(arrays["rgb_small"])
