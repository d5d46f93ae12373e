"""Module parity of the PyTorch port against the JAX package, on the CPU.

Each test feeds the JAX module and its port the same weights (the JAX
params through ``clap2diffusion_tpu_torch.convert``) and the same inputs
(numpy, fixed seed), at the tiny geometry of
``tests/test_pipeline.py::tiny_config``, in fp32. Tolerances are stated per
test; they absorb fp32 summation-order differences between XLA:CPU and
PyTorch's CPU kernels, nothing more.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.diffusion.pipeline import init_params
from clap2diffusion_tpu_torch import convert
from clap2diffusion_tpu_torch.core import config as port_config
from tests.test_pipeline import tiny_config

torch.set_num_threads(2)

ATOL = 1e-4  # fp32 parity: XLA:CPU and torch sum in different orders
RTOL = 1e-4


def port_cfg(jax_cfg):
    """The same configuration, in the port's dataclasses."""
    return port_config.from_dict(port_config.Config, dataclasses.asdict(jax_cfg))


def to_torch(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def close(ours, ref, atol=ATOL, rtol=RTOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    params = jax.tree.map(np.asarray, init_params(cfg, seed=0))
    return cfg, port_cfg(cfg), params


def _unet_inputs(cfg, rng, b=2):
    u = cfg.diffusion.unet
    lat = cfg.diffusion.image_size // 8
    sample = rng.normal(size=(b, lat, lat, 4)).astype(np.float32)
    t = np.array([999, 321][:b], np.int32)
    ehs = rng.normal(size=(b, 7, u.cross_attention_dim)).astype(np.float32)
    audio = {lvl: rng.normal(size=(b, cfg.condition.num_tokens,
                                   u.cross_attention_dim)).astype(np.float32) * 3
             for lvl in ("early", "mid", "late")}
    return sample, t, ehs, audio


@pytest.mark.parametrize("mode", ["add", "concat"])
def test_unet_eps_matches_jax(tiny, mode):
    from clap2diffusion_tpu.models.unet import UNet2DCondition as JUNet
    from clap2diffusion_tpu_torch.models.unet import UNet2DCondition

    cfg, _, params = tiny
    ucfg = dataclasses.replace(cfg.diffusion.unet, injection_mode=mode)
    sample, t, ehs, audio = _unet_inputs(cfg, np.random.default_rng(1))
    jm = JUNet(cfg=ucfg)
    if mode == "add":
        p = params["unet"]
    else:
        p = jax.tree.map(np.asarray, jm.init(jax.random.key(3), sample, t, ehs, audio)["params"])
    ref = jm.apply({"params": p}, sample, t, ehs, audio)
    pu = load(UNet2DCondition(port_cfg(dataclasses.replace(
        cfg, diffusion=dataclasses.replace(cfg.diffusion, unet=ucfg))).diffusion.unet),
        convert.unet_from_flax(p))
    with torch.no_grad():
        ours = pu(to_torch(sample), torch.from_numpy(t), to_torch(ehs),
                  {k: to_torch(v) for k, v in audio.items()})
        no_audio = pu(to_torch(sample), torch.from_numpy(t), to_torch(ehs), None)
    close(ours, ref, atol=2e-4)
    close(no_audio, jm.apply({"params": p}, sample, t, ehs, None), atol=2e-4)


def test_ddim_sample_fixed_eps_matches_jax(tiny):
    from clap2diffusion_tpu.diffusion import ddim as jd
    from clap2diffusion_tpu_torch.diffusion import ddim as pd

    cfg, pcfg, _ = tiny
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    e = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    js = jd.NoiseSchedule.create(cfg.diffusion.scheduler)
    ps = pd.NoiseSchedule.create(pcfg.diffusion.scheduler)
    close(ps.alphas_cumprod, js.alphas_cumprod, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(pd.ddim_timesteps(50).numpy(), np.asarray(jd.ddim_timesteps(50)))
    # eps depends on the latents and t, so the loop's plumbing shows
    ref = jd.ddim_sample(lambda lat, t: lat * 0.1 + e * (t / 1000.0), js, x, 10)
    ours = pd.ddim_sample(lambda lat, t: lat * 0.1 + to_torch(e) * (t / 1000.0), ps,
                          to_torch(x), 10)
    close(ours, ref, atol=1e-5)
    t = np.array([10, 500], np.int32)
    close(ps.add_noise(to_torch(x).repeat(2, 1, 1, 1), to_torch(e).repeat(2, 1, 1, 1),
                       torch.from_numpy(t).long()),
          js.add_noise(np.repeat(x, 2, 0), np.repeat(e, 2, 0), t), atol=1e-6)


@pytest.mark.parametrize("rescale", [0.0, 0.7])
def test_cfg_eps_fn_matches_jax(rescale):
    from clap2diffusion_tpu.diffusion import ddim as jd
    from clap2diffusion_tpu_torch.diffusion import ddim as pd

    rng = np.random.default_rng(4)
    lat = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    cc, cu = (rng.normal(size=(2, 3, 5)).astype(np.float32) for _ in range(2))
    audio = {"mid": rng.normal(size=(2, 2, 5)).astype(np.float32)}
    w = rng.normal(size=(5,)).astype(np.float32)

    def unet(xp, w, x, t, ctx, a):  # a toy UNet that reads every input
        return x * xp.mean(ctx @ w) + xp.mean(a["mid"]) + t[:, None, None, None] / 1000.0

    jfn = jd.cfg_eps_fn(lambda *a: unet(jnp, w, *a), cc, cu, np.float32(7.5), audio, audio,
                        rescale)
    pfn = pd.cfg_eps_fn(lambda *a: unet(torch, to_torch(w), *a), to_torch(cc), to_torch(cu), 7.5,
                        {"mid": to_torch(audio["mid"])}, {"mid": to_torch(audio["mid"])},
                        rescale)
    close(pfn(to_torch(lat), 501), jfn(lat, 501), atol=1e-5)


def test_ddim_with_unet_matches_jax(tiny):
    from clap2diffusion_tpu.diffusion import ddim as jd
    from clap2diffusion_tpu.models.unet import UNet2DCondition as JUNet
    from clap2diffusion_tpu_torch.diffusion import ddim as pd
    from clap2diffusion_tpu_torch.models.unet import UNet2DCondition

    cfg, pcfg, params = tiny
    rng = np.random.default_rng(5)
    sample, _, ehs, audio = _unet_inputs(cfg, rng, b=1)
    unc = rng.normal(size=ehs.shape).astype(np.float32)
    jm = JUNet(cfg=cfg.diffusion.unet)
    jfn = jd.cfg_eps_fn(lambda *a: jm.apply({"params": params["unet"]}, *a), ehs, unc,
                        np.float32(7.5), audio, audio)
    ref = jd.ddim_sample(jfn, jd.NoiseSchedule.create(cfg.diffusion.scheduler), sample, 3)
    pu = load(UNet2DCondition(pcfg.diffusion.unet), convert.unet_from_flax(params["unet"]))
    pa = {k: to_torch(v) for k, v in audio.items()}
    pfn = pd.cfg_eps_fn(pu, to_torch(ehs), to_torch(unc), 7.5, pa, pa)
    with torch.no_grad():
        ours = pd.ddim_sample(pfn, pd.NoiseSchedule.create(pcfg.diffusion.scheduler),
                              to_torch(sample), 3)
    close(ours, ref, atol=5e-4)


def test_vae_decode_matches_jax(tiny):
    from clap2diffusion_tpu.models.vae import AutoencoderKL as JVAE
    from clap2diffusion_tpu_torch.models.vae import AutoencoderKL

    cfg, pcfg, params = tiny
    z = np.random.default_rng(6).normal(size=(2, 8, 8, 4)).astype(np.float32)
    ref = JVAE(cfg=cfg.diffusion.vae).apply({"params": params["vae"]}, z,
                                            method=JVAE.decode_latent)
    pv = load(AutoencoderKL(pcfg.diffusion.vae), convert.vae_from_flax(params["vae"]))
    with torch.no_grad():
        ours = pv.decode_latent(to_torch(z))
    assert ours.shape == (2, 64, 64, 3)
    close(ours, ref, atol=2e-4)


def test_clip_text_matches_jax(tiny):
    from clap2diffusion_tpu.models.clip_text import CLIPTextEncoder as JCLIP
    from clap2diffusion_tpu_torch.models.clip_text import CLIPTextEncoder

    cfg, pcfg, params = tiny
    ids = np.random.default_rng(7).integers(0, 300, size=(2, 7)).astype(np.int32)
    ref = JCLIP(cfg=cfg.diffusion.clip_text).apply({"params": params["clip_text"]}, ids)
    pc = load(CLIPTextEncoder(pcfg.diffusion.clip_text),
              convert.clip_text_from_flax(params["clip_text"]))
    with torch.no_grad():
        close(pc(torch.from_numpy(ids)), ref)


@pytest.mark.parametrize("text", ["golden rain", "", "A Dog, barking; at 3am!!", "x " * 90])
def test_tokenizer_ids_match_jax(text):
    from clap2diffusion_tpu.models.tokenizer import CLIPTokenizer as JTok
    from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer

    np.testing.assert_array_equal(CLIPTokenizer()(text), JTok()(text))


def test_hierarchical_encoder_matches_jax(tiny):
    from clap2diffusion_tpu.models.condition.hierarchical import (
        HierarchicalAudioEncoder as JHier,
    )
    from clap2diffusion_tpu_torch.models.condition.hierarchical import (
        HierarchicalAudioEncoder,
    )

    cfg, pcfg, params = tiny
    x = np.random.default_rng(8).normal(size=(3, cfg.condition.clap_dim)).astype(np.float32)
    ref77, ref = JHier(cfg=cfg.condition).apply({"params": params["hierarchical"]}, x, 0.7,
                                               return_all=True)
    ph = load(HierarchicalAudioEncoder(pcfg.condition),
              convert.hierarchical_from_flax(params["hierarchical"]))
    with torch.no_grad():
        ours77, ours = ph(to_torch(x), 0.7, return_all=True)
    close(ours77, ref77)
    for key in ("tokens_10", "assignments", "hierarchy_weights"):
        close(ours[key], ref[key])
    for lvl in ("early", "mid", "late"):
        close(ours["routed"][lvl], ref["routed"][lvl])


def test_log_mel_matches_jax():
    from clap2diffusion_tpu.core.config import AudioFrontendConfig as JFront
    from clap2diffusion_tpu.models.clap.frontend import log_mel_spectrogram as jmel
    from clap2diffusion_tpu_torch.core.config import AudioFrontendConfig
    from clap2diffusion_tpu_torch.models.clap.frontend import log_mel_spectrogram

    wav = (np.random.default_rng(9).normal(size=(2, 48_000)) * 0.1).astype(np.float32)
    ref = np.asarray(jmel(wav, JFront(duration_s=1.0)))
    ours = log_mel_spectrogram(to_torch(wav), AudioFrontendConfig(duration_s=1.0))
    assert ours.shape == ref.shape == (2, 101, 64)
    # dB of fp32 power spectra: 1e-3 dB is far below any audible or
    # embedding-visible change
    close(ours, ref, atol=2e-3, rtol=1e-4)


def test_prepare_waveform_matches_jax():
    from clap2diffusion_tpu.models.clap.frontend import prepare_waveform as jprep
    from clap2diffusion_tpu_torch.models.clap.frontend import prepare_waveform

    from clap2diffusion_tpu.core.config import AudioFrontendConfig as JFront
    from clap2diffusion_tpu_torch.core.config import AudioFrontendConfig

    x = np.random.default_rng(10).normal(size=(2, 3_000)).astype(np.float32)
    for sr in (48_000, 44_100):
        np.testing.assert_allclose(
            prepare_waveform(x, sr, AudioFrontendConfig(duration_s=0.1)),
            jprep(x, sr, JFront(duration_s=0.1)), atol=1e-6)


def test_clap_audio_tower_matches_jax(tiny):
    from clap2diffusion_tpu.models.clap.htsat import ClapAudioTower as JTower
    from clap2diffusion_tpu_torch.models.clap.htsat import ClapAudioTower

    cfg, pcfg, params = tiny
    mel = np.random.default_rng(11).normal(size=(2, 51, 16)).astype(np.float32) * 10
    p = params["clap_audio"]
    # non-trivial batchnorm statistics and relative-position biases
    p = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.3 * np.random.default_rng(len(str(path))).normal(size=v.shape)
        .astype(np.float32) if any("bn_" in str(k) or "relative" in str(k) for k in path)
        else v, p)
    p["encoder"]["bn_var"] = np.abs(p["encoder"]["bn_var"]) + 0.5
    ref = JTower(cfg=cfg.clap.audio).apply({"params": p}, mel)
    pt = load(ClapAudioTower(pcfg.clap.audio), convert.clap_audio_from_flax(p))
    with torch.no_grad():
        close(pt(to_torch(mel)), ref)


def test_config_matches_jax():
    from clap2diffusion_tpu.core.config import load_config as jload

    jcfg = jload("configs/default.yaml")
    pcfg = port_config.load_config("configs/default.yaml")
    assert pcfg == port_cfg(jcfg)
    assert port_config.Config() == port_cfg(type(jcfg)())
    assert port_cfg(tiny_config()).diffusion.unet.block_out_channels == (16, 32, 32, 32)
