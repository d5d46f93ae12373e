"""Full-geometry parity of the port against the JAX package: ``Config()``
widths, fp32, on the CPU, JAX-initialised weights through
``convert.*_from_flax``. Each test is ``slow`` (the tier-1 run skips them;
``python -m pytest tests/test_torch_fullsize.py -m slow`` runs them, with
about 10 GB of host memory for the UNet's two copies).

- HTSAT on [1, 1001, 64] log-mels, with shifted windows (the tiny config's
  depths of 1 never shift), perturbed BatchNorm statistics and
  relative-position tables;
- the SD v1.5 UNet at 16x16 latents, batch 2, a 77-token context and
  routed audio; the same UNet under ``C2D_INT8=1``;
- VAE decode at 8x8 latents;
- CLIP text at 77 tokens;
- the hierarchical encoder.

Tolerance: max|err| / max|ref| <= 2e-5 for the fp32 paths; the errors
measured on this kind of CPU at these shapes were 6.7e-7 (HTSAT), 5.1e-6
(UNet), 2.4e-6 (VAE), 1.5e-6 (CLIP text) and 1.2e-6 (hierarchical), from
summation order alone. The int8 UNet against JAX's int8 UNet: a cosine
above 0.99 (JAX's own drift criterion, ``tests/test_quant.py``) and
max|err| <= 0.1 of max|ref|. The int8 path amplifies fp32 rounding: a value
that ~1e-6 of upstream difference moves across a rounding boundary of an
activation quantiser moves by one quantum (1/127 of the tensor's absmax),
and the next sites carry it on. JAX's own int8 UNet moves by 1.0e-2 of
max|ref| under a 1e-6 relative perturbation of its input (the tiny config
at 16x16 latents, where the port is 4.3e-2 from it, cosine 0.99905), so
no tighter bound holds at full width; the int8 functions themselves equal
JAX's at tolerance 0 (``tests/test_torch_quant.py``).
"""

import jax
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.core.config import Config
from clap2diffusion_tpu_torch import convert
from tests.test_torch_models import load, port_cfg, to_torch

pytestmark = pytest.mark.slow

torch.set_num_threads(4)

REL_TOL = 2e-5
INT8_REL_TOL = 0.1


def geometry() -> Config:
    return Config()


def _rel(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _init(module, *args, **kw):
    return jax.tree.map(np.asarray, module.init(jax.random.key(0), *args, **kw)["params"])


def test_htsat_shifted_windows_full_width():
    from clap2diffusion_tpu.models.clap.htsat import ClapAudioTower as JTower
    from clap2diffusion_tpu_torch.models.clap.htsat import ClapAudioTower

    cfg = geometry()
    mel = np.random.default_rng(0).normal(size=(1, 1001, cfg.clap.audio.num_mel_bins)
                                          ).astype(np.float32) * 10
    jm = JTower(cfg=cfg.clap.audio)
    p = _init(jm, mel)
    p = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.3 * np.random.default_rng(len(str(path))).normal(size=v.shape)
        .astype(np.float32) if any("bn_" in str(k) or "relative" in str(k) for k in path)
        else v, p)
    p["encoder"]["bn_var"] = np.abs(p["encoder"]["bn_var"]) + 0.5
    ref = jm.apply({"params": p}, mel)
    pt = load(ClapAudioTower(port_cfg(cfg).clap.audio), convert.clap_audio_from_flax(p))
    with torch.no_grad():
        assert _rel(pt(to_torch(mel)), ref) <= REL_TOL


def _unet_case(cfg):
    from clap2diffusion_tpu.models.unet import UNet2DCondition as JUNet
    from clap2diffusion_tpu_torch.models.unet import UNet2DCondition

    rng = np.random.default_rng(1)
    u = cfg.diffusion.unet
    sample = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    t = np.array([999, 321], np.int32)
    ehs = rng.normal(size=(2, 77, u.cross_attention_dim)).astype(np.float32)
    audio = {lvl: rng.normal(size=(2, cfg.condition.num_tokens, u.cross_attention_dim))
             .astype(np.float32) for lvl in ("early", "mid", "late")}
    jm = JUNet(cfg=u)
    p = _init(jm, sample, t, ehs, audio)
    pu = load(UNet2DCondition(port_cfg(cfg).diffusion.unet), convert.unet_from_flax(p))

    def both():
        ref = np.asarray(jm.apply({"params": p}, sample, t, ehs, audio))
        with torch.no_grad():
            ours = pu(to_torch(sample), torch.from_numpy(t), to_torch(ehs),
                      {k: to_torch(v) for k, v in audio.items()}).numpy()
        return ours, ref

    return both


def test_unet_full_width_16x16():
    ours, ref = _unet_case(geometry())()
    assert _rel(ours, ref) <= REL_TOL


def test_int8_unet_full_width_16x16(monkeypatch):
    both = _unet_case(geometry())
    monkeypatch.setenv("C2D_INT8", "1")
    ours, ref = both()
    assert _rel(ours, ref) <= INT8_REL_TOL
    a, b = ours.ravel().astype(np.float64), ref.ravel().astype(np.float64)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99


def test_vae_decode_full_width_8x8():
    from clap2diffusion_tpu.models.vae import AutoencoderKL as JVAE
    from clap2diffusion_tpu_torch.models.vae import AutoencoderKL

    cfg = geometry()
    z = np.random.default_rng(2).normal(size=(1, 8, 8, 4)).astype(np.float32)
    jm = JVAE(cfg=cfg.diffusion.vae)
    # the whole VAE, as the JAX init_params draws it (encode and decode)
    p = _init(jm, np.ones((1, 64, 64, 3), np.float32), jax.random.key(0))
    ref = jm.apply({"params": p}, z, method=JVAE.decode_latent)
    pv = load(AutoencoderKL(port_cfg(cfg).diffusion.vae), convert.vae_from_flax(p))
    with torch.no_grad():
        assert _rel(pv.decode_latent(to_torch(z)), ref) <= REL_TOL


def test_clip_text_full_width_77_tokens():
    from clap2diffusion_tpu.models.clip_text import CLIPTextEncoder as JCLIP
    from clap2diffusion_tpu_torch.models.clip_text import CLIPTextEncoder

    cfg = geometry()
    c = cfg.diffusion.clip_text
    ids = np.random.default_rng(3).integers(0, c.vocab_size, size=(2, c.max_length)
                                            ).astype(np.int32)
    jm = JCLIP(cfg=c)
    p = _init(jm, ids)
    pc = load(CLIPTextEncoder(port_cfg(cfg).diffusion.clip_text), convert.clip_text_from_flax(p))
    with torch.no_grad():
        assert _rel(pc(torch.from_numpy(ids)), jm.apply({"params": p}, ids)) <= REL_TOL


def test_hierarchical_encoder_full_width():
    from clap2diffusion_tpu.models.condition.hierarchical import (
        HierarchicalAudioEncoder as JHier,
    )
    from clap2diffusion_tpu_torch.models.condition.hierarchical import (
        HierarchicalAudioEncoder,
    )

    cfg = geometry()
    x = np.random.default_rng(4).normal(size=(3, cfg.condition.clap_dim)).astype(np.float32)
    jm = JHier(cfg=cfg.condition)
    p = _init(jm, x, 0.7)
    ref77, ref = jm.apply({"params": p}, x, 0.7, return_all=True)
    ph = load(HierarchicalAudioEncoder(port_cfg(cfg).condition), convert.hierarchical_from_flax(p))
    with torch.no_grad():
        ours77, ours = ph(to_torch(x), 0.7, return_all=True)
    assert _rel(ours77, ref77) <= REL_TOL
    for lvl in ("early", "mid", "late"):
        assert _rel(ours["routed"][lvl], ref["routed"][lvl]) <= REL_TOL
