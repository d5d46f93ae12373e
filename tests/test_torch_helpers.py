"""The port's small public helpers against the JAX package's, on the CPU:
``clap2diffusion_tpu_torch.pipeline()``, ``models.clap.audio_text_similarity``
and ``models.clap.convert.convert_clap``. fp32 at
``tests/test_pipeline.py::tiny_config``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clap2diffusion_tpu
import clap2diffusion_tpu_torch
from clap2diffusion_tpu.diffusion.pipeline import init_params as jax_init_params
from clap2diffusion_tpu.models import clap as jclap
from clap2diffusion_tpu.models.clap import convert as jclap_convert
from clap2diffusion_tpu_torch import convert as bridge
from clap2diffusion_tpu_torch.core.config import Config
from clap2diffusion_tpu_torch.diffusion import pipeline as P
from clap2diffusion_tpu_torch.models import clap as pclap
from clap2diffusion_tpu_torch.models.clap.convert import convert_clap
from tests.test_pipeline import tiny_config
from tests.test_torch_eval import clap_model_sd
from tests.test_torch_models import close, port_cfg
from tests.test_torch_weights_io import _clap_sd

torch.set_num_threads(2)


def test_pipeline_helper_matches_jax():
    cfg = tiny_config()
    jparams = jax.tree.map(np.asarray, jax_init_params(cfg, seed=0))
    jpipe = clap2diffusion_tpu.pipeline(cfg, params=jparams)
    pipe = clap2diffusion_tpu_torch.pipeline(port_cfg(cfg), params=bridge.from_flax(jparams),
                                             device="cpu")
    assert isinstance(pipe, P.AudioToImagePipeline)
    want = bridge.from_flax(jax.tree.map(np.asarray, jpipe.params))
    for tower, sd in want.items():
        for k, t in sd.items():
            assert torch.equal(pipe.params[tower][k], t), (tower, k)
    wav = (np.random.default_rng(0).normal(size=(1, cfg.clap.frontend.num_samples)) * 0.1
           ).astype(np.float32)
    close(pipe.encode_audio(wav), np.asarray(jpipe.encode_audio(jnp.asarray(wav))))


def test_pipeline_helper_defaults(monkeypatch):
    seen = {}

    class Stub:
        def __init__(self, cfg, params=None, seed=0, device=None):
            seen.update(cfg=cfg, params=params, seed=seed, device=device)

    monkeypatch.setattr(P, "AudioToImagePipeline", Stub)
    assert isinstance(clap2diffusion_tpu_torch.pipeline(seed=3), Stub)
    assert seen == {"cfg": Config(), "params": None, "seed": 3, "device": None}
    monkeypatch.undo()
    # the default device is CUDA, which this machine lacks: no fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clap2diffusion_tpu_torch.pipeline(port_cfg(tiny_config()))


@pytest.mark.parametrize("logit_scale", [1.0, 14.3])
def test_audio_text_similarity_matches_jax(logit_scale):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(3, 32)).astype(np.float32)
    t = rng.normal(size=(5, 32)).astype(np.float32)
    a[1] = 0.0  # a silent clip: the 1e-8 keeps it finite
    ref = np.asarray(jclap.audio_text_similarity(jnp.asarray(a), jnp.asarray(t), logit_scale))
    ours = pclap.audio_text_similarity(torch.from_numpy(a), torch.from_numpy(t), logit_scale)
    assert ours.shape == (3, 5) and torch.isfinite(ours).all()
    close(ours, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("scales", [True, False])
def test_convert_clap_matches_jax(monkeypatch, scales):
    pcfg = port_cfg(tiny_config())
    jcfg = tiny_config()
    sd = {**_clap_sd(pcfg), **clap_model_sd(pcfg)}
    sd["logit_scale_t"] = torch.tensor(3.5)
    if not scales:
        del sd["logit_scale_a"], sd["logit_scale_t"]
    # the JAX convert_clap reads the default geometry: give it the tiny one
    monkeypatch.setattr(jclap_convert, "convert_clap_audio", functools.partial(
        jclap_convert.convert_clap_audio, cfg=jcfg.clap.audio))
    monkeypatch.setattr(jclap_convert, "convert_clap_text", functools.partial(
        jclap_convert.convert_clap_text, cfg=jcfg.clap.text))
    jaudio, jtext, jextras = jclap_convert.convert_clap(sd)
    audio, text, extras = convert_clap(sd, pcfg.clap.audio, pcfg.clap.text)
    assert extras == jextras == ({"logit_scale_a": 2.0, "logit_scale_t": 3.5} if scales else {})
    for got, want in ((audio, bridge.clap_audio_from_flax(jaudio)),
                      (text, bridge.clap_text_from_flax(jtext))):
        assert sorted(got) == sorted(want)
        for k, t in want.items():
            assert torch.equal(got[k].float(), t), k
