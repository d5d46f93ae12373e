"""The port end to end, its weight bridge, and its import and device rules.

- The frozen tiny image of ``tests/test_image_golden.py`` rebuilt by the
  port from the same JAX weights (through ``convert.from_flax``) and the
  same initial latents (the JAX threefry draw), held to that test's bounds.
- Weight round trip: the JAX package's torch converters, applied to the
  port's ``state_dict()`` (the VAE's encoder and the audio adapter
  included), give back the JAX tree leaf for leaf.
- The port and ``chip_smoke.py`` import no jax, flax or clap2diffusion_tpu.
- Entry points run on CUDA unless the caller asks for the CPU.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from clap2diffusion_tpu.diffusion.pipeline import init_params
from clap2diffusion_tpu_torch import convert
from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline, RequestDraws
from tests.test_image_golden import GOLDEN_PATH
from tests.test_pipeline import tiny_config
from tests.test_torch_models import port_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "clap2diffusion_tpu_torch")


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    params = jax.tree.map(np.asarray, init_params(cfg, seed=0))
    return cfg, params


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if hasattr(v, "items") else {p: np.asarray(v)})
    return out


def _same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class _FedLatents(RequestDraws):
    """The port's draws, with the initial latents given."""

    def __init__(self, latents):
        super().__init__("cpu", 0)
        self.fed = latents

    def latents(self, shape):
        assert tuple(shape) == tuple(self.fed.shape)
        return self.fed


def test_golden_image_through_the_port(tiny, monkeypatch):
    from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer

    cfg, params = tiny
    pipe = AudioToImagePipeline(port_cfg(cfg), params=convert.from_flax(params), device="cpu")
    tok = CLIPTokenizer(max_length=cfg.diffusion.clip_text.max_length)
    wav = (np.sin(np.linspace(0, 440 * np.pi, 24_000)) * 0.3
           + np.cos(np.linspace(0, 97 * np.pi, 24_000)) * 0.1).astype(np.float32)
    # the JAX program's initial latents (threefry), which torch cannot draw
    latents = torch.from_numpy(np.array(jax.random.normal(jax.random.key(11), (1, 8, 8, 4))))
    monkeypatch.setattr(pipe, "draws", lambda seed, seeds=None: _FedLatents(latents))
    img = pipe.generate(wav, tok("golden rain"), tok(""), num_steps=3, guidance_scale=7.5,
                        norm_target=60.0, temperature=0.5, model_type="hierarchical")
    golden = np.load(GOLDEN_PATH)["image"]
    assert img.shape == golden.shape == (1, 64, 64, 3) and img.dtype == np.uint8
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    # the golden test's own bounds (tests/test_image_golden.py)
    assert float(diff.mean()) < 0.5 and float((diff > 2).mean()) < 0.01, (
        f"mean|d|={diff.mean():.3f}, >2-count pixels={(diff > 2).mean():.2%}")


def test_generate_public_entry_on_cpu(tiny):
    cfg, params = tiny
    pipe = AudioToImagePipeline(port_cfg(cfg), params=convert.from_flax(params), device="cpu")
    wav = (np.random.default_rng(0).normal(size=24_000) * 3000).astype(np.int16)
    a = pipe.generate(waveform=wav, num_steps=2, seed=3)
    b = pipe.generate(waveform=wav, num_steps=2, seed=3)
    c = pipe.generate(waveform=None, num_steps=2, seed=4, model_type="baseline", batch=2)
    assert a.shape == (1, 64, 64, 3) and a.dtype == np.uint8 and a.std() > 0
    np.testing.assert_array_equal(a, b)  # seed -> noise is deterministic
    assert c.shape == (2, 64, 64, 3)
    with pytest.raises(ValueError, match="unknown model_type"):
        pipe.generate(waveform=wav, num_steps=2, model_type="sonicdiffusion")


def test_random_init_is_seeded():
    cfg = port_cfg(tiny_config())
    a = AudioToImagePipeline(cfg, seed=1, device="cpu")
    b = AudioToImagePipeline(cfg, seed=1, device="cpu")
    c = AudioToImagePipeline(cfg, seed=2, device="cpu")
    for name, t in a.unet.state_dict().items():
        torch.testing.assert_close(t, b.unet.state_dict()[name], rtol=0, atol=0)
    w = "down_blocks.0.resnets.0.conv1.weight"
    assert not torch.equal(a.unet.state_dict()[w], c.unet.state_dict()[w])


def test_weight_round_trip_through_jax_converters(tiny):
    from clap2diffusion_tpu.models.clap.convert import convert_clap_audio
    from clap2diffusion_tpu.models.condition.convert import (
        convert_audio_adapter,
        convert_hierarchical_encoder,
    )
    from clap2diffusion_tpu.models.condition.export import export_injection_processors
    from clap2diffusion_tpu.models.convert import (
        convert_clip_text,
        convert_sd_unet,
        convert_sd_vae,
    )

    cfg, params = tiny
    pipe = AudioToImagePipeline(port_cfg(cfg), params=convert.from_flax(params), device="cpu")

    def sd(module):
        return {k: v.numpy() for k, v in module.state_dict().items()}

    unet_sd = sd(pipe.unet)
    unet_ref = {k: v for k, v in params["unet"].items() if not k.startswith("audio_inject_")}
    _same_tree(convert_sd_unet(unet_sd, cfg.diffusion.unet), unet_ref)
    # injection branches: mapped by hand, checked against the JAX exporter
    inject = {k[len("audio_inject."):]: v for k, v in unet_sd.items()
              if k.startswith("audio_inject.")}
    exported = export_injection_processors(params["unet"])
    assert sorted(inject) == sorted(exported)
    for k in exported:
        np.testing.assert_array_equal(inject[k], exported[k])

    # the whole VAE, its encoder and quant_conv included
    _same_tree(convert_sd_vae(sd(pipe.vae), cfg.diffusion.vae), params["vae"])
    _same_tree(convert_audio_adapter(sd(pipe.adapter), cfg.condition.adapter_self_attn_layers),
               params["adapter"])
    _same_tree(convert_clip_text(sd(pipe.clip_text), cfg.diffusion.clip_text),
               params["clip_text"])
    _same_tree(convert_clap_audio(sd(pipe.clap_audio), cfg.clap.audio), params["clap_audio"])
    _same_tree(convert_hierarchical_encoder(sd(pipe.hierarchical),
                                            cfg.condition.projector_layers),
               params["hierarchical"])


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import clap2diffusion_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'clap2diffusion_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'clap2diffusion_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('clap2diffusion_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    # lazy imports inside functions too
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|clap2diffusion_tpu)(\.|\s|$)",
                     re.M)
    for path in _port_sources():
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from clap2diffusion_tpu_torch.core.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AudioToImagePipeline(port_cfg(tiny_config()))
    assert resolve_device("cpu") == torch.device("cpu")
