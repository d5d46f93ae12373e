"""The port's ``tools/eval_memory.py`` on the CPU: it counts the bytes it
can without running a program (parameters, buffers, inputs; no peaks), and
each metric tower's parameter bytes equal those of the JAX tool's
``jax.eval_shape`` of the same module's ``init`` (no compile)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clap2diffusion_tpu.core.config import Config as JConfig
from clap2diffusion_tpu_torch.tools import eval_memory


@pytest.fixture(scope="module")
def rows():
    return {r["program"]: r for r in eval_memory.run(device="cpu")}


def jax_param_bytes(name: str) -> int:
    """Bytes of the ``params`` collection of the JAX tool's module, from
    avals only (batch 1: a parameter's shape does not depend on it)."""
    from clap2diffusion_tpu.models.clap.frontend import log_mel_spectrogram
    from clap2diffusion_tpu.models.clap.htsat import ClapAudioTower
    from clap2diffusion_tpu.models.clap.text import ClapTextTower
    from clap2diffusion_tpu.models.clip_vision import CLIPVisionEncoder
    from clap2diffusion_tpu.models.inception_v3 import InceptionV3

    cfg, sds = JConfig(), jax.ShapeDtypeStruct
    key = jax.random.key(0)
    if name == "inception_v3":
        module, args = InceptionV3(), (sds((1, 299, 299, 3), jnp.float32),)
    elif name == "clip_vision":
        module, args = (CLIPVisionEncoder(cfg=cfg.diffusion.clip_vision),
                        (sds((1, 224, 224, 3), jnp.float32),))
    elif name == "clap_audio":
        mel = jax.eval_shape(lambda w: log_mel_spectrogram(w, cfg.clap.frontend),
                             sds((1, 480_000), jnp.float32))
        module, args = ClapAudioTower(cfg=cfg.clap.audio), (mel,)
    else:
        ids = sds((1, 77), jnp.int32)
        module, args = ClapTextTower(cfg=cfg.clap.text), (ids, ids)
    params = jax.eval_shape(lambda k, *a: module.init(k, *a)["params"], key, *args)
    return sum(int(np.prod(p.shape)) * p.dtype.itemsize
               for p in jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("name", ["inception_v3", "clip_vision", "clap_audio", "clap_text"])
def test_tower_param_bytes_equal_jax(rows, name):
    assert rows[name]["param_bytes"] == jax_param_bytes(name)


def test_cpu_rows_count_only_what_needs_no_run(rows):
    assert list(rows) == ["inception_v3", "clip_vision", "clap_audio", "clap_text", "request"]
    shapes = {"inception_v3": [16, 299, 299, 3], "clip_vision": [16, 224, 224, 3],
              "clap_audio": [16, 480_000], "clap_text": [16, 77]}
    for name, shape in shapes.items():
        r = rows[name]
        assert r["input_shape"] == shape and r["dtype"] == "float32"
        assert r["input_bytes"] == int(np.prod(shape)) * 4  # fp32 pixels and samples, int32 ids
    for r in rows.values():
        assert r["peak_bytes"] is None and r["resident_bytes"] is None
        assert r["card"] == "cpu" and r["device"] == "cpu" and r["param_bytes"] > 0
    req = rows["request"]
    # the JAX bench's int16 waveform of 10 s and two [1, 77] prompts of int32 ids
    assert req["input_bytes"] == 480_000 * 2 + 2 * 77 * 4 and req["dtype"] == "bfloat16"
    # ~1.07e9 parameters, bf16 but for the fp32 CLAP audio and conditioning towers
    assert 2.0e9 < req["param_bytes"] < 2.5e9
