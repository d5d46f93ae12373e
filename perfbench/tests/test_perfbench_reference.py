"""The reference models take the program's weights by name: the same
state-dict names and shapes, tower by tower, at the configurations' full
size and at the tiny one; and a seed's weights are the same each time."""

from __future__ import annotations

import pytest
import torch

from perfbench.harness import common, weights
from perfbench.tests import tiny


def family():
    return common.family(common.cell(common.load_benchmark(), "serve-b1"))


def port_shapes(model: dict):
    from clap2diffusion_tpu_torch.core.config import Config, from_dict
    from clap2diffusion_tpu_torch.diffusion.pipeline import build_modules

    with torch.device("meta"):
        mods = build_modules(from_dict(Config, model))
    return {t: {k: tuple(v.shape) for k, v in mods[t].state_dict().items()}
            for t in family().SALT}


@pytest.mark.parametrize("size", ["full", "tiny"])
def test_reference_names_and_shapes_are_the_programs(size):
    model = (common.cell(common.load_benchmark(), "serve-b1")["config"]["model"]
             if size == "full" else tiny.tiny_model())
    fam = family()
    ref = weights.shapes(fam, common.namespace(model), tuple(fam.SALT))
    assert {t: {k: tuple(s) for k, s in sd.items()} for t, sd in ref.items()} == \
        port_shapes(model)


def test_a_seed_draws_the_same_weights_in_every_type():
    fam, ns = family(), common.namespace(tiny.tiny_model())
    a = weights.draw_weights(fam, ns, 2**31 + 99, ("unet",), torch.float32, "cpu")["unet"]
    b = weights.draw_weights(fam, ns, 2**31 + 99, ("unet",), torch.float32, "cpu")["unet"]
    c = weights.draw_weights(fam, ns, 2**31 + 100, ("unet",), torch.float32, "cpu")["unet"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert torch.equal(a["conv_in.bias"], torch.zeros_like(a["conv_in.bias"]))
