"""The port's conditioning towers against the reference's own outputs.

``tests/goldens/condition_goldens.npz`` holds what the reference's torch
``HierarchicalAudioEncoder`` and ``AudioAdapter`` computed on fixed inputs,
with state dicts that ``golden_utils.synth_state_dict`` rebuilds from the
committed shape manifest (``tests/test_checkpoint_ingestion.py`` holds the
JAX package to the same goldens). The port keeps the reference's
state-dict names, so the synthetic dicts load strictly into its modules,
with one exception: the reference's decomposer keeps ``level_prior`` and
``temperature`` as buffers, and the port takes the prior from the config
and the temperature as an argument, so those two entries are dropped.
No JAX here: this runs in seconds.
"""

import numpy as np
import pytest
import torch

from clap2diffusion_tpu_torch.core.config import ConditionConfig
from clap2diffusion_tpu_torch.models.condition.adapter import AudioAdapter
from clap2diffusion_tpu_torch.models.condition.hierarchical import HierarchicalAudioEncoder
from tests.golden_utils import GOLDEN_DIR, load_shapes, synth_state_dict

ATOL = 3e-4  # tests/test_checkpoint_ingestion.py's bound
# reference buffers the port does not hold (see the module doc)
DROPPED = ("decomposer.level_prior", "decomposer.temperature")


@pytest.fixture(scope="module")
def goldens():
    return dict(np.load(f"{GOLDEN_DIR}/condition_goldens.npz"))


def _load(module, tag, shapes):
    sd = {k: torch.from_numpy(v) for k, v in synth_state_dict(tag, shapes).items()
          if k not in DROPPED}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def test_hierarchical_encoder_matches_reference_goldens(goldens):
    shapes = load_shapes("condition_shapes.json")["hierarchical"]
    assert set(DROPPED) <= set(shapes)
    hier = _load(HierarchicalAudioEncoder(ConditionConfig()), "hier", shapes)
    with torch.no_grad():
        t77, info = hier(torch.from_numpy(goldens["x"]), float(goldens["temperature"]),
                         return_all=True)
    np.testing.assert_allclose(t77.numpy(), goldens["tokens77"], atol=ATOL)
    np.testing.assert_allclose(info["assignments"].numpy(), goldens["assignments"], atol=ATOL)


def test_audio_adapter_matches_reference_goldens(goldens):
    shapes = load_shapes("condition_shapes.json")["adapter"]
    adapter = _load(AudioAdapter(ConditionConfig()), "adapter", shapes)
    with torch.no_grad():
        t16 = adapter(torch.from_numpy(goldens["x"]))
    np.testing.assert_allclose(t16.numpy(), goldens["tokens16"], atol=ATOL)
