"""The reference's conditioning checkpoints -> the port's state dicts
(counterpart of ``clap2diffusion_tpu/models/condition/convert.py``).

Reads the published ``hierarchical_v4_final.pth`` /
``audio_projector_stage2.pth`` and any state dict of the reference's
``ImprovedHierarchicalAudioEncoder``, ``AudioAdapter`` or legacy
``HierarchicalAudioV4``. The port's modules carry the reference's names
(``nn.MultiheadAttention``'s row-stacked ``in_proj`` included), so each
converter picks the keys its tower has, in fp32, and checks their shapes
against the tower built from the config (``models/convert.py::select``).
Other keys are ignored, as in the JAX converters: among them the
reference's ``decomposer.level_prior`` and ``decomposer.temperature``
buffers, which the port takes from the config and the step.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from clap2diffusion_tpu_torch.core.config import ConditionConfig
from clap2diffusion_tpu_torch.models.condition.adapter import AudioAdapter
from clap2diffusion_tpu_torch.models.condition.hierarchical import (
    HierarchicalAudioEncoder,
    HierarchicalAudioV4,
)
from clap2diffusion_tpu_torch.models.convert import select, template

ADAPTIVE_KEY = "adaptive_weights.weight_network.0.weight"


def unwrap(obj, section: str):
    """The model's state dict inside a reference checkpoint, which nests it
    under ``section`` (``hierarchical_state_dict``, ``adapter_state_dict``),
    ``model_state_dict`` or ``state_dict``; a flat dict is returned as is."""
    for key in (section, "model_state_dict", "state_dict"):
        if isinstance(obj, dict) and key in obj:
            return obj[key]
    return obj


def convert_hierarchical_encoder(sd: Mapping, cfg: ConditionConfig | None = None
                                 ) -> Dict[str, torch.Tensor]:
    """Reference ImprovedHierarchicalAudioEncoder state dict -> the
    ``hierarchical`` tower's; the adaptive-weights branch where the dict has
    one."""
    shapes = template(HierarchicalAudioEncoder, cfg or ConditionConfig(),
                      use_adaptive_weights=ADAPTIVE_KEY in sd)
    return select(sd, shapes, what="hierarchical encoder")


def convert_audio_adapter(sd: Mapping, cfg: ConditionConfig | None = None
                          ) -> Dict[str, torch.Tensor]:
    """Reference AudioAdapter state dict -> the ``adapter`` tower's."""
    return select(sd, template(AudioAdapter, cfg or ConditionConfig()), what="audio adapter")


def convert_legacy_v4(sd: Mapping, cfg: ConditionConfig | None = None
                      ) -> Dict[str, torch.Tensor]:
    """Reference HierarchicalAudioV4 (rigid) state dict -> the state dict of
    ``HierarchicalAudioV4``."""
    return select(sd, template(HierarchicalAudioV4, cfg or ConditionConfig()),
                  what="legacy HierarchicalAudioV4")
