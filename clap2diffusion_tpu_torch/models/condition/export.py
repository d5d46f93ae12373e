"""The port's conditioning weights -> the reference's state dicts
(counterpart of ``clap2diffusion_tpu/models/condition/export.py``).

The inverse of ``models/condition/convert.py``: the port's towers already
carry the reference's names, so the hierarchical encoder, the adapter and
the legacy V4 stack export key for key, as fp32 CPU tensors; the UNet's
per-level injection branches become the reference's ``AudioAttnProcessor``
state dicts under ``{early,mid,late}.audio_proj.{0,3}`` and ``alpha``.
``apps/main.py export`` writes the result as ``.pth`` or ``.safetensors``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

LEVELS = ("early", "mid", "late")


def _fp32(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in sd.items()}


def export_hierarchical_encoder(sd: Mapping) -> Dict[str, torch.Tensor]:
    """``hierarchical`` tower -> reference ImprovedHierarchicalAudioEncoder
    state dict."""
    return _fp32(sd)


def export_audio_adapter(sd: Mapping) -> Dict[str, torch.Tensor]:
    """``adapter`` tower -> reference AudioAdapter state dict."""
    return _fp32(sd)


def export_legacy_v4(sd: Mapping) -> Dict[str, torch.Tensor]:
    """``HierarchicalAudioV4`` state dict -> the reference's (rigid) one."""
    return _fp32(sd)


def export_injection_processors(unet_sd: Mapping) -> Dict[str, torch.Tensor]:
    """The UNet's ``audio_inject.<level>.*`` branches -> the reference's
    per-level ``AudioAttnProcessor`` state dicts (``audio_proj`` = Linear,
    GELU, Dropout, Linear; ``alpha`` in the 'add' mode only)."""
    out = {}
    for lvl in LEVELS:
        pre = f"audio_inject.{lvl}."
        for leaf in ("audio_proj.0.weight", "audio_proj.0.bias",
                     "audio_proj.3.weight", "audio_proj.3.bias", "alpha"):
            if pre + leaf in unet_sd:
                out[f"{lvl}.{leaf}"] = unet_sd[pre + leaf]
    return _fp32(out)
