"""Published SD v1.5 weights -> the port's state dicts (counterpart of
``clap2diffusion_tpu/models/convert.py``).

Consumes diffusers-format state dicts (``unet/diffusion_pytorch_model.*``,
``vae/diffusion_pytorch_model.*``) and the transformers CLIP text model
(``text_encoder/model.*``, with or without the ``text_model.`` prefix).
The port's modules already carry the upstream names, so a converter picks
the keys its tower has, in fp32 (as the JAX converters do), and checks
their shapes against the tower built from the config: a missing key or a
wrong shape raises, naming the key. Every other key of the dict is
ignored, as the JAX converters ignore it (``position_ids``, diffusers keys
the UNet does not use, ...). The UNet's audio-injection branches have no
diffusers name and are left out; the caller keeps its own
(``tools/convert_checkpoints.py`` keeps the random ones).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from clap2diffusion_tpu_torch.core.config import CLIPTextConfig, UNetConfig, VAEConfig
from clap2diffusion_tpu_torch.models.clip_text import CLIPTextEncoder
from clap2diffusion_tpu_torch.models.unet import UNet2DCondition
from clap2diffusion_tpu_torch.models.vae import AutoencoderKL


def template(module_cls, *args, **kw) -> Dict[str, torch.Size]:
    """{name: shape} of a module's state dict, built on the meta device."""
    with torch.device("meta"):
        m: nn.Module = module_cls(*args, **kw)
    return {k: v.shape for k, v in m.state_dict().items()}


def select(sd: Mapping, shapes: Mapping[str, torch.Size], prefix: str = "",
           what: str = "state dict") -> Dict[str, torch.Tensor]:
    """``sd[prefix + name]`` (a tensor or an array) for every name of
    ``shapes``, as an fp32 tensor, with its shape checked; other keys of
    ``sd`` are ignored."""
    out = {}
    for name, shape in shapes.items():
        key = prefix + name
        if key not in sd:
            raise KeyError(f"{what}: missing key {key!r}")
        t = torch.as_tensor(sd[key]).detach().to("cpu", torch.float32)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {key!r} has shape {tuple(t.shape)}, the config "
                             f"wants {tuple(shape)}")
        out[name] = t
    return out


def convert_sd_unet(sd: Mapping, cfg: UNetConfig | None = None) -> Dict[str, torch.Tensor]:
    """diffusers UNet2DConditionModel state dict -> the UNet's state dict
    without its ``audio_inject.*`` branches."""
    shapes = template(UNet2DCondition, cfg or UNetConfig())
    return select(sd, {k: s for k, s in shapes.items() if not k.startswith("audio_inject.")},
                  what="diffusers UNet")


def convert_sd_vae(sd: Mapping, cfg: VAEConfig | None = None) -> Dict[str, torch.Tensor]:
    """diffusers AutoencoderKL state dict -> the VAE's state dict (encoder,
    decoder, quant_conv, post_quant_conv)."""
    return select(sd, template(AutoencoderKL, cfg or VAEConfig()), what="diffusers VAE")


def convert_clip_text(sd: Mapping, cfg: CLIPTextConfig | None = None) -> Dict[str, torch.Tensor]:
    """transformers CLIPTextModel state dict (``text_model.`` prefix or
    none) -> the CLIP text encoder's state dict."""
    prefix = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    return select(sd, template(CLIPTextEncoder, cfg or CLIPTextConfig()), prefix,
                  what="CLIP text")


def convert_clip_full(sd: Mapping, text_cfg: CLIPTextConfig | None = None,
                      vision_cfg=None):
    """A whole transformers ``CLIPModel`` state dict -> (text state dict,
    the ``clip_text_projection`` tower or None, vision state dict): the
    CLIPScore towers."""
    from clap2diffusion_tpu_torch.models.clip_vision import (
        convert_clip_text_projection,
        convert_clip_vision,
    )

    tproj = convert_clip_text_projection(sd) if "text_projection.weight" in sd else None
    return convert_clip_text(sd, text_cfg), tproj, convert_clip_vision(sd, vision_cfg)
