"""CLIP ViT-L/14 vision encoder, the image side of CLIPScore (port of
``clap2diffusion_tpu/models/clip_vision.py``).

Patch 14, image 224, width 1024, 24 layers, 16 heads, quick-GELU, a class
token, pre- and post-LayerNorm and a 1024 -> 768 projection, L2-normalised
(``CLIPModel.get_image_features``). Parameter names are HF ``CLIPModel``'s
(``vision_model.*``, ``visual_projection.weight``). Attention is the plain
matmul path, as the JAX tower calls ``mha`` without ``use_flash``.

The JAX tower promotes its weights against the fp32 pixels, so it computes
in fp32 whatever type its weights are held in; so does the port's: the
caller builds it in fp32 (``build_tower``) from weights held in any type.

Preprocessing (``preprocess_images_device``): uint8 -> [0, 1], bilinear
resize of the short side to 224, centre crop, CLIP mean/std.
``jax.image.resize`` antialiases when it downsamples and not when it
upsamples, so ``resize_bilinear`` resizes each axis with PyTorch's
antialias on exactly where that axis shrinks.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clap2diffusion_tpu_torch.core.config import CLIPVisionConfig
from clap2diffusion_tpu_torch.models.clip_text import CLIPEncoderLayer
from clap2diffusion_tpu_torch.models.tokenizer import EOT

# OpenAI CLIP preprocessing constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class _Embeddings(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        n = (c.image_size // c.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(c.hidden_size))
        self.patch_embedding = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size,
                                         bias=False)
        self.position_embedding = nn.Embedding(n, c.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        # the text encoder's layer: the same names, shapes and math (no mask)
        self.layers = nn.ModuleList([CLIPEncoderLayer(c) for _ in range(c.num_layers)])


class _VisionModel(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(c)
        self.pre_layrnorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.encoder = _Encoder(c)
        self.post_layernorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class CLIPVisionEncoder(nn.Module):
    """``forward(pixels [B,224,224,3] CLIP-normalised) -> [B,768]``,
    L2-normalised image features."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionModel(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        m = self.vision_model
        e = m.embeddings
        w = e.patch_embedding.weight
        patches = e.patch_embedding(pixels.to(w.dtype).permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)  # [B, h*w, C], row-major as NHWC
        cls = e.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1) + e.position_embedding.weight[None].to(patches.dtype)
        x = m.pre_layrnorm(x)
        for layer in m.encoder.layers:
            x = layer(x, None)
        feats = self.visual_projection(m.post_layernorm(x[:, 0]))
        f32 = feats.float()
        return (f32 / torch.linalg.vector_norm(f32, dim=-1, keepdim=True)).to(feats.dtype)


def build_tower(module_cls, cfg, sd: Mapping[str, torch.Tensor], device) -> nn.Module:
    """``module_cls(cfg)`` as an fp32 tower in eval mode on ``device`` from a
    state dict held in any type (the JAX towers that promote their weights
    against fp32 inputs: CLIP vision, Inception)."""
    with torch.device("meta"):
        m = module_cls(cfg)
    m.to_empty(device=device)
    m.load_state_dict({k: v.to(device, torch.float32) for k, v in sd.items()}, strict=True)
    return m.float().eval().requires_grad_(False)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` of NHWC float ``x`` to
    ``size`` (h, w): half-pixel centres, one axis at a time, antialiased
    where the axis shrinks."""
    h, w = x.shape[1:3]
    nh, nw = size
    y = x.permute(0, 3, 1, 2)
    if nh != h:
        y = F.interpolate(y, size=(nh, w), mode="bilinear", align_corners=False,
                          antialias=nh < h)
    if nw != w:
        y = F.interpolate(y, size=(nh, nw), mode="bilinear", align_corners=False,
                          antialias=nw < w)
    return y.permute(0, 2, 3, 1)


def preprocess_images_device(images: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """uint8 [B,H,W,3] (on any device) -> CLIP-normalised fp32
    [B,224,224,3] on the same device: short side resized to ``image_size``,
    centre crop, mean/std."""
    x = images.float() / 255.0
    h, w = x.shape[1:3]
    scale = image_size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = resize_bilinear(x, (nh, nw))
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    x = x[:, top:top + image_size, left:left + image_size, :]
    mean = torch.as_tensor(CLIP_MEAN, device=x.device)
    std = torch.as_tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def preprocess_images(images: np.ndarray, image_size: int = 224) -> np.ndarray:
    """Host form of ``preprocess_images_device`` (the same numerics)."""
    return preprocess_images_device(torch.from_numpy(np.asarray(images)), image_size).numpy()


def clip_text_features(hidden: torch.Tensor, input_ids: torch.Tensor,
                       text_projection: torch.Tensor, eot_id: int = EOT) -> torch.Tensor:
    """``CLIPModel.get_text_features``: the first EOT token's hidden state
    [B, 768] through the text projection (a weight [out, in], in the
    promoted type of the two, as the JAX matmul promotes), L2-normalised,
    fp32."""
    ids = input_ids.to(hidden.device)
    idx = torch.argmax((ids == eot_id).int(), dim=-1)
    pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    dt = torch.promote_types(pooled.dtype, text_projection.dtype)
    feats = (pooled.to(dt) @ text_projection.to(dt).t()).float()
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def convert_clip_vision(sd: Mapping, cfg: CLIPVisionConfig | None = None):
    """transformers ``CLIPModel`` / ``CLIPVisionModel(WithProjection)``
    state dict (``vision_model.`` prefix or none) -> the vision tower's
    state dict; ``visual_projection.weight`` where the dict has it."""
    from clap2diffusion_tpu_torch.models.convert import select, template

    shapes = template(CLIPVisionEncoder, cfg or CLIPVisionConfig())
    full = any(k.startswith("vision_model.") for k in sd)
    body = {k[len("vision_model."):]: s for k, s in shapes.items()
            if k.startswith("vision_model.")}
    out = {"vision_model." + k: v for k, v in select(
        sd, body, "vision_model." if full else "", what="CLIP vision").items()}
    if "visual_projection.weight" in sd:
        out.update(select(sd, {"visual_projection.weight": shapes["visual_projection.weight"]},
                          what="CLIP vision"))
    return out


def convert_clip_text_projection(sd: Mapping) -> dict:
    """A ``CLIPModel`` dict's ``text_projection.weight`` [768, 768] as the
    ``clip_text_projection`` tower (``{"weight"}``, fp32)."""
    return {"weight": torch.as_tensor(sd["text_projection.weight"]).detach().to(
        "cpu", torch.float32)}
