"""SD v1.5 AutoencoderKL decoder (port of the decode half of
``clap2diffusion_tpu/models/vae.py``), NHWC throughout.

Parameter names are diffusers' ``AutoencoderKL`` names under ``decoder.``
and ``post_quant_conv``. The encoder (img2img, inpainting, latent
precompute) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from clap2diffusion_tpu_torch.core.config import VAEConfig
from clap2diffusion_tpu_torch.models.layers import (
    Conv1x1,
    GroupNorm,
    conv3x3,
    upsample_nearest2x,
)
from clap2diffusion_tpu_torch.ops.attention import mha


class VAEResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, 1e-6, silu=True)
        self.conv1 = conv3x3(cin, cout)
        self.norm2 = GroupNorm(cout, groups, 1e-6, silu=True)
        self.conv2 = conv3x3(cout, cout)
        self.conv_shortcut = Conv1x1(cin, cout) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention at the bottleneck; at 64x64
    latents that is 4096 tokens of d=512, which runs the flash kernel."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(channels, groups, 1e-6, silu=False)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        y = mha(self.to_q(y), self.to_k(y), self.to_v(y), 1, use_flash=True)
        return x + self.to_out[0](y).reshape(b, h, w, c)


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, groups),
                                      VAEResnetBlock(channels, channels, groups)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, groups: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnetBlock(cin if j == 0 else cout, cout, groups) for j in range(layers)]
        )
        if upsample:
            self.upsamplers = nn.ModuleList([_Conv(cout)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for res in self.resnets:
            h = res(h)
        if hasattr(self, "upsamplers"):
            h = self.upsamplers[0].conv(upsample_nearest2x(h))
        return h


class _Conv(nn.Module):
    """Holds a 3x3 conv under the name ``conv`` (diffusers' Upsample2D)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = conv3x3(cfg.latent_channels, ch[-1])
        self.mid_block = VAEMidBlock(ch[-1], g)
        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList([
            _UpBlock(rev[max(i - 1, 0)], c, cfg.layers_per_block + 1, g, i < len(ch) - 1)
            for i, c in enumerate(rev)
        ])
        self.conv_norm_out = GroupNorm(ch[0], g, 1e-6, silu=True)
        self.conv_out = conv3x3(ch[0], cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    """The decode side of SD's VAE: ``decode_latent(z)`` maps a scaled
    latent [B,h,w,4] to an image [B,8h,8w,3] in [-1, 1]."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder = VAEDecoder(cfg)
        self.post_quant_conv = Conv1x1(cfg.latent_channels, cfg.latent_channels)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z / self.cfg.scaling_factor)
