"""SD v1.5 AutoencoderKL (port of ``clap2diffusion_tpu/models/vae.py``),
NHWC throughout.

``decode_latent`` is the last stage of every request; ``encode`` and
``sample_latent`` serve img2img and inpainting (and, later, latent
precompute). Parameter names are diffusers' ``AutoencoderKL`` names:
``decoder.*``, ``post_quant_conv.*``, ``encoder.*`` and ``quant_conv.*``,
registered in that order, so that ``random_init_`` draws the decoder's
weights before the encoder's and a seed gives the decoder it always gave.
The sampling noise of ``sample_latent`` comes from the caller's draw
callable, never from the global RNG.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clap2diffusion_tpu_torch.core.config import VAEConfig
from clap2diffusion_tpu_torch.models.layers import (
    Conv1x1,
    Conv2d,
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
    """Holds a 3x3 conv under the name ``conv`` (diffusers' Upsample2D and
    Downsample2D)."""

    def __init__(self, channels: int, stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=stride, padding=padding)


class _DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, groups: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnetBlock(cin if j == 0 else cout, cout, groups) for j in range(layers)]
        )
        if downsample:
            self.downsamplers = nn.ModuleList([_Conv(cout, stride=2, padding=0)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for res in self.resnets:
            h = res(h)
        if hasattr(self, "downsamplers"):
            # diffusers' asymmetric padding: one row and column after, none
            # before (not the UNet's pad of 1 on both sides), then VALID
            h = self.downsamplers[0].conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
        return h


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = conv3x3(cfg.in_channels, ch[0])
        self.down_blocks = nn.ModuleList([
            _DownBlock(ch[max(i - 1, 0)], c, cfg.layers_per_block, g, i < len(ch) - 1)
            for i, c in enumerate(ch)
        ])
        self.mid_block = VAEMidBlock(ch[-1], g)
        self.conv_norm_out = GroupNorm(ch[-1], g, 1e-6, silu=True)
        self.conv_out = conv3x3(ch[-1], 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        return self.conv_out(self.conv_norm_out(self.mid_block(h)))


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
    """SD's VAE: ``decode_latent(z)`` maps a scaled latent [B,h,w,4] to an
    image [B,8h,8w,3] in [-1, 1]; ``sample_latent(x, draw)`` maps an image
    in [-1, 1] to a sampled, scaled latent, with ``draw(shape)`` the
    standard normals (fp32) of the posterior sample."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        # the decode side first: see the module doc
        self.decoder = VAEDecoder(cfg)
        self.post_quant_conv = Conv1x1(cfg.latent_channels, cfg.latent_channels)
        self.encoder = VAEEncoder(cfg)
        self.quant_conv = Conv1x1(2 * cfg.latent_channels, 2 * cfg.latent_channels)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image [B,H,W,3] -> (mean, logvar) [B,H/8,W/8,4], logvar clipped
        to [-30, 20]."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def _sample(self, x: torch.Tensor, draw: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
        mean, logvar = self.encode(x)
        return mean + torch.exp(0.5 * logvar) * draw(tuple(mean.shape)).to(mean.dtype)

    def forward(self, x: torch.Tensor, draw: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
        """Encode, sample, decode."""
        return self.decode(self._sample(x, draw))

    def sample_latent(self, x: torch.Tensor,
                      draw: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
        """Image in [-1, 1] -> scaled latent (the training-space one)."""
        return self._sample(x, draw) * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z / self.cfg.scaling_factor)
