"""Stable Diffusion v1.5 AutoencoderKL, plain PyTorch over NHWC, with
diffusers' parameter names, registered decoder first (``decoder.*``,
``post_quant_conv.*``, ``encoder.*``, ``quant_conv.*``). The serving cells
use the decode side; the encoder is here for its names and shapes."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from perfbench.reference.plain import (
    Conv1x1,
    Conv2d,
    GroupNorm,
    Linear,
    conv3x3,
    mha,
    upsample_nearest2x,
)


class VAEResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, 1e-6, silu=True)
        self.conv1 = conv3x3(cin, cout)
        self.norm2 = GroupNorm(cout, groups, 1e-6, silu=True)
        self.conv2 = conv3x3(cout, cout)
        self.conv_shortcut = Conv1x1(cin, cout) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(channels, groups, 1e-6, silu=False)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        y = mha(self.to_q(y), self.to_k(y), self.to_v(y), 1)
        return x + self.to_out[0](y).reshape(b, h, w, c)


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, groups),
                                      VAEResnetBlock(channels, channels, groups)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Conv(nn.Module):
    def __init__(self, channels: int, stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=stride, padding=padding)


class _UpBlock(nn.Module):
    def __init__(self, cin, cout, layers, groups, upsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnetBlock(cin if j == 0 else cout, cout, groups) for j in range(layers)])
        if upsample:
            self.upsamplers = nn.ModuleList([_Conv(cout)])

    def forward(self, h):
        for res in self.resnets:
            h = res(h)
        if hasattr(self, "upsamplers"):
            h = self.upsamplers[0].conv(upsample_nearest2x(h))
        return h


class _DownBlock(nn.Module):
    def __init__(self, cin, cout, layers, groups, downsample):
        super().__init__()
        self.resnets = nn.ModuleList(
            [VAEResnetBlock(cin if j == 0 else cout, cout, groups) for j in range(layers)])
        if downsample:
            self.downsamplers = nn.ModuleList([_Conv(cout, stride=2, padding=0)])

    def forward(self, h):
        for res in self.resnets:
            h = res(h)
        if hasattr(self, "downsamplers"):
            h = self.downsamplers[0].conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
        return h


class VAEEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ch, g = list(cfg.block_out_channels), cfg.norm_num_groups
        self.conv_in = conv3x3(cfg.in_channels, ch[0])
        self.down_blocks = nn.ModuleList([
            _DownBlock(ch[max(i - 1, 0)], c, cfg.layers_per_block, g, i < len(ch) - 1)
            for i, c in enumerate(ch)])
        self.mid_block = VAEMidBlock(ch[-1], g)
        self.conv_norm_out = GroupNorm(ch[-1], g, 1e-6, silu=True)
        self.conv_out = conv3x3(ch[-1], 2 * cfg.latent_channels)


class VAEDecoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ch, g = list(cfg.block_out_channels), cfg.norm_num_groups
        self.conv_in = conv3x3(cfg.latent_channels, ch[-1])
        self.mid_block = VAEMidBlock(ch[-1], g)
        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList([
            _UpBlock(rev[max(i - 1, 0)], c, cfg.layers_per_block + 1, g, i < len(ch) - 1)
            for i, c in enumerate(rev)])
        self.conv_norm_out = GroupNorm(ch[0], g, 1e-6, silu=True)
        self.conv_out = conv3x3(ch[0], cfg.out_channels)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.decoder = VAEDecoder(cfg)
        self.post_quant_conv = Conv1x1(cfg.latent_channels, cfg.latent_channels)
        self.encoder = VAEEncoder(cfg)
        self.quant_conv = Conv1x1(2 * cfg.latent_channels, 2 * cfg.latent_channels)

    def decode_latent(self, z):
        """Scaled latent [B,h,w,4] -> image [B,8h,8w,3] in about [-1, 1]."""
        return self.decoder(self.post_quant_conv(z / self.cfg.scaling_factor))
