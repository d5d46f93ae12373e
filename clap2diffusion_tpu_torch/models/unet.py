"""Stable Diffusion v1.5 UNet with level-routed audio conditioning (port of
``clap2diffusion_tpu/models/unet.py``), NHWC throughout.

Parameter names are diffusers' ``UNet2DConditionModel`` names
(``down_blocks.0.resnets.1.norm1.weight``, ...), so the JAX package's
``convert_sd_unet`` reads the port's ``state_dict()``. The audio-injection
branches live under ``audio_inject.{early,mid,late}``.

Self-attention with at least 256 tokens on CUDA runs the flash kernel
(``ops/flash_attention.py``); every ResnetBlock norm and ``conv_norm_out``
runs the GroupNorm+SiLU kernel (``ops/groupnorm.py``). The opt-in routes of
the JAX package are read per call from the same environment variables:
``C2D_PACKED_FLASH=1`` sends the 4096-token self-attentions to the
head-packed kernel (``ops/attention.py::mha``), and ``C2D_WINOGRAD=1`` runs
the eligible 3x3 convs (``Conv3x3``: ``conv_in``, ``conv_out``, each
ResnetBlock's ``conv1``/``conv2`` and the ``Upsample`` conv, as in JAX) as
the plain-PyTorch Winograd of ``ops/winograd.py``. ``C2D_INT8=1`` (the JAX
W8A8 serving path, ``ops/quant.py``) is not ported: the forward raises.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from clap2diffusion_tpu_torch.core.config import UNetConfig
from clap2diffusion_tpu_torch.models.condition.inject import AudioInjection
from clap2diffusion_tpu_torch.models.layers import (
    Conv1x1,
    GroupNorm,
    conv3x3,
    upsample_nearest2x,
)
from clap2diffusion_tpu_torch.ops.attention import mha
from clap2diffusion_tpu_torch.ops.winograd import Conv3x3

LEVELS = ("early", "mid", "late")


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal embeddings, SD convention ([cos, sin], freq_shift 0)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimeEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, 1e-5, silu=True)
        self.conv1 = Conv3x3(cin, cout)
        self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = GroupNorm(cout, groups, 1e-5, silu=True)
        self.conv2 = Conv3x3(cout, cout)
        self.conv_shortcut = Conv1x1(cin, cout) if cin != cout else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    """QKV attention; the context defaults to the hidden states. The three
    projections stay separate matmuls: the flash kernel reads each through
    its strides, so nothing is concatenated or transposed."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 num_heads: int = 8, use_flash: bool = False):
        super().__init__()
        ctx = query_dim if context_dim is None else context_dim
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(ctx, query_dim, bias=False)
        self.to_v = nn.Linear(ctx, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])
        self.num_heads, self.use_flash = num_heads, use_flash

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        out = mha(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.num_heads,
                  use_flash=self.use_flash)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class GEGLUFeedForward(nn.Module):
    """diffusers ``FeedForward``: ``net.0`` GEGLU, ``net.1`` dropout,
    ``net.2`` the output projection."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, context_dim: int, use_flash: bool):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, num_heads=num_heads, use_flash=use_flash)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, num_heads=num_heads)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: 1x1-conv projections around one block over the
    H*W tokens."""

    def __init__(self, channels: int, num_heads: int, context_dim: int, groups: int,
                 use_flash: bool):
        super().__init__()
        self.norm = GroupNorm(channels, groups, 1e-6, silu=False)
        self.proj_in = Conv1x1(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, num_heads, context_dim, use_flash)]
        )
        self.proj_out = Conv1x1(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x)).reshape(b, h * w, c)
        y = self.transformer_blocks[0](y, context)
        return self.proj_out(y.reshape(b, h, w, c)) + x


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest2x(x))


class _Block(nn.Module):
    """A diffusers down/mid/up block: ``resnets``, ``attentions`` and an
    optional ``downsamplers``/``upsamplers`` list."""

    def __init__(self, resnets, attentions, sampler_name: Optional[str] = None,
                 sampler: Optional[nn.Module] = None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        self.sampler_name = sampler_name
        if sampler_name is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))

    def sample(self, h: torch.Tensor) -> torch.Tensor:
        if self.sampler_name is None:
            return h
        return getattr(self, self.sampler_name)[0](h)


class UNet2DCondition(nn.Module):
    """``forward(sample [B,H,W,4], timesteps [B], encoder_hidden_states
    [B,77,768], audio_routed={'early','mid','late': [B,K,768]} | None)``
    -> epsilon [B,H,W,4]."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ch, g, L = cfg.block_out_channels, cfg.norm_num_groups, cfg.layers_per_block
        temb = ch[0] * 4
        heads, ctx_dim = cfg.num_attention_heads, cfg.cross_attention_dim

        def tf(c):
            return Transformer2D(c, heads, ctx_dim, g, cfg.flash_attention)

        self.time_embedding = TimeEmbedding(ch[0], temb)
        if cfg.audio_inject:
            self.audio_inject = nn.ModuleDict({
                lvl: AudioInjection(ctx_dim, ctx_dim, cfg.injection_bottleneck,
                                    cfg.injection_mode, cfg.injection_max_concat_tokens)
                for lvl in LEVELS
            })
        self.conv_in = Conv3x3(cfg.in_channels, ch[0])

        skip_ch = [ch[0]]
        down, cin = [], ch[0]
        for i, c in enumerate(ch):
            resnets, attns = [], []
            for _ in range(L):
                resnets.append(ResnetBlock(cin, c, temb, g))
                cin = c
                if cfg.cross_attn_blocks[i]:
                    attns.append(tf(c))
                skip_ch.append(c)
            last = i == len(ch) - 1
            down.append(_Block(resnets, attns, None if last else "downsamplers",
                               None if last else Downsample(c)))
            if not last:
                skip_ch.append(c)
        self.down_blocks = nn.ModuleList(down)

        self.mid_block = _Block([ResnetBlock(ch[-1], ch[-1], temb, g),
                                 ResnetBlock(ch[-1], ch[-1], temb, g)], [tf(ch[-1])])

        up, hc = [], ch[-1]
        for i, c in enumerate(reversed(ch)):
            has_attn = cfg.cross_attn_blocks[len(ch) - 1 - i]
            resnets, attns = [], []
            for _ in range(L + 1):
                resnets.append(ResnetBlock(hc + skip_ch.pop(), c, temb, g))
                hc = c
                if has_attn:
                    attns.append(tf(c))
            last = i == len(ch) - 1
            up.append(_Block(resnets, attns, None if last else "upsamplers",
                             None if last else Upsample(c)))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = GroupNorm(ch[0], g, 1e-5, silu=True)
        self.conv_out = Conv3x3(ch[0], cfg.out_channels)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                audio_routed: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        if os.environ.get("C2D_INT8") == "1":
            raise NotImplementedError(
                "C2D_INT8=1 (the W8A8 serving path of clap2diffusion_tpu/ops/quant.py) is not "
                "ported to the PyTorch package yet (ROADMAP.md, Queue 1 item 17); unset it")
        cfg = self.cfg
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_embedding(temb.to(sample.dtype))

        ctx_by_level = {lvl: encoder_hidden_states for lvl in LEVELS}
        if cfg.audio_inject:
            for lvl in LEVELS:
                tokens = None if audio_routed is None else audio_routed.get(lvl)
                ctx_by_level[lvl] = self.audio_inject[lvl](encoder_hidden_states, tokens)

        h = self.conv_in(sample)
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            ctx = ctx_by_level[cfg.down_block_levels[i]]
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, ctx)
                skips.append(h)
            if blk.sampler_name is not None:
                h = blk.sample(h)
                skips.append(h)

        ctx = ctx_by_level[cfg.mid_block_level]
        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, ctx)
        h = self.mid_block.resnets[1](h, temb)

        for i, blk in enumerate(self.up_blocks):
            ctx = ctx_by_level[cfg.up_block_levels[i]]
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=-1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, ctx)
            h = blk.sample(h)

        return self.conv_out(self.conv_norm_out(h))
