"""Level-routed audio injection into UNet cross-attention, plain PyTorch: a
frozen copy of the program's ``models/condition/inject.py``.

Parameter names follow the reference's ``AudioAttnProcessor``
(``audio_proj`` = Linear, GELU, Dropout, Linear; ``alpha``), as
``models/condition/export.py::export_injection_processors`` names them.
The dropout slot is an identity: the JAX training steps apply the UNet
deterministically, so this dropout is off in training too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.plain import Linear


def adaptive_avg_pool_tokens(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """torch.adaptive_avg_pool1d over the token axis of [B, T, D]; segment i
    averages positions [floor(i*T/out), ceil((i+1)*T/out))."""
    t = x.shape[1]
    if t <= out_len:
        return x
    pieces = [
        x[:, math.floor(i * t / out_len):math.ceil((i + 1) * t / out_len)].mean(1, keepdim=True)
        for i in range(out_len)
    ]
    return torch.cat(pieces, dim=1)


class AudioInjection(nn.Module):
    """Per-level audio conditioning of the text encoder states."""

    def __init__(self, audio_dim: int = 768, hidden_dim: int = 768,
                 bottleneck_dim: int = 64, mode: str = "add",
                 max_concat_tokens: int = 4):
        super().__init__()
        if mode not in ("add", "concat"):
            raise ValueError(f"unknown injection mode {mode!r}")
        self.mode, self.max_concat_tokens = mode, max_concat_tokens
        self.audio_proj = nn.ModuleList([
            Linear(audio_dim, bottleneck_dim), nn.GELU(), nn.Identity(),
            Linear(bottleneck_dim, hidden_dim),
        ])
        if mode == "add":
            self.alpha = nn.Parameter(torch.zeros(1))

    def forward(self, encoder_hidden_states: torch.Tensor,
                audio_tokens: Optional[torch.Tensor]) -> torch.Tensor:
        if audio_tokens is None:
            return encoder_hidden_states
        h = F.gelu(self.audio_proj[0](audio_tokens.to(encoder_hidden_states.dtype)))
        projected = self.audio_proj[3](h)
        if self.mode == "add":
            gate = torch.sigmoid(self.alpha).to(encoder_hidden_states.dtype)
            return encoder_hidden_states + gate * projected.mean(1, keepdim=True)
        projected = adaptive_avg_pool_tokens(projected, self.max_concat_tokens)
        return torch.cat([encoder_hidden_states, projected], dim=1)
