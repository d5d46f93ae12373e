"""Plain PyTorch building blocks of the benchmark's reference models.

Every reference model is float32 matmul-and-softmax arithmetic with no
kernel of the program under test: attention is ``softmax(q k^T) v`` in
float32, GroupNorm is ``F.group_norm``, convolutions are ``F.conv2d``.
Callers switch TF32 off (``reference.precision.fp32``) so that a float32
product is a float32 product on the card.

``PRECISION`` selects the control: ``"fp8"`` rounds the inputs and weights
of every Linear, Conv2d and attention product to float8 e4m3 with one scale
per tensor (fake quantisation, a straight-through gradient), the nearest
precision below the bf16 the configurations serve in. ``None`` (the
default) is the float32 reference.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PRECISION: Optional[str] = None
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def fq(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded as ``PRECISION`` says (identity for float32), with a
    straight-through gradient."""
    if PRECISION is None or not x.is_floating_point():
        return x
    if PRECISION != "fp8":
        raise ValueError(f"unknown reference precision {PRECISION!r}")
    scale = x.detach().abs().amax().float().clamp_min(1e-12) / FP8_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def device_constant(key: Hashable, make: Callable[[torch.device], object],
                    device) -> torch.Tensor:
    device = torch.device(device)
    k = (key, device)
    if k not in _CONSTANTS:
        with torch.inference_mode(False):
            value = make(device)
            if isinstance(value, np.ndarray):
                value = torch.from_numpy(value).to(device)
        _CONSTANTS[k] = value
    return _CONSTANTS[k]


def draw(fn: Callable, shape, generator, **kw) -> torch.Tensor:
    return fn(tuple(shape), generator=generator, **kw)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each element with probability ``1 - rate``, scaled by
    ``1 / (1 - rate)``; the mask is ``rand < keep`` from ``generator``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = draw(torch.rand, x.shape, generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(fq(x), fq(self.weight), self.bias)


class Conv2dNCHW(nn.Conv2d):
    """``nn.Conv2d`` over NCHW, with the control's rounding."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(fq(x), fq(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` applied to an NHWC tensor, returning NHWC."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(fq(x.permute(0, 3, 1, 2)), fq(self.weight), self.bias)
        return y.permute(0, 2, 3, 1)


def conv3x3(cin: int, cout: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1)


class Conv1x1(nn.Conv2d):
    """A 1x1 convolution over NHWC, as the matmul it is."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(fq(x), fq(self.weight.flatten(1)), self.bias)


class GroupNorm(nn.Module):
    """GroupNorm over NHWC, optionally followed by SiLU."""

    def __init__(self, channels: int, groups: int, eps: float, silu: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups, self.eps, self.silu = groups, eps, silu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.permute(0, 3, 1, 2).float(), self.groups, self.weight.float(),
                         self.bias.float(), self.eps).permute(0, 2, 3, 1).to(x.dtype)
        return F.silu(y) if self.silu else y


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.view(b, s, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


ATTN_CHUNK = 1 << 28  # logits elements per block of (batch x head) rows


def dot_product_attention(q, k, v, *, scale=None, mask=None) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` over [B, H, S, Dh] in float32, in blocks
    of batch-and-head rows so that the logits of a 4096-token attention fit."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, sq, dh = q.shape
    sk = k.shape[-2]
    q, k, v = (t.reshape(b * h, *t.shape[2:]) for t in (q, k, v))
    if mask is not None:
        mask = mask.expand(b, h, sq, sk).reshape(b * h, sq, sk)
    rows = max(1, ATTN_CHUNK // (sq * sk))
    out = []
    for i in range(0, b * h, rows):
        qi, ki, vi = fq(q[i:i + rows]), fq(k[i:i + rows]), fq(v[i:i + rows])
        logits = torch.matmul(qi, ki.transpose(-1, -2)).float() * scale
        if mask is not None:
            logits = logits.masked_fill(~mask[i:i + rows], torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1)
        out.append(torch.matmul(fq(probs).to(vi.dtype), vi))
    return torch.cat(out).reshape(b, h, sq, dh)


def mha(q, k, v, num_heads: int, *, scale=None, mask=None, use_flash: bool = False):
    """Attention over [B, S, D] projections (``use_flash`` is ignored: the
    reference has one path)."""
    del use_flash
    out = dot_product_attention(split_heads(q, num_heads), split_heads(k, num_heads),
                                split_heads(v, num_heads), scale=scale, mask=mask)
    return merge_heads(out)


def rescale_to_norm(tokens: torch.Tensor, target_norm) -> torch.Tensor:
    """Rescale [..., T, D] tokens so that the mean token norm (over every
    token of the batch) is ``target_norm``."""
    raw = torch.linalg.vector_norm(tokens.float(), dim=-1).mean()
    scale = torch.where(raw > 0, target_norm / raw, torch.ones_like(raw))
    return tokens * scale.to(tokens.dtype)
