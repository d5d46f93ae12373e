"""Layers shared by the port's UNet and VAE, over NHWC activations.

The JAX package keeps every activation as [B, H, W, C]; so does the port.
A convolution sees the tensor through ``permute(0, 3, 1, 2)``, which is a
``torch.channels_last`` view of NCHW, so cuDNN reads and writes NHWC
memory and the GroupNorm kernel gets the layout the TPU kernel had.
Parameter names and shapes are PyTorch's own (``weight`` [O, I, kh, kw],
``bias``), so the diffusers converters of the JAX package read them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from clap2diffusion_tpu_torch.ops.groupnorm import group_norm, group_norm_silu


class DataSlice:
    """One data-parallel rank's view of a ``torch.Generator``: a draw of
    shape (b, ...) draws the global batch's (b * count, ...) and keeps this
    rank's rows [index * b, (index + 1) * b), so that ``count`` ranks draw
    what one process draws for the whole batch (``parallel/sharding.py``)."""

    def __init__(self, generator: torch.Generator, index: int, count: int):
        self.generator, self.index, self.count = generator, index, count


def draw(fn: Callable, shape, generator, **kw) -> torch.Tensor:
    """``fn(shape, generator=..., **kw)`` (``torch.rand``, ``torch.randn``
    or the like), or this rank's rows of the global draw when ``generator``
    is a ``DataSlice``."""
    if not isinstance(generator, DataSlice):
        return fn(tuple(shape), generator=generator, **kw)
    b = shape[0]
    full = fn((b * generator.count, *shape[1:]), generator=generator.generator, **kw)
    return full[generator.index * b:(generator.index + 1) * b]


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``nn.Dropout``: the identity when ``deterministic``; otherwise
    each element is kept with probability ``1 - rate`` and scaled by
    ``1 / (1 - rate)``. The mask comes from ``generator`` (on x's device),
    never from the global RNG."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a torch.Generator")
    keep = 1.0 - rate
    mask = draw(torch.rand, x.shape, generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` applied to an NHWC tensor, returning NHWC."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def conv3x3(cin: int, cout: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1)


class Conv1x1(nn.Conv2d):
    """A 1x1 convolution over NHWC, computed as the matmul it is."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.flatten(1), self.bias)


class GroupNorm(nn.Module):
    """GroupNorm (optionally fused with SiLU) over NHWC, through the
    port's kernel on CUDA and its plain version on the CPU."""

    def __init__(self, channels: int, groups: int, eps: float, silu: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups, self.eps, self.silu = groups, eps, silu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = group_norm_silu if self.silu else group_norm
        return fn(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.groups, self.eps)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 over NHWC."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
