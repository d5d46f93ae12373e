"""Layers shared by the port's UNet and VAE, over NHWC activations.

The JAX package keeps every activation as [B, H, W, C]; so does the port.
A convolution sees the tensor through ``permute(0, 3, 1, 2)``, which is a
``torch.channels_last`` view of NCHW, so cuDNN reads and writes NHWC
memory and the GroupNorm kernel gets the layout the TPU kernel had.
Parameter names and shapes are PyTorch's own (``weight`` [O, I, kh, kw],
``bias``), so the diffusers converters of the JAX package read them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from clap2diffusion_tpu_torch.ops.groupnorm import group_norm, group_norm_silu


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
