"""Winograd F(2x2, 3x3) convolution for the UNet's stride-1 SAME 3x3 convs
(counterpart of ``clap2diffusion_tpu/ops/winograd.py``).

The JAX package computes it in plain XLA, so this is plain PyTorch and no
kernel: the 4x4 input patches of every 2x2 output tile go through the
add-only BT transform in fp32 and are cast to x's type, 16 products
V[n] @ U[n] with U = G w G^T run with fp32 sums, the add-only AT transform
assembles the outputs, the bias is added in fp32 and the result cast to x's
type. ``Conv3x3`` is the UNet's 3x3 conv: with ``C2D_WINOGRAD=1`` (read per
call) and an eligible shape it runs ``conv3x3_winograd``, otherwise the
direct conv (cuDNN on the card). The hand-written Hopper kernel of the
Winograd conv is ``ops/winograd_pallas.py``, wired into no model, as in the
JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# F(2x2, 3x3) transform constants (Lavin & Gray, "Fast Algorithms for
# Convolutional Neural Networks"); the JAX package's values.
_BT = np.array(
    [[1, 0, -1, 0],
     [0, 1, 1, 0],
     [0, -1, 1, 0],
     [0, 1, 0, -1]], dtype=np.float32)
_G = np.array(
    [[1, 0, 0],
     [0.5, 0.5, 0.5],
     [0.5, -0.5, 0.5],
     [0, 0, 1]], dtype=np.float32)
_AT = np.array(
    [[1, 1, 1, 0],
     [0, 1, -1, -1]], dtype=np.float32)


def eligible(x_shape, kernel_shape, strides, padding) -> bool:
    """3x3, stride 1, SAME/((1,1),(1,1)), even H and W."""
    if tuple(kernel_shape[:2]) != (3, 3):
        return False
    if tuple(strides) != (1, 1):
        return False
    if padding not in ("SAME", ((1, 1), (1, 1)), [(1, 1), (1, 1)]):
        return False
    _, h, w, _ = x_shape
    return h % 2 == 0 and w % 2 == 0 and h >= 2 and w >= 2


def _bt_combine(vec):
    """BT @ [4 items] (coefficients 0/±1: adds only)."""
    return [vec[0] - vec[2], vec[1] + vec[2], vec[2] - vec[1], vec[1] - vec[3]]


def _at_combine(vec):
    """AT @ [4 items]."""
    return [vec[0] + vec[1] + vec[2], vec[1] - vec[2] - vec[3]]


def input_transform(x: torch.Tensor) -> torch.Tensor:
    """V = BT d BT^T of every tile's 4x4 patch of the zero-padded x, in fp32,
    cast to x's type: [16, B*TH*TW, Cin], n = 4i+j (i the row, j the
    column index)."""
    b, h, w, cin = x.shape
    th, tw = h // 2, w // 2
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    # 16 stride-2 planes d[p][q] = xp[:, 2r+p, 2c+q, :] -> [B, TH, TW, C]
    d = [[xp[:, p:p + 2 * th - 1:2, q:q + 2 * tw - 1:2] for q in range(4)] for p in range(4)]
    rows = [_bt_combine([d[p][q] for p in range(4)]) for q in range(4)]  # rows[q][i]
    v = [_bt_combine([rows[q][i] for q in range(4)]) for i in range(4)]  # v[i][j]
    return torch.stack([v[i][j] for i in range(4) for j in range(4)]).reshape(
        16, b * th * tw, cin).to(x.dtype)


def filter_transform(kernel: torch.Tensor) -> torch.Tensor:
    """U = G w G^T per (Cin, Cout) in fp32: [16, Cin, Cout] from an HWIO
    [3, 3, Cin, Cout] kernel."""
    g = torch.from_numpy(_G).to(kernel.device)
    u = torch.einsum("ip,pqco,jq->ijco", g, kernel.float(), g)
    return u.reshape(16, kernel.shape[2], kernel.shape[3])


def interleave(y, b: int, th: int, tw: int) -> torch.Tensor:
    """The four output planes Y[a][b'] ([B*TH*TW, Cout] each) -> [B, H, W, Cout]
    with out[:, 2r+a, 2c+b'] = Y[a][b'][:, r, c]."""
    cout = y[0][0].shape[-1]
    out = torch.stack([y[0][0], y[0][1], y[1][0], y[1][1]]).reshape(2, 2, b, th, tw, cout)
    return out.permute(2, 3, 0, 4, 1, 5).reshape(b, 2 * th, 2 * tw, cout)


def conv3x3_winograd(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC 3x3 stride-1 SAME conv via Winograd F(2x2,3x3).

    x: [B, H, W, Cin] (H, W even), kernel: [3, 3, Cin, Cout] (HWIO, the JAX
    package's layout), bias: [Cout] or None. Differentiable (autograd through
    the transforms)."""
    b, h, w, _ = x.shape
    th, tw = h // 2, w // 2
    v16 = input_transform(x)
    u16 = filter_transform(kernel).to(x.dtype)
    m16 = torch.matmul(v16.float(), u16.float())  # [16, B*TH*TW, Cout], fp32 sums
    m = [[m16[4 * i + j] for j in range(4)] for i in range(4)]
    cols = [_at_combine([m[i][j] for i in range(4)]) for j in range(4)]  # cols[j][a]
    y = [_at_combine([cols[j][a] for j in range(4)]) for a in range(2)]  # y[a][b']
    out = interleave(y, b, th, tw)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


class Conv3x3(nn.Conv2d):
    """The UNet's 3x3 stride-1 conv over NHWC (the JAX ``Conv3x3``), with
    ``nn.Conv2d``'s parameters (``weight`` [O, I, 3, 3], ``bias``) so the
    diffusers converters read its ``state_dict()``. The parameters are cast
    down to x's type. ``C2D_WINOGRAD=1`` with an eligible shape runs
    ``conv3x3_winograd``; anything else the direct conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if os.environ.get("C2D_WINOGRAD") == "1" and eligible(
                x.shape, (3, 3), (1, 1), "SAME"):
            return conv3x3_winograd(x, w.permute(2, 3, 1, 0), b)
        return F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)
