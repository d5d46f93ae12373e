"""InceptionV3 (pool3, 2048-d, and the 1000-way head), the standard-FID
feature extractor (port of ``clap2diffusion_tpu/models/inception_v3.py``).

Geometry and parameter names are torchvision's ``inception_v3`` without the
aux head: a stem of five conv+BN blocks with two 3x3/2 max pools, Mixed_5b..5d
(A), Mixed_6a (B), Mixed_6b..6e (C), Mixed_7a (D), Mixed_7b..7c (E), a global
average pool -> pool3 [B, 2048], and ``fc`` -> logits [B, 1000]. BatchNorm is
inference-only: ``BatchNorm`` always normalises with the running statistics
(eps 1e-3), whatever the module's mode, so a tower left in train mode gives
the same numbers; its state dict is torchvision's without
``num_batches_tracked``. The tower is built in fp32 (the JAX convs promote
their weights against the fp32 pixels).

Two pooling variants (``variant=``): ``"torchvision"`` (stock: average pools
count the zero padding) and ``"pytorch_fid"`` (pytorch-fid's TF-port
patches: the pool branches' average pools exclude the padding, and
Mixed_7c's pool branch is a 3x3/1 max pool), the one published FID numbers
use. Weights convert identically for both.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clap2diffusion_tpu_torch.models.clip_vision import build_tower, resize_bilinear

BN_EPS = 1e-3
POOL3_DIM = 2048
NUM_CLASSES = 1000
VARIANTS = ("torchvision", "pytorch_fid")
Pad = Union[int, Tuple[int, int]]


class BatchNorm(nn.Module):
    """BatchNorm with running statistics only (inference)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=BN_EPS)


class ConvBN(nn.Module):
    """torchvision ``BasicConv2d``: bias-free conv, BatchNorm, ReLU (NCHW)."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x: torch.Tensor, variant: str) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1,
                        count_include_pad=(variant != "pytorch_fid"))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, variant: str):
        super().__init__()
        self.variant = variant
        self.branch1x1 = ConvBN(cin, 64, 1)
        self.branch5x5_1 = ConvBN(cin, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3(x, self.variant))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, variant: str):
        super().__init__()
        self.variant = variant
        self.branch1x1 = ConvBN(cin, 192, 1)
        self.branch7x7_1 = ConvBN(cin, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(cin, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool3(x, self.variant))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(cin, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, variant: str, pool_max: bool = False):
        super().__init__()
        self.variant, self.pool_max = variant, pool_max
        self.branch1x1 = ConvBN(cin, 320, 1)
        self.branch3x3_1 = ConvBN(cin, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(cin, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        # pytorch-fid's FIDInceptionE_2 (Mixed_7c): the TF graph's max pool
        pooled = (F.max_pool2d(x, 3, stride=1, padding=1) if self.pool_max
                  else _avg_pool3(x, self.variant))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], dim=1)


class InceptionV3(nn.Module):
    """``forward(pixels [B,H,W,3] in [-1,1]) -> {"pool3": [B,2048],
    "logits": [B,1000]}`` (fp32). H = W = 299 for standard FID; any size
    from 75 works. ``transform_input`` is torchvision's channel
    renormalisation."""

    def __init__(self, variant: str = "torchvision", transform_input: bool = False):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown InceptionV3 variant {variant!r}; "
                             f"expected one of {VARIANTS}")
        self.variant, self.transform_input = variant, transform_input
        v = variant
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, v)
        self.Mixed_5c = InceptionA(256, 64, v)
        self.Mixed_5d = InceptionA(288, 64, v)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, v)
        self.Mixed_6c = InceptionC(768, 160, v)
        self.Mixed_6d = InceptionC(768, 160, v)
        self.Mixed_6e = InceptionC(768, 192, v)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, v)
        self.Mixed_7c = InceptionE(2048, v, pool_max=(v == "pytorch_fid"))
        self.fc = nn.Linear(POOL3_DIM, NUM_CLASSES)

    def forward(self, pixels: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = pixels.float()
        if self.transform_input:
            x = torch.cat([x[..., 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,
                           x[..., 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
                           x[..., 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5], dim=-1)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool3 = x.mean(dim=(2, 3))
        return {"pool3": pool3, "logits": self.fc(pool3)}


def build_inception(sd: Mapping[str, torch.Tensor], device, variant: str = "torchvision",
                    transform_input: bool = False) -> InceptionV3:
    """An fp32 tower in eval mode on ``device`` from a state dict held in
    any type (``clip_vision.build_tower``), its kernels channels-last."""
    tower = build_tower(functools.partial(InceptionV3, transform_input=transform_input),
                        variant, sd, device)
    return tower.to(memory_format=torch.channels_last)


def preprocess_images_inception_device(images: torch.Tensor,
                                       image_size: int = 299) -> torch.Tensor:
    """uint8 [B,H,W,3] -> fp32 [B,299,299,3] in [-1,1] on the same device:
    the JAX bilinear resize (``clip_vision.resize_bilinear``: antialiased on
    an axis that shrinks, as ``jax.image.resize``), then [0,1] -> [-1,1]."""
    x = images.float() / 255.0
    if tuple(x.shape[1:3]) != (image_size, image_size):
        x = resize_bilinear(x, (image_size, image_size))
    return x * 2.0 - 1.0


def preprocess_images_inception(images: np.ndarray, image_size: int = 299) -> np.ndarray:
    """Host form of ``preprocess_images_inception_device``."""
    return preprocess_images_inception_device(torch.from_numpy(np.asarray(images)),
                                              image_size).numpy()


def convert_inception_v3(sd: Mapping) -> Dict[str, torch.Tensor]:
    """torchvision ``inception_v3`` state dict (``module.`` prefixes
    stripped) -> the tower's state dict, strict: the aux head
    (``AuxLogits.*``) and ``num_batches_tracked`` are skipped, a missing
    ``fc`` becomes zeros (FID needs only pool3), and any other key left
    over raises ``ValueError``."""
    from clap2diffusion_tpu_torch.models.convert import select, template

    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    shapes = template(InceptionV3)
    body = {k: s for k, s in shapes.items() if not k.startswith("fc.")}
    out = select(sd, body, what="InceptionV3")
    if "fc.weight" in sd:
        out.update(select(sd, {k: shapes[k] for k in ("fc.weight", "fc.bias")},
                          what="InceptionV3"))
    else:
        out["fc.weight"] = torch.zeros(NUM_CLASSES, POOL3_DIM)
        out["fc.bias"] = torch.zeros(NUM_CLASSES)
    leftovers = [k for k in sd if k not in out and not k.startswith("AuxLogits.")
                 and not k.endswith("num_batches_tracked")]
    if leftovers:
        raise ValueError(f"unconsumed InceptionV3 keys: {sorted(leftovers)[:8]}...")
    return out
