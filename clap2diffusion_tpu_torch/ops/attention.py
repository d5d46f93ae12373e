"""Attention primitives shared by every model of the port
(counterpart of ``clap2diffusion_tpu/ops/attention.py``).

The plain path is matmul attention with an fp32 softmax. Long, unmasked
attention on a CUDA tensor goes to the hand-written flash kernel in
``ops/flash_attention.py`` under the same rule as the JAX package's
``_flash_eligible``: no mask, Sq >= 256 and Sk >= 128. With
``C2D_PACKED_FLASH=1`` (read per call), ``mha`` sends long self-attention
with small heads to the head-packed kernel on the [B, S, H*D] projections,
under the JAX ``mha`` rule (``packed_mha_eligible``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from clap2diffusion_tpu_torch.ops.flash_attention import flash_attention, packed_flash_nhd


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*Dh] -> [B, H, S, Dh] (a view)."""
    b, s, d = x.shape
    return x.view(b, s, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, Dh] -> [B, S, H*Dh]."""
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _flash_eligible(q: torch.Tensor, k: torch.Tensor, mask) -> bool:
    return mask is None and q.shape[-2] >= 256 and k.shape[-2] >= 128 and q.is_cuda


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    use_flash: bool = False,
) -> torch.Tensor:
    """Attention over [B, H, S, Dh]. Logits are rounded to the input type
    (as the JAX einsum does) and the softmax runs in float32; the output
    keeps the input type. ``mask`` is boolean, True where attention is
    allowed."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_flash and _flash_eligible(q, k, mask):
        return flash_attention(q, k, v, float(scale))
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(q.dtype), v)


def packed_mha_eligible(q_shape, k_shape, num_heads: int, masked: bool, use_flash: bool,
                        cuda: bool) -> bool:
    """The JAX ``mha`` test for its packed route (``attention.py:94-105``):
    ``use_flash``, no mask, ``128 // d >= 2``, at least 2 heads, Sq >= 1024,
    Sq == Sk, Sq % 128 == 0 and ``C2D_PACKED_FLASH=1``, with a CUDA tensor
    in place of the TPU backend. Shapes are [B, S, H*D]."""
    d = q_shape[-1] // num_heads
    return (use_flash and not masked and 128 // d >= 2 and num_heads >= 2
            and q_shape[1] >= 1024 and q_shape[1] == k_shape[1] and q_shape[1] % 128 == 0
            and cuda and os.environ.get("C2D_PACKED_FLASH") == "1")


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    *,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    use_flash: bool = False,
) -> torch.Tensor:
    """Attention over [B, S, D] projections, splitting and merging heads;
    on the packed route, over the projections as they are."""
    if packed_mha_eligible(q.shape, k.shape, num_heads, mask is not None, use_flash, q.is_cuda):
        d = q.shape[-1] // num_heads
        return packed_flash_nhd(q, k, v, num_heads, min(128 // d, num_heads),
                                float(d ** -0.5 if scale is None else scale))
    out = dot_product_attention(
        split_heads(q, num_heads),
        split_heads(k, num_heads),
        split_heads(v, num_heads),
        scale=scale,
        mask=mask,
        use_flash=use_flash,
    )
    return merge_heads(out)
