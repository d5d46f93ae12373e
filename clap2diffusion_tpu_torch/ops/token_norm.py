"""Norm-60 token rescaling (port of ``clap2diffusion_tpu/ops/token_norm.py``)."""

from __future__ import annotations

import torch


def rescale_to_norm(tokens: torch.Tensor, target_norm: float = 60.0) -> torch.Tensor:
    """Rescale [..., T, D] tokens so mean(||token||_2) == target_norm.

    The mean runs over every token of the input, the batch included, as the
    reference's scalar ``.mean()`` does."""
    raw = torch.linalg.vector_norm(tokens.float(), dim=-1).mean()
    scale = torch.where(raw > 0, target_norm / raw, torch.ones_like(raw))
    return tokens * scale.to(tokens.dtype)
