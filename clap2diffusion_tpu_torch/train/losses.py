"""Training losses of the three stages (port of
``clap2diffusion_tpu/train/losses.py``), computed in fp32.

Stage 1: MSE(mean-pooled adapter tokens, text embedding) + InfoNCE at
T=0.07 with in-batch negatives. Stage 2: diffusion MSE + weighted
orthogonality and entropy. Stage 3: diffusion + consistency (adjacent-level
smoothness of the routed early/mid/late token means) + alignment (cosine
to the text embedding).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def stage1_losses(audio_tokens: torch.Tensor, text_emb: torch.Tensor,
                  temperature: float = 0.07) -> Dict[str, torch.Tensor]:
    pooled = audio_tokens.mean(dim=1).float()
    text = text_emb.float()
    mse = ((pooled - text) ** 2).mean()
    logits = (_unit(pooled) @ _unit(text).T) / temperature
    infonce = F.cross_entropy(logits, torch.arange(logits.shape[0], device=logits.device))
    return {"mse": mse, "infonce": infonce, "total": mse + infonce}


def diffusion_mse(predicted_noise: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return ((predicted_noise.float() - noise.float()) ** 2).mean()


def consistency_loss(routed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Adjacent-level smoothness over (early, mid, late) pooled tokens."""
    means = [routed[k].mean(dim=1).float() for k in ("early", "mid", "late")]
    total = 0.0
    for a, b in zip(means[:-1], means[1:]):
        total = total + torch.linalg.vector_norm(a - b, dim=-1).mean()
    return total / (len(means) - 1)


def alignment_loss(audio_tokens: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
    """1 - cosine(mean-pooled audio tokens, text embedding), batch-mean."""
    pooled = audio_tokens.mean(dim=1).float()
    return (1.0 - (_unit(pooled) * _unit(text_emb.float())).sum(-1)).mean()


def weighted_total(losses: Dict[str, torch.Tensor], weights: Dict[str, float]):
    total = 0.0
    for name, w in weights.items():
        if name in losses:
            total = total + w * losses[name]
    return total
