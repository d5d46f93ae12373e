"""Hierarchical audio conditioning stack (port of
``clap2diffusion_tpu/models/condition/hierarchical.py``, inference path).

CLAP embedding [B,512] -> 10 tokens soft-assigned to {foreground,
background, ambience} -> routed to the UNet's early/mid/late levels, and
projected to 77 CLIP-shaped tokens. Parameter names are the reference's
``ImprovedHierarchicalAudioEncoder`` names, as
``models/condition/convert.py::convert_hierarchical_encoder`` reads them.
Dropout slots are identities (inference only); the stage-2 losses and the
monitoring stats are training-side and not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from clap2diffusion_tpu_torch.core.config import ConditionConfig
from clap2diffusion_tpu_torch.ops.attention import mha

LEVELS = ("early", "mid", "late")
ROUTING_INIT = ((0.1, 0.3, 0.6), (0.2, 0.6, 0.2), (0.6, 0.3, 0.1))


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


class CrossHierarchyAttention(nn.Module):
    """Bottlenecked pre-norm self-attention + MLP over the token sequence."""

    def __init__(self, dim: int = 768, num_heads: int = 4, bottleneck_dim: int = 192,
                 mlp_ratio: float = 2.0):
        super().__init__()
        if bottleneck_dim % num_heads != 0:
            raise ValueError("bottleneck_dim must divide num_heads")
        hidden = int(bottleneck_dim * mlp_ratio)
        self.num_heads = num_heads
        self.input_proj = nn.Linear(dim, bottleneck_dim)
        self.norm1 = nn.LayerNorm(bottleneck_dim, eps=1e-5)
        self.qkv = nn.Linear(bottleneck_dim, bottleneck_dim * 3)
        self.proj = nn.Linear(bottleneck_dim, bottleneck_dim)
        self.norm2 = nn.LayerNorm(bottleneck_dim, eps=1e-5)
        self.mlp = nn.ModuleList([nn.Linear(bottleneck_dim, hidden), nn.GELU(), nn.Identity(),
                                  nn.Linear(hidden, bottleneck_dim)])
        self.output_proj = nn.Linear(bottleneck_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = self.input_proj(x)
        q, k, v = self.qkv(self.norm1(h0)).chunk(3, dim=-1)
        h0 = h0 + self.proj(mha(q, k, v, self.num_heads))
        h = self.mlp[3](F.gelu(self.mlp[0](self.norm2(h0))))
        return x + self.output_proj(h0 + h)


class SoftHierarchicalDecomposition(nn.Module):
    """CLAP [B,512] -> tokens [B,10,768] + soft level assignments [B,10,3]."""

    def __init__(self, cfg: ConditionConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.token_dim
        self.shared_mlp = nn.ModuleList([
            nn.Linear(cfg.clap_dim, 512), nn.GELU(), nn.LayerNorm(512, eps=1e-5),
            nn.Identity(), nn.Linear(512, d),
        ])
        self.token_offsets = nn.Parameter(torch.zeros(cfg.num_tokens, d))
        self.level_anchors = nn.Parameter(torch.zeros(cfg.num_levels, d))
        self.gating_head = nn.ModuleList([nn.Linear(d, 10), nn.GELU(),
                                          nn.Linear(10, cfg.num_levels)])
        self.cross_hierarchy_attn = CrossHierarchyAttention(
            d, cfg.hierarchy_heads, cfg.hierarchy_bottleneck, mlp_ratio=1.5)
        self.norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, audio_features: torch.Tensor, temperature):
        m = self.shared_mlp
        shared = m[4](m[2](F.gelu(m[0](audio_features))))
        tokens = shared[:, None, :] + self.token_offsets[None]
        similarity = torch.einsum(
            "bkd,ld->bkl", _l2_normalize(tokens.float()), _l2_normalize(self.level_anchors.float())
        ) * self.cfg.similarity_scale
        gate_logits = self.gating_head[2](F.gelu(self.gating_head[0](tokens)))
        logits = similarity + gate_logits.float()
        temperature = torch.clamp(torch.as_tensor(temperature, dtype=torch.float32,
                                                  device=logits.device), min=0.1)
        assignments = torch.softmax(logits / temperature, dim=-1)
        tokens = self.norm(self.cross_hierarchy_attn(tokens))
        return tokens, {"assignments": assignments.to(tokens.dtype), "temperature": temperature}


class AdaptiveHierarchyWeights(nn.Module):
    """Per-sample softmax weights over the 3 levels (512->6->3 MLP)."""

    def __init__(self, in_dim: int, num_levels: int = 3, hidden_dim: int = 6):
        super().__init__()
        self.weight_network = nn.ModuleList([
            nn.Linear(in_dim, hidden_dim), nn.GELU(), nn.LayerNorm(hidden_dim, eps=1e-5),
            nn.Linear(hidden_dim, num_levels),
        ])

    def forward(self, audio_features: torch.Tensor) -> torch.Tensor:
        w = self.weight_network
        return torch.softmax(w[3](w[2](F.gelu(w[0](audio_features)))), dim=-1)


class LevelToUNetRouter(nn.Module):
    """Route tokens to the UNet's early/mid/late levels through a
    row-softmaxed 3x3 routing matrix and per-level sigmoid gates."""

    def __init__(self, cfg: ConditionConfig):
        super().__init__()
        self.routing_matrix = nn.Parameter(torch.tensor(ROUTING_INIT, dtype=torch.float32))
        self.level_gates = nn.ParameterDict({
            lvl: nn.Parameter(torch.full((1,), cfg.router_gate_init)) for lvl in LEVELS
        })

    def forward(self, tokens: torch.Tensor, assignments: torch.Tensor,
                hierarchy_weights: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if hierarchy_weights is not None:
            assignments = assignments * hierarchy_weights[:, None, :]
            assignments = assignments / (assignments.sum(-1, keepdim=True) + 1e-8)
        routing = assignments @ torch.softmax(self.routing_matrix, dim=1)
        return {
            lvl: tokens * routing[:, :, i:i + 1].to(tokens.dtype)
            * torch.sigmoid(self.level_gates[lvl]).to(tokens.dtype)
            for i, lvl in enumerate(LEVELS)
        }


class _PackedAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (row-stacked ``in_proj``),
    applied through the port's attention."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        out = mha(F.linear(q_in, wq, bq), F.linear(kv_in, wk, bk), F.linear(kv_in, wv, bv),
                  self.num_heads)
        return self.out_proj(out)


class PerceiverCrossBlock(nn.Module):
    """Pre-norm cross-attention + 2x FFN block in the projector bottleneck."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.ln_q = nn.LayerNorm(d_model, eps=1e-5)
        self.ln_kv = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = _PackedAttention(d_model, num_heads)
        self.ffn = nn.ModuleList([
            nn.LayerNorm(d_model, eps=1e-5), nn.Linear(d_model, d_model * 2), nn.GELU(),
            nn.Identity(), nn.Linear(d_model * 2, d_model),
        ])

    def forward(self, queries: torch.Tensor, keys_values: torch.Tensor) -> torch.Tensor:
        queries = queries + self.cross_attn(self.ln_q(queries), self.ln_kv(keys_values))
        f = self.ffn
        return queries + f[4](F.gelu(f[1](f[0](queries))))


class AudioProjectionTransformer77(nn.Module):
    """Perceiver decoder: N audio tokens -> 77 CLIP-compatible tokens."""

    def __init__(self, cfg: ConditionConfig):
        super().__init__()
        n, e = cfg.num_output_tokens, cfg.projector_bottleneck
        self.audio_proj = nn.Linear(cfg.token_dim, e)
        self.queries = nn.Parameter(torch.zeros(n, e))
        self.query_pos = nn.Parameter(torch.zeros(n, e))
        self.blocks = nn.ModuleList([PerceiverCrossBlock(e, cfg.projector_heads)
                                     for _ in range(cfg.projector_layers)])
        self.out_proj = nn.Linear(e, cfg.token_dim)
        self.clip_pos_embed = nn.Parameter(torch.zeros(1, n, cfg.token_dim))
        self.out_norm = nn.LayerNorm(cfg.token_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        audio = self.audio_proj(x)
        q = (self.queries + self.query_pos)[None].expand(x.shape[0], -1, -1).to(audio.dtype)
        for blk in self.blocks:
            q = blk(q, audio)
        out = self.out_proj(q) + self.clip_pos_embed.to(audio.dtype)
        return self.out_norm(out)


class HierarchicalAudioEncoder(nn.Module):
    """Decomposer + adaptive weights + router + projector.

    ``forward(audio [B,512], temperature)`` -> tokens77 [B,77,768]; with
    ``return_all=True`` -> ``(tokens77, info)``, where info carries
    tokens_10, tokens_77, assignments, routed {early, mid, late},
    hierarchy_weights and temperature."""

    def __init__(self, cfg: ConditionConfig, use_adaptive_weights: bool = True):
        super().__init__()
        self.decomposer = SoftHierarchicalDecomposition(cfg)
        self.adaptive_weights = (AdaptiveHierarchyWeights(cfg.clap_dim, cfg.num_levels)
                                 if use_adaptive_weights else None)
        self.router = LevelToUNetRouter(cfg)
        self.projector = AudioProjectionTransformer77(cfg)

    def forward(self, audio_features: torch.Tensor, temperature=2.0, *,
                return_all: bool = False):
        tokens_10, info = self.decomposer(audio_features, temperature)
        weights = (None if self.adaptive_weights is None
                   else self.adaptive_weights(audio_features))
        routed = self.router(tokens_10, info["assignments"], weights)
        tokens_77 = self.projector(tokens_10)
        if not return_all:
            return tokens_77
        return tokens_77, {
            "tokens_10": tokens_10,
            "tokens_77": tokens_77,
            "assignments": info["assignments"],
            "routed": routed,
            "hierarchy_weights": weights,
            "temperature": info["temperature"],
        }
