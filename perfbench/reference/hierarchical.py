"""Hierarchical audio conditioning stack, plain PyTorch: a frozen copy of the
program's ``models/condition/hierarchical.py`` arithmetic, float32, with
the control's rounding on its products (``plain.fq``).

CLAP embedding [B,512] -> 10 tokens soft-assigned to {foreground,
background, ambience} -> routed to the UNet's early/mid/late levels, and
projected to 77 CLIP-shaped tokens. Parameter names are the reference's
``ImprovedHierarchicalAudioEncoder`` names, as
``models/condition/convert.py::convert_hierarchical_encoder`` reads them.
Dropout (rate 0.1) sits where the JAX modules have it and is active only
with ``deterministic=False``, drawing its masks from the ``generator`` the
caller passes. ``return_all=True`` also returns the stage-2 regularisers
(``compute_condition_losses``) and the monitoring stats
(``assignment_stats``). ``HierarchicalAudioV4`` is the reference's legacy
rigid stack (a hard 5/3/2 token split), which ``models/condition/convert.py``
and ``export.py`` carry; no pipeline path runs it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.plain import Linear, device_constant, dropout, fq, mha

LEVELS = ("early", "mid", "late")
ROUTING_INIT = ((0.1, 0.3, 0.6), (0.2, 0.6, 0.2), (0.6, 0.3, 0.1))
DROPOUT = 0.1


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
        self.input_proj = Linear(dim, bottleneck_dim)
        self.norm1 = nn.LayerNorm(bottleneck_dim, eps=1e-5)
        self.qkv = Linear(bottleneck_dim, bottleneck_dim * 3)
        self.proj = Linear(bottleneck_dim, bottleneck_dim)
        self.norm2 = nn.LayerNorm(bottleneck_dim, eps=1e-5)
        self.mlp = nn.ModuleList([Linear(bottleneck_dim, hidden), nn.GELU(), nn.Identity(),
                                  Linear(hidden, bottleneck_dim)])
        self.output_proj = Linear(bottleneck_dim, dim)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(t):
            return dropout(t, DROPOUT, deterministic, generator)

        h0 = self.input_proj(x)
        q, k, v = self.qkv(self.norm1(h0)).chunk(3, dim=-1)
        h0 = h0 + drop(self.proj(mha(q, k, v, self.num_heads)))
        h = drop(self.mlp[3](drop(F.gelu(self.mlp[0](self.norm2(h0))))))
        return x + self.output_proj(h0 + h)


class SoftHierarchicalDecomposition(nn.Module):
    """CLAP [B,512] -> tokens [B,10,768] + soft level assignments [B,10,3]."""

    def __init__(self, cfg: ConditionConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.token_dim
        self.shared_mlp = nn.ModuleList([
            Linear(cfg.clap_dim, 512), nn.GELU(), nn.LayerNorm(512, eps=1e-5),
            nn.Identity(), Linear(512, d),
        ])
        self.token_offsets = nn.Parameter(torch.zeros(cfg.num_tokens, d))
        self.level_anchors = nn.Parameter(torch.zeros(cfg.num_levels, d))
        self.gating_head = nn.ModuleList([Linear(d, 10), nn.GELU(),
                                          Linear(10, cfg.num_levels)])
        self.cross_hierarchy_attn = CrossHierarchyAttention(
            d, cfg.hierarchy_heads, cfg.hierarchy_bottleneck, mlp_ratio=1.5)
        self.norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, audio_features: torch.Tensor, temperature,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        m = self.shared_mlp
        h = dropout(m[2](F.gelu(m[0](audio_features))), DROPOUT, deterministic, generator)
        tokens = m[4](h)[:, None, :] + self.token_offsets[None]
        similarity = torch.einsum(
            "bkd,ld->bkl", _l2_normalize(tokens.float()), _l2_normalize(self.level_anchors.float())
        ) * self.cfg.similarity_scale
        gate_logits = self.gating_head[2](F.gelu(self.gating_head[0](tokens)))
        logits = similarity + gate_logits.float()
        if not isinstance(temperature, torch.Tensor):  # a fill on the device, no host copy
            temperature = torch.full((), temperature, dtype=torch.float32, device=logits.device)
        temperature = torch.clamp(temperature.float(), min=0.1)
        assignments = torch.softmax(logits / temperature, dim=-1)
        tokens = self.norm(self.cross_hierarchy_attn(tokens, deterministic, generator))
        return tokens, {"assignments": assignments.to(tokens.dtype), "temperature": temperature}


class AdaptiveHierarchyWeights(nn.Module):
    """Per-sample softmax weights over the 3 levels (512->6->3 MLP)."""

    def __init__(self, in_dim: int, num_levels: int = 3, hidden_dim: int = 6):
        super().__init__()
        self.weight_network = nn.ModuleList([
            Linear(in_dim, hidden_dim), nn.GELU(), nn.LayerNorm(hidden_dim, eps=1e-5),
            Linear(hidden_dim, num_levels),
        ])

    def forward(self, audio_features: torch.Tensor) -> torch.Tensor:
        w = self.weight_network
        return torch.softmax(w[3](w[2](F.gelu(w[0](audio_features)))), dim=-1)


class LevelToUNetRouter(nn.Module):
    """Route tokens to the UNet's early/mid/late levels through a
    row-softmaxed 3x3 routing matrix and per-level sigmoid gates.

    The softmax and the sigmoids are the JAX package's formulas, op by op,
    in ``param_dtype``: the type the JAX program holds these parameters in
    (a bf16 pipeline's, set by ``AudioToImagePipeline``; fp32 by default).
    JAX computes them in that type, where the rest of the tower promotes
    to fp32, so a bf16 pipeline rounds each of their ops to bf16."""

    def __init__(self, cfg: ConditionConfig):
        super().__init__()
        self.routing_matrix = nn.Parameter(torch.tensor(ROUTING_INIT, dtype=torch.float32))
        self.level_gates = nn.ParameterDict({
            lvl: nn.Parameter(torch.full((1,), cfg.router_gate_init)) for lvl in LEVELS
        })
        self.param_dtype = torch.float32

    def forward(self, tokens: torch.Tensor, assignments: torch.Tensor,
                hierarchy_weights: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if hierarchy_weights is not None:
            assignments = assignments * hierarchy_weights[:, None, :]
            assignments = assignments / (assignments.sum(-1, keepdim=True) + 1e-8)
        m = self.routing_matrix.to(self.param_dtype)
        u = torch.exp(m - m.amax(dim=1, keepdim=True))  # jax.nn.softmax
        routing = assignments @ (u / u.sum(dim=1, keepdim=True)).to(assignments.dtype)
        out = {}
        for i, lvl in enumerate(LEVELS):
            g = self.level_gates[lvl].to(self.param_dtype)
            one = torch.ones_like(g)
            gate = (one / (one + torch.exp(-g))).to(tokens.dtype)  # jax.nn.sigmoid
            out[lvl] = tokens * routing[:, :, i:i + 1].to(tokens.dtype) * gate
        return out


class _PackedAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (row-stacked ``in_proj``),
    applied through the port's attention."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        out = mha(F.linear(fq(q_in), fq(wq), bq), F.linear(fq(kv_in), fq(wk), bk),
                  F.linear(fq(kv_in), fq(wv), bv),
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
            nn.LayerNorm(d_model, eps=1e-5), Linear(d_model, d_model * 2), nn.GELU(),
            nn.Identity(), Linear(d_model * 2, d_model),
        ])

    def forward(self, queries: torch.Tensor, keys_values: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(t):
            return dropout(t, DROPOUT, deterministic, generator)

        queries = queries + self.cross_attn(self.ln_q(queries), self.ln_kv(keys_values))
        f = self.ffn
        return queries + drop(f[4](drop(F.gelu(f[1](f[0](queries))))))


class AudioProjectionTransformer77(nn.Module):
    """Perceiver decoder: N audio tokens -> 77 CLIP-compatible tokens."""

    def __init__(self, cfg: ConditionConfig):
        super().__init__()
        n, e = cfg.num_output_tokens, cfg.projector_bottleneck
        self.audio_proj = Linear(cfg.token_dim, e)
        self.queries = nn.Parameter(torch.zeros(n, e))
        self.query_pos = nn.Parameter(torch.zeros(n, e))
        self.blocks = nn.ModuleList([PerceiverCrossBlock(e, cfg.projector_heads)
                                     for _ in range(cfg.projector_layers)])
        self.out_proj = Linear(e, cfg.token_dim)
        self.clip_pos_embed = nn.Parameter(torch.zeros(1, n, cfg.token_dim))
        self.out_norm = nn.LayerNorm(cfg.token_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        audio = self.audio_proj(x)
        q = (self.queries + self.query_pos)[None].expand(x.shape[0], -1, -1).to(audio.dtype)
        for blk in self.blocks:
            q = blk(q, audio, deterministic, generator)
        out = self.out_proj(q) + self.clip_pos_embed.to(audio.dtype)
        return self.out_norm(out)


class HierarchicalAudioEncoder(nn.Module):
    """Decomposer + adaptive weights + router + projector.

    ``forward(audio [B,512], temperature)`` -> tokens77 [B,77,768]; with
    ``return_all=True`` -> ``(tokens77, info)``, where info carries
    tokens_10, tokens_77, assignments, routed {early, mid, late},
    hierarchy_weights, losses, stats and temperature."""

    def __init__(self, cfg: ConditionConfig, use_adaptive_weights: bool = True):
        super().__init__()
        self.cfg = cfg
        self.decomposer = SoftHierarchicalDecomposition(cfg)
        self.adaptive_weights = (AdaptiveHierarchyWeights(cfg.clap_dim, cfg.num_levels)
                                 if use_adaptive_weights else None)
        self.router = LevelToUNetRouter(cfg)
        self.projector = AudioProjectionTransformer77(cfg)

    def forward(self, audio_features: torch.Tensor, temperature=2.0, *,
                return_all: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        tokens_10, info = self.decomposer(audio_features, temperature, deterministic, generator)
        weights = (None if self.adaptive_weights is None
                   else self.adaptive_weights(audio_features))
        routed = self.router(tokens_10, info["assignments"], weights)
        tokens_77 = self.projector(tokens_10, deterministic, generator)
        if not return_all:
            return tokens_77
        level_prior = tuple(self.cfg.level_prior)
        prior = device_constant(("level_prior", level_prior),
                                lambda _: np.asarray(level_prior, np.float32),
                                audio_features.device)
        return tokens_77, {
            "tokens_10": tokens_10,
            "tokens_77": tokens_77,
            "assignments": info["assignments"],
            "routed": routed,
            "hierarchy_weights": weights,
            "losses": compute_condition_losses(info["assignments"], tokens_10, prior),
            "stats": assignment_stats(info["assignments"]),
            "temperature": info["temperature"],
        }


def compute_condition_losses(assignments: torch.Tensor, tokens: torch.Tensor,
                             level_prior: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Stage-2 regularisers: mean assignment entropy, MSE of the token Gram
    matrix against the identity, and KL(level usage || prior), batch-mean."""
    a = assignments.float()
    entropy = -(a * torch.log(a + 1e-8)).sum(-1).mean()
    t_n = _l2_normalize(tokens.float())
    gram = torch.einsum("bkd,bjd->bkj", t_n, t_n)
    eye = torch.eye(tokens.shape[1], dtype=torch.float32, device=tokens.device)
    ortho = ((gram - eye[None]) ** 2).mean()
    avg = a.mean(dim=1)
    kl = (avg * (torch.log(avg + 1e-8) - torch.log(level_prior[None]))).sum(-1).mean()
    return {"entropy": entropy, "orthogonality": ortho, "prior": kl}


def assignment_stats(assignments: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Monitoring stats: mean assignment per level, entropy, exp(entropy)."""
    a = assignments.float()
    entropy = -(a * torch.log(a + 1e-8)).sum(-1).mean()
    return {"avg_assignment": a.mean(dim=(0, 1)), "entropy": entropy,
            "effective_levels": torch.exp(entropy)}
