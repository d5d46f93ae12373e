"""Audio adapter: CLAP [B,512] -> 16 tokens [B,16,768] (port of
``clap2diffusion_tpu/models/condition/adapter.py``, the stage-1 and
stage-3 tower).

16 learned queries plus positional embeddings; a low-rank MLP
(512->256->2*768*16) generates per-token K and V from the one CLAP vector;
one single-head cross-attention scaled by the full width's D^-0.5, then 4
pre-norm self-attention layers and a projection + LayerNorm. Parameter
names are the reference's ``AudioAdapter`` names, as
``models/condition/convert.py::convert_audio_adapter`` reads them. Dropout
(0.1) after the KV MLP's GELU and after each self-attention output is
active only with ``deterministic=False`` and draws from the caller's
``generator``. The pipeline's ``sonic`` model type injects its tokens
(Norm-60) at every level. ``GatedAudioCrossAttention`` is the reference's
standalone gated cross-attention layer; no pipeline path reaches it, in
either package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from clap2diffusion_tpu_torch.core.config import ConditionConfig
from clap2diffusion_tpu_torch.models.layers import dropout
from clap2diffusion_tpu_torch.ops.attention import mha

DROPOUT = 0.1


class AudioSelfAttention(nn.Module):
    """Bias-free QKV self-attention; ``to_out`` is (Linear, Dropout)."""

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.to_qkv = nn.Linear(hidden_dim, hidden_dim * 3, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(hidden_dim, hidden_dim), nn.Identity()])

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        out = self.to_out[0](mha(q, k, v, self.num_heads))
        return dropout(out, DROPOUT, deterministic, generator)


class AudioTokenGenerator(nn.Module):
    """CLAP vector -> refined audio token sequence. The learned queries and
    their positions are summed in ``param_dtype`` (a bf16 pipeline's, set
    by ``AudioToImagePipeline``; fp32 by default), as the JAX program sums
    the two parameters in their own type before the fp32 compute."""

    def __init__(self, cfg: ConditionConfig):
        super().__init__()
        n, d = cfg.num_adapter_tokens, cfg.token_dim
        self.audio_queries = nn.Parameter(torch.zeros(n, d))
        self.pos_embed = nn.Parameter(torch.zeros(n, d))
        self.audio_to_kv = nn.ModuleList([
            nn.Linear(cfg.clap_dim, cfg.adapter_kv_hidden), nn.GELU(), nn.Identity(),
            nn.Linear(cfg.adapter_kv_hidden, d * 2 * n),
        ])
        self.layer_norms = nn.ModuleList([nn.LayerNorm(d, eps=1e-5)
                                          for _ in range(cfg.adapter_self_attn_layers)])
        self.self_attn_layers = nn.ModuleList([AudioSelfAttention(d, cfg.adapter_heads)
                                               for _ in range(cfg.adapter_self_attn_layers)])
        self.output_proj = nn.ModuleList([nn.Linear(d, d), nn.LayerNorm(d, eps=1e-5)])
        self.param_dtype = torch.float32

    def forward(self, audio_embedding: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b = audio_embedding.shape[0]
        n, d = self.audio_queries.shape
        qp = self.audio_queries.to(self.param_dtype) + self.pos_embed.to(self.param_dtype)
        q = qp[None].expand(b, n, d).to(audio_embedding.dtype)
        kv = self.audio_to_kv
        h = dropout(F.gelu(kv[0](audio_embedding)), DROPOUT, deterministic, generator)
        kv = kv[3](h).reshape(b, n, 2, d)
        k, v = kv[:, :, 0], kv[:, :, 1]
        scores = torch.einsum("bnd,bmd->bnm", q, k).float() * d ** -0.5
        attn = torch.softmax(scores, dim=-1).to(q.dtype)
        tokens = torch.einsum("bnm,bmd->bnd", attn, v) + q
        for ln, sa in zip(self.layer_norms, self.self_attn_layers):
            tokens = sa(ln(tokens), deterministic, generator) + tokens
        return self.output_proj[1](self.output_proj[0](tokens))


class AudioAdapter(nn.Module):
    """The stage-1 tower: a thin wrapper over the token generator."""

    def __init__(self, cfg: ConditionConfig):
        super().__init__()
        self.token_generator = AudioTokenGenerator(cfg)

    def forward(self, audio_embedding: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.token_generator(audio_embedding, deterministic, generator)


class GatedAudioCrossAttention(nn.Module):
    """Standalone post-text gated cross-attention:
    ``residual + sigmoid(gate) * attn(LN(x), audio)``, with the gate
    initialised to -5 so that the audio starts near silent. ``mask`` is
    boolean, True where attention is allowed."""

    def __init__(self, query_dim: int, context_dim: int = 768, heads: int = 8,
                 dim_head: int = 64, gate_init: float = -5.0):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm = nn.LayerNorm(query_dim, eps=1e-5)
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)
        self.gate = nn.Parameter(torch.full((1,), float(gate_init)))

    def forward(self, hidden_states: torch.Tensor, audio_context: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm(hidden_states)
        out = mha(self.to_q(x), self.to_k(audio_context), self.to_v(audio_context), self.heads,
                  mask=mask)
        out = self.to_out(out)
        return hidden_states + torch.sigmoid(self.gate).to(out.dtype) * out
