"""CLAP text tower: RoBERTa encoder, CLS pooler and projection (port of
``clap2diffusion_tpu/models/clap/text.py``).

laion/clap-htsat-unfused's text side: RoBERTa base (50,265 ids, 514
positions, pad id 1, 12 layers, 768 wide), a dense + tanh pooler on the
first token, a 768 -> 512 -> relu -> 512 projection and L2 normalisation.
Parameter names are HF ``ClapModel``'s (``text_model.*``,
``text_projection.*``). Attention is the plain matmul path with a padding
mask, as the JAX tower calls ``mha`` without ``use_flash``. The tower
computes in its parameters' type.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from clap2diffusion_tpu_torch.core.config import CLAPTextConfig
from clap2diffusion_tpu_torch.ops.attention import mha


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query, self.key, self.value = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)


class _DenseNorm(nn.Module):
    def __init__(self, cin: int, d: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(cin, d)
        self.LayerNorm = nn.LayerNorm(d, eps=eps)


class _Attention(nn.Module):
    def __init__(self, cfg: CLAPTextConfig):
        super().__init__()
        self.self = _SelfAttention(cfg.hidden_size)
        self.output = _DenseNorm(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps)


class _Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dense = nn.Linear(cin, cout)


class RobertaLayer(nn.Module):
    def __init__(self, cfg: CLAPTextConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _DenseNorm(cfg.intermediate_size, cfg.hidden_size, cfg.layer_norm_eps)
        self.num_heads = cfg.num_heads

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        a = self.attention
        attn = mha(a.self.query(x), a.self.key(x), a.self.value(x), self.num_heads, mask=mask)
        x = a.output.LayerNorm(x + a.output.dense(attn))
        h = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + h)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLAPTextConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLAPTextConfig):
        super().__init__()
        self.layer = nn.ModuleList([RobertaLayer(cfg) for _ in range(cfg.num_layers)])


class _TextModel(nn.Module):
    def __init__(self, cfg: CLAPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.pooler = _Dense(cfg.hidden_size, cfg.hidden_size)


class _Projection(nn.Module):
    def __init__(self, cin: int, d: int):
        super().__init__()
        self.linear1 = nn.Linear(cin, d)
        self.linear2 = nn.Linear(d, d)


class ClapTextTower(nn.Module):
    """``forward(input_ids [B,S], attention_mask [B,S] | None) -> [B,512]``,
    L2-normalised."""

    def __init__(self, cfg: CLAPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextModel(cfg)
        self.text_projection = _Projection(cfg.hidden_size, cfg.projection_dim)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c, m = self.cfg, self.text_model
        ids = input_ids.long()
        if attention_mask is None:
            attention_mask = (ids != c.pad_token_id).long()
        mask = attention_mask.long()
        # RoBERTa position ids: the running count of non-pad tokens + pad id
        positions = torch.cumsum(mask, dim=1) * mask + c.pad_token_id
        ids = ids % c.vocab_size  # out-of-vocab ids wrap, as in the JAX tower
        e = m.embeddings
        x = (e.word_embeddings(ids) + e.position_embeddings(positions)
             + e.token_type_embeddings(torch.zeros_like(ids)))
        x = e.LayerNorm(x)
        attn_mask = mask[:, None, None, :].bool()
        for layer in m.encoder.layer:
            x = layer(x, attn_mask)
        pooled = torch.tanh(m.pooler.dense(x[:, 0]))
        p = self.text_projection
        h = p.linear2(F.relu(p.linear1(pooled)))
        h32 = h.float()
        return (h32 / torch.linalg.vector_norm(h32, dim=-1, keepdim=True)).to(h.dtype)
