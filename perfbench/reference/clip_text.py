"""CLIP ViT-L/14 text encoder, plain PyTorch: a frozen copy of the program's
``models/clip_text.py``.

12 layers, width 768, 12 heads, causal mask, quick-GELU, 77 tokens.
Parameter names are transformers' ``CLIPTextModel`` names without the
``text_model.`` prefix.
"""

from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.plain import Linear, mha


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d)
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)
        self.num_heads = cfg.num_heads

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        out = mha(self.q_proj(x), self.k_proj(x), self.v_proj(x), self.num_heads, mask=mask)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextEncoder(nn.Module):
    """``forward(input_ids [B,77]) -> last_hidden_state [B,77,768]``."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        # out-of-vocab ids wrap, as in the JAX package (reduced-vocab configs)
        x = self.embeddings.token_embedding(input_ids.long() % self.cfg.vocab_size)
        x = x + self.embeddings.position_embedding.weight[None, :s].to(x.dtype)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, None]
        for layer in self.encoder.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x)
