"""HTSAT (Swin-transformer audio tower) of CLAP (port of
``clap2diffusion_tpu/models/clap/htsat.py``).

log-mel [B,T,64] -> per-mel-bin batchnorm (inference statistics) ->
256x256 "image" (bicubic time resize 1001->1024 as a matrix, then the
HTSAT 4-way frequency stacking) -> 4x4 patch embed (96) -> 4 Swin stages
(depths 2,2,6,2 / heads 4,8,16,32 / window 8, shifted on odd layers,
relative position bias) with patch merging -> LN -> mean pool -> 512-d
projection MLP -> L2 normalise. Parameter names are HF ``ClapModel``'s
(``audio_encoder.*``, ``audio_projection.*``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clap2diffusion_tpu_torch.core.config import HTSATConfig


@functools.lru_cache(maxsize=None)
def relative_position_index(window: int) -> np.ndarray:
    """Swin relative position index [w*w, w*w] into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(height: int, width: int, window: int, shift: int) -> np.ndarray:
    """Additive attention mask [num_windows, w*w, w*w] for SW-MSA (0 / -100)."""
    img = np.zeros((height, width), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = (img.reshape(height // window, window, width // window, window)
           .transpose(0, 2, 1, 3).reshape(-1, window * window))
    return np.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def bicubic_resize_matrix(in_len: int, out_len: int, a: float = -0.75) -> np.ndarray:
    """[out_len, in_len] matrix of a 1-D bicubic resize with
    align_corners=True (F.interpolate semantics, Keys kernel a=-0.75)."""

    def kernel(x):
        x = np.abs(x)
        return np.where(
            x <= 1.0, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
            np.where(x < 2.0, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a, 0.0),
        )

    mat = np.zeros((out_len, in_len), dtype=np.float64)
    if out_len == 1:
        mat[0, 0] = 1.0
        return mat.astype(np.float32)
    scale = (in_len - 1) / (out_len - 1)
    for i in range(out_len):
        x = i * scale
        base = int(np.floor(x))
        for tap in range(-1, 3):
            j = base + tap
            mat[i, min(max(j, 0), in_len - 1)] += kernel(x - j)
    return mat.astype(np.float32)


_CONSTANTS = {}


def _constant(fn, args, device) -> torch.Tensor:
    key = (fn.__name__, args, device)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.from_numpy(fn(*args)).to(device)
    return _CONSTANTS[key]


class _Dense(nn.Module):
    """Holds a Linear under the name ``dense`` (HF's module layout)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dense = nn.Linear(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)


class WindowSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))


class WindowAttention(nn.Module):
    """W-MSA with relative position bias; ``self`` and ``output.dense``
    are HF's names."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.self = WindowSelfAttention(dim, num_heads, window)
        self.output = _Dense(dim, dim)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        nwb, ww, c = x.shape
        hd = self.dim // self.num_heads
        sa = self.self

        def heads(t):
            return t.view(nwb, ww, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(sa.query(x)), heads(sa.key(x)), heads(sa.value(x))
        logits = torch.matmul(q, k.transpose(-1, -2)).float() / np.sqrt(hd)
        idx = _constant(relative_position_index, (self.window,), x.device).reshape(-1)
        bias = sa.relative_position_bias_table[idx].view(ww, ww, self.num_heads).permute(2, 0, 1)
        logits = logits + bias[None].float()
        if mask is not None:
            nw = mask.shape[0]
            logits = (logits.view(nwb // nw, nw, self.num_heads, ww, ww)
                      + mask[None, :, None]).view(nwb, self.num_heads, ww, ww)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(nwb, ww, self.dim)
        return self.output(out)


class SwinLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, resolution: Tuple[int, int], window: int,
                 shift: int, mlp_ratio: float, eps: float):
        super().__init__()
        if min(resolution) <= window:
            window, shift = min(resolution), 0
        self.resolution, self.window, self.shift = resolution, window, shift
        self.layernorm_before = nn.LayerNorm(dim, eps=eps)
        self.attention = WindowAttention(dim, num_heads, window)
        self.layernorm_after = nn.LayerNorm(dim, eps=eps)
        self.intermediate = _Dense(dim, int(dim * mlp_ratio))
        self.output = _Dense(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (hr, wr), w, s = self.resolution, self.window, self.shift
        b, seq, c = x.shape
        y = self.layernorm_before(x).view(b, hr, wr, c)
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = y.view(b, hr // w, w, wr // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)
        mask = (_constant(shifted_window_mask, (hr, wr, w, s), x.device) if s > 0 else None)
        y = self.attention(y, mask)
        y = y.view(b, hr // w, wr // w, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hr, wr, c)
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y.reshape(b, seq, c)
        return x + self.output(F.gelu(self.intermediate(self.layernorm_after(x))))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, resolution: Tuple[int, int], eps: float):
        super().__init__()
        self.resolution = resolution
        self.norm = nn.LayerNorm(4 * dim, eps=eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hr, wr = self.resolution
        b, _, c = x.shape
        x = x.view(b, hr, wr, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1).reshape(b, (hr // 2) * (wr // 2), 4 * c)
        return self.reduction(self.norm(x))


class _Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class _MelBatchNorm(nn.Module):
    """BatchNorm over the mel axis with inference statistics (HF's
    ``batch_norm`` parameter and buffer names)."""

    def __init__(self, f: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(f))
        self.bias = nn.Parameter(torch.zeros(f))
        self.register_buffer("running_mean", torch.zeros(f))
        self.register_buffer("running_var", torch.ones(f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ((x - self.running_mean) * torch.rsqrt(self.running_var + 1e-5) * self.weight
                + self.bias)


class _PatchEmbed(nn.Module):
    def __init__(self, c: HTSATConfig):
        super().__init__()
        self.proj = nn.Conv2d(1, c.patch_embed_dim, c.patch_size, stride=c.patch_stride)
        self.norm = nn.LayerNorm(c.patch_embed_dim, eps=c.layer_norm_eps)


class HTSATEncoder(nn.Module):
    """log-mel [B, T, F] -> pooled hidden [B, 768]."""

    def __init__(self, cfg: HTSATConfig):
        super().__init__()
        c = self.cfg = cfg
        self.batch_norm = _MelBatchNorm(c.num_mel_bins)
        self.patch_embed = _PatchEmbed(c)
        res = (c.spec_size // c.patch_stride[0], c.spec_size // c.patch_stride[1])
        self.grid = res
        dim, stages = c.patch_embed_dim, []
        for s, (depth, heads) in enumerate(zip(c.depths, c.num_heads)):
            blocks = [SwinLayer(dim, heads, res, c.window_size,
                                0 if i % 2 == 0 else c.window_size // 2, c.mlp_ratio,
                                c.layer_norm_eps) for i in range(depth)]
            down = None
            if s < len(c.depths) - 1:
                down = PatchMerging(dim, res, c.layer_norm_eps)
                res, dim = (res[0] // 2, res[1] // 2), dim * 2
            stages.append(_Stage(blocks, down))
        self.layers = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(dim, eps=c.layer_norm_eps)

    def forward(self, log_mel: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, t, f = log_mel.shape
        ratio = c.spec_size // c.num_mel_bins
        x = self.batch_norm(log_mel)
        width = c.spec_size * ratio
        if t != width:
            interp = _constant(bicubic_resize_matrix, (t, width), x.device).to(x.dtype)
            x = torch.einsum("ot,btf->bof", interp, x)
        x = x.reshape(b, ratio, width // ratio, f).transpose(2, 3).reshape(b, ratio * f,
                                                                             width // ratio)
        pe = self.patch_embed
        h = pe.proj(x[:, None]).permute(0, 2, 3, 1)
        h = pe.norm(h.reshape(b, self.grid[0] * self.grid[1], c.patch_embed_dim))
        for stage in self.layers:
            for blk in stage.blocks:
                h = blk(h)
            if stage.downsample is not None:
                h = stage.downsample(h)
        return self.norm(h).mean(dim=1)


class _Projection(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear1 = nn.Linear(cin, dim)
        self.linear2 = nn.Linear(dim, dim)


class ClapAudioTower(nn.Module):
    """HTSAT + 2-layer projection + L2 normalise -> [B, 512]."""

    def __init__(self, cfg: HTSATConfig):
        super().__init__()
        self.audio_encoder = HTSATEncoder(cfg)
        self.audio_projection = _Projection(self.audio_encoder.norm.normalized_shape[0],
                                            cfg.projection_dim)

    def forward(self, log_mel: torch.Tensor) -> torch.Tensor:
        pooled = self.audio_encoder(log_mel)
        p = self.audio_projection
        h = p.linear2(F.relu(p.linear1(pooled)))
        h32 = h.float()
        return (h32 / torch.linalg.vector_norm(h32, dim=-1, keepdim=True)).to(h.dtype)
