"""The work of a request or a micro-step, counted once at set-up from the
cell's shapes on the benchmark's own reference models, on the meta device:
never from the program's kernels, so that it reads the same whatever
implements them.

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the reference
  (matmuls, convolutions and the attention products).
- Attention: every ``softmax(q k^T) v`` the reference computes with at
  least 256 queries, at least 128 keys and no mask (the long
  self-attentions of the UNet and the VAE), as (batch, heads, queries,
  keys, head width). Forward FLOPs 4 b h sq sk d; backward 8 b h sq sk d
  (the four products of dq, dk, dv and dp); bytes of q, k, v and the
  output (forward) and of q, k, v, o, do, dq, dk, dv (backward), each read
  or written once, in the served type.
- GroupNorm: the elements of each call's input, read once and written
  once, in the served type.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import plain


# mean, variance, normalise, scale and shift, SiLU: about 8 operations an element
GN_OPS_PER_ELEMENT = 8


class Recorder:
    def __init__(self):
        self.attention: List[tuple] = []
        self.groupnorm: List[int] = []


@contextlib.contextmanager
def recording():
    rec = Recorder()
    attn, gn = plain.dot_product_attention, plain.GroupNorm.forward

    def attention(q, k, v, *, scale=None, mask=None):
        if mask is None and q.shape[-2] >= 256 and k.shape[-2] >= 128:
            rec.attention.append((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]))
        return attn(q, k, v, scale=scale, mask=mask)

    def groupnorm(self, x):
        rec.groupnorm.append(x.numel())
        return gn(self, x)

    plain.dot_product_attention = attention
    plain.GroupNorm.forward = groupnorm
    try:
        yield rec
    finally:
        plain.dot_product_attention = attn
        plain.GroupNorm.forward = gn


def attention_work(rec: Recorder, itemsize: int) -> Dict[str, float]:
    fwd_f = sum(4 * b * h * sq * sk * d for b, h, sq, sk, d in rec.attention)
    fwd_b = sum(b * h * (2 * sq * d + 2 * sk * d) * itemsize for b, h, sq, sk, d in rec.attention)
    bwd_f = 2 * fwd_f
    bwd_b = sum(b * h * (4 * sq * d + 4 * sk * d) * itemsize
                for b, h, sq, sk, d in rec.attention)
    return {"attn_fwd_flops": float(fwd_f), "attn_fwd_bytes": float(fwd_b),
            "attn_bwd_flops": float(bwd_f), "attn_bwd_bytes": float(bwd_b),
            "attn_calls": len(rec.attention)}


def _meta_reference(cfg, towers):
    from perfbench.harness.weights import build_reference

    with torch.device("meta"):
        mods = build_reference(cfg)
    return {t: mods[t].eval().requires_grad_(False) for t in towers}


def request_work(cfg, batch: int, steps: int, itemsize: int) -> Dict[str, float]:
    """One served request of ``batch`` images: CLAP, the hierarchical
    encoder, CLIP text over the prompt and the negative, ``steps`` UNet
    forwards at CFG batch 2 * batch, the VAE decode."""
    from perfbench.reference.frontend import log_mel_spectrogram

    m = _meta_reference(cfg, ("clap_audio", "clip_text", "hierarchical", "unet", "vae"))
    fe, d = cfg.clap.frontend, cfg.diffusion
    lat = d.image_size // 8
    out = {}
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter, recording() as once:
        wav = torch.zeros(batch, int(fe.sample_rate * fe.duration_s), device="meta")
        emb = m["clap_audio"](log_mel_spectrogram(wav, fe))
        _, info = m["hierarchical"](emb, 0.5, return_all=True)
        ctx = m["clip_text"](torch.zeros(2 * batch, d.clip_text.max_length, dtype=torch.long,
                                         device="meta"))
        m["vae"].decode_latent(torch.zeros(batch, lat, lat, 4, device="meta"))
    base = counter.get_total_flops()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter, recording() as step:
        audio = {k: torch.cat([v, v]) for k, v in info["routed"].items()}
        m["unet"](torch.zeros(2 * batch, lat, lat, 4, device="meta"),
                  torch.zeros(2 * batch, dtype=torch.long, device="meta"), ctx, audio)
    out["flops"] = float(base + steps * counter.get_total_flops())
    rec = Recorder()
    rec.attention = once.attention + steps * step.attention
    rec.groupnorm = once.groupnorm + steps * step.groupnorm
    out.update(attention_work(rec, itemsize))
    out["gn_bytes"] = float(2 * itemsize * sum(rec.groupnorm))
    out["gn_flops"] = float(GN_OPS_PER_ELEMENT * sum(rec.groupnorm))
    out["gn_calls"] = len(rec.groupnorm)
    return out


def micro_step_work(cfg, scfg, batch: int, itemsize: int) -> Dict[str, float]:
    """One stage-2 micro-step of ``batch`` samples: the frozen CLAP and CLIP
    text forwards, the hierarchical encoder and the UNet forward, and the
    backward that the trainable leaves need."""
    from perfbench.reference.frontend import log_mel_spectrogram
    from perfbench.reference.pipeline import stage2_trainable

    m = _meta_reference(cfg, ("clap_audio", "clip_text", "hierarchical", "unet"))
    for tower in ("hierarchical", "unet"):
        for n, p in m[tower].named_parameters():
            p.requires_grad_(stage2_trainable(f"{tower}.{n}"))
    fe, d = cfg.clap.frontend, cfg.diffusion
    lat = d.image_size // 8
    counter = FlopCounterMode(display=False)
    with counter, recording() as rec:
        with torch.no_grad():
            wav = torch.zeros(batch, int(fe.sample_rate * fe.duration_s), device="meta")
            emb = m["clap_audio"](log_mel_spectrogram(wav, fe))
            ctx = m["clip_text"](torch.zeros(batch, d.clip_text.max_length, dtype=torch.long,
                                             device="meta"))
        _, info = m["hierarchical"](emb, 2.0, return_all=True)
        eps = m["unet"](torch.zeros(batch, lat, lat, 4, device="meta"),
                        torch.zeros(batch, dtype=torch.long, device="meta"), ctx, info["routed"])
        loss = (eps.float() ** 2).mean() + info["losses"]["orthogonality"]
        leaves = [p for t in ("hierarchical", "unet") for p in m[t].parameters()
                  if p.requires_grad]
        torch.autograd.grad(loss, leaves, allow_unused=True)
    out = {"flops": float(counter.get_total_flops())}
    out.update(attention_work(rec, itemsize))
    out["gn_bytes"] = float(2 * itemsize * sum(rec.groupnorm))
    return out


def itemsize(dtype_name: str) -> int:
    return int(np.dtype({"bfloat16": "float16"}.get(dtype_name, dtype_name)).itemsize)
