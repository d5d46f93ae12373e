"""What the work counts of every family share. A family's
``request_work`` and ``micro_step_work`` (``perfbench/families``) count
the work of a request or a micro-step once at set-up from the cell's
shapes on the benchmark's own reference models, on the meta device: never
from the program's kernels, so that it reads the same whatever implements
them.

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


def itemsize(dtype_name: str) -> int:
    return int(np.dtype({"bfloat16": "float16"}.get(dtype_name, dtype_name)).itemsize)
