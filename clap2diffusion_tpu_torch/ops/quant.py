"""W8A8 int8 serving (``C2D_INT8=1``; port of
``clap2diffusion_tpu/ops/quant.py``), serve only.

The recipe is the JAX package's:

- **Weights:** int8 with one symmetric absmax/127 scale per output channel,
  floored at 1e-8 (``quantize_weight``).
- **Activations:** int8 with one dynamic absmax/127 scale per tensor
  (``quantize_dynamic``).
- Rounding half to even (``torch.round``, as ``jnp.round``), clipped to
  +-127. The products accumulate exactly in int32. The result is
  dequantised as ``y.float() * (sx * sw)`` (the scalar times the vector
  first), the bias is added in fp32, and the sum is cast to x's type.

The JAX package computes the products with ``lax.dot_general`` and
``lax.conv_general_dilated`` at ``preferred_element_type=int32``, outside
any Pallas kernel; here they are ``torch._int_mm`` (cuBLASLt's int8 GEMM on
the card). ``int8_conv`` (3x3, stride 1, SAME, NHWC) is an im2col of the
int8 activations, built in int8, into the same product. On CUDA,
``_int_mm`` wants more than 16 rows (fewer are padded with zero rows, which
is exact) and K and N multiples of 8; a shape it refuses raises, and
nothing falls back to the fp path. Every division has a tensor on the
operand's device as its divisor, so that the card divides as the CPU does
(PyTorch's CUDA division by a host scalar multiplies by its reciprocal
instead): the card's results equal the CPU's bit for bit.

The weights are quantised once, not once per step: the JAX package
quantises them at trace time and XLA hoists that out of the sampler's
scan. ``QuantCache`` keeps a module's int8 weights and scales, keyed on the
weight's identity, storage, ``_version`` and type, so that
``load_state_dict``, a LoRA merge or a ``.to()`` quantises again. A
captured request (``diffusion/program.py``) does not call ``QuantCache`` at
replay: ``Programs`` sees the same weight changes and captures again, which
quantises again.

``run_stage`` refuses ``C2D_INT8=1``: ``torch.round`` has no useful
gradient. The UNet's sites are the JAX package's (``models/unet.py``).

Counter: ``int8_gemm.calls`` counts the int8 products run (``_int_mm``
calls), in the registry of ``ops/counters.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from clap2diffusion_tpu_torch.core.device import device_constant
from clap2diffusion_tpu_torch.ops import counters


def enabled() -> bool:
    """True when the user opted into int8 serving (``C2D_INT8=1``)."""
    return os.environ.get("C2D_INT8") == "1"


# Narrow layers stay fp (conv_in 4->320, conv_out ->4); tests monkeypatch
# this to reach the int8 path at tiny widths.
INT8_MIN_WIDTH = 128


def eligible(*widths: int) -> bool:
    """True when every feature width is wide enough for the int8 path."""
    return enabled() and min(widths) >= INT8_MIN_WIDTH


def conv_eligible(*widths: int) -> bool:
    """The gate of the 3x3 convs; ``C2D_INT8_CONV=0`` keeps them fp while
    the matmuls quantise."""
    return eligible(*widths) and os.environ.get("C2D_INT8_CONV", "1") != "0"


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` with the divisor as a tensor on a's device: a true
    division on the card too. The divisor is made once per device, by a
    fill on the device."""
    return a / device_constant(
        ("divisor", b), lambda dev: torch.full((), b, dtype=torch.float32, device=dev), a.device)


def quantize_weight(w: torch.Tensor, out_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp weight -> (int8 weight, fp32 scale per index of ``out_axis``)."""
    wf = w.float()
    reduce = [i for i in range(w.dim()) if i != out_axis]
    scale = torch.clamp_min(_div(wf.abs().amax(dim=reduce), 127.0), 1e-8)
    shape = [1] * w.dim()
    shape[out_axis] = -1
    wi = torch.round(wf / scale.reshape(shape))
    return torch.clamp(wi, -127, 127).to(torch.int8), scale


def quantize_dynamic(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Activation -> (int8 tensor, 0-dim fp32 scale on x's device),
    symmetric per tensor; no host synchronisation."""
    xf = x.float()
    scale = torch.clamp_min(_div(xf.abs().amax(), 127.0), 1e-8)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


class _Counter:
    def __init__(self):
        self.calls = 0

    def reset(self) -> None:
        self.calls = 0


int8_gemm = _Counter()
counters.register(int8_gemm, "calls", name="int8_gemm")


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact. On CUDA, M <= 16
    is padded with zero rows (``_int_mm`` wants more than 16), and ``b`` is
    best given column-major (an [N, K] weight's ``.t()``)."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros(17 - m, a.shape[1])])
    int8_gemm.calls += 1
    return torch._int_mm(a, b)[:m]


def dequantize(y: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
               bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """int32 products -> ``dtype``: ``y * (sx * sw)`` in fp32, the bias in
    fp32 after it, then the cast."""
    out = y.float() * (sx * sw)
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def linear_q(x: torch.Tensor, xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
             sw: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 product of an activation already quantised (``xq``, ``sx``)
    with an int8 weight [N, K] and its scales, in x's type and shape."""
    y = int_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
    return dequantize(y, sx, sw, bias, x.dtype).reshape(*x.shape[:-1], wq.shape[0])


def int8_matmul(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 ``F.linear(x, weight, bias)``: ``weight`` is the fp [N, K]
    torch weight (the JAX function's [K, N] kernel, transposed), quantised
    per output row; returns x's type."""
    wq, sw = quantize_weight(weight, out_axis=0)
    xq, sx = quantize_dynamic(x)
    return linear_q(x, xq, sx, wq, sw, bias)


def im2col3x3(xq: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B*H*W, 9*C] patches of the zero-padded input
    (3x3, stride 1, SAME), in xq's type, ordered (kh, kw, c)."""
    b, h, w, c = xq.shape
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, i:i + h, j:j + w] for i in range(3) for j in range(3)]
    return torch.cat(cols, dim=-1).reshape(b * h * w, 9 * c)


def conv_weight_q(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A conv weight [O, I, 3, 3] -> (int8 [O, 9*I] in im2col's (kh, kw, c)
    order, fp32 scale [O])."""
    wq, sw = quantize_weight(weight, out_axis=0)
    return wq.permute(0, 2, 3, 1).reshape(weight.shape[0], -1).contiguous(), sw


def conv_q(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
           bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The int8 3x3 conv of NHWC x with an int8 weight from
    ``conv_weight_q``; returns x's type."""
    b, h, w, _ = x.shape
    xq, sx = quantize_dynamic(x)
    y = int_mm(im2col3x3(xq), wq.t())
    return dequantize(y, sx, sw, bias, x.dtype).reshape(b, h, w, wq.shape[0])


def int8_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 3x3 stride-1 SAME conv of NHWC x with the fp torch weight
    [O, I, 3, 3] (the JAX function's HWIO kernel, permuted); returns x's
    type."""
    wq, sw = conv_weight_q(weight)
    return conv_q(x, wq, sw, bias)


class QuantCache:
    """A module's int8 weights, quantised once per weight: ``get(slot,
    weights, fn)`` returns ``fn(*weights)`` as computed the last time the
    weights were the same tensors with the same storage, version and type,
    and computes it again otherwise (after ``load_state_dict``, a LoRA
    merge or ``.to()``)."""

    def __init__(self):
        self._entries: Dict[str, tuple] = {}

    @staticmethod
    def _key(t: torch.Tensor) -> tuple:
        version = None if t.is_inference() else t._version
        return id(t), t.data_ptr(), version, t.dtype, t.device, tuple(t.shape)

    def get(self, slot: str, weights, fn):
        """``slot`` names the entry (and what else it depends on, such as
        the type the weights are cast to)."""
        key = tuple(self._key(t) for t in weights)
        hit = self._entries.get(slot)
        if hit is not None and hit[0] == key:
            return hit[1]
        with torch.no_grad():
            value = fn(*weights)
        self._entries[slot] = (key, value)
        return value
