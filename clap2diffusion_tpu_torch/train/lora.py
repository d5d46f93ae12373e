"""LoRA adapters for the UNet's cross-attention projections (port of
``clap2diffusion_tpu/train/lora.py``).

The adapters live in a tower of their own, ``"lora"``, and are folded into
the frozen UNet weights on every forward: ``W' = W + (alpha/rank) (A B)^T``
(a torch weight is [out, in]; ``a`` is [in, r] and ``b`` [r, out], the JAX
shapes). ``b`` starts at zero, so the fold is the identity at init, and
gradients reach only ``a`` and ``b``. ``merge_stage_params`` folds a trained
stage-2 checkpoint's adapters into the UNet for serving.

Layout: the JAX tree ``{"<unet leaf path>": {"a", "b"}, "alpha"}`` as a
state dict in the port's names, ``{"<unet leaf>.a", "<unet leaf>.b",
"alpha"}`` (``<unet leaf>`` the target's diffusers name, e.g.
``down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_q.weight``), so
that the stage's tower -> name -> tensor state, its checkpoints and its EMA
keys hold it as they hold every other tower. ``alpha`` is a frozen leaf, so
that serving needs no training config to fold the adapters.

Targets: the ``attn2`` (text/audio cross-attention) ``to_q``, ``to_k``,
``to_v`` and ``to_out.0`` weights (no biases), the leaves the JAX
``target_paths`` picks; the audio-injection branches sit outside ``attn2``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch

_PROJECTIONS = (".to_q.weight", ".to_k.weight", ".to_v.weight", ".to_out.0.weight")


def target_names(unet_sd: Mapping[str, torch.Tensor]) -> List[str]:
    """The cross-attention (``attn2``) projection weights of a UNet state
    dict, sorted."""
    return sorted(k for k in unet_sd if ".attn2." in k and k.endswith(_PROJECTIONS))


def init_lora(unet_sd: Mapping[str, torch.Tensor], rank: int, generator: torch.Generator,
              alpha: float = 16.0) -> Dict[str, torch.Tensor]:
    """The adapter tower, fp32 on ``generator``'s device: for each target
    weight [out, in] an ``a`` [in, r] ~ N(0, 1/in), drawn from ``generator``
    in ``target_names`` order, and a zero ``b`` [r, out]."""
    names = target_names(unet_sd)
    if not names:
        raise ValueError("no attn2 kernels found to adapt")
    dev = generator.device
    tree = {"alpha": torch.tensor(float(alpha), dtype=torch.float32, device=dev)}
    for name in names:
        cout, cin = unet_sd[name].shape
        tree[f"{name}.a"] = torch.randn((cin, rank), generator=generator, device=dev,
                                        dtype=torch.float32) / math.sqrt(cin)
        tree[f"{name}.b"] = torch.zeros((rank, cout), dtype=torch.float32, device=dev)
    return tree


def adapted_names(lora: Mapping[str, torch.Tensor]) -> List[str]:
    """The UNet weights an adapter tower folds into."""
    return sorted(k[:-2] for k in lora if k.endswith(".a"))


def merge_lora(unet_sd: Mapping[str, torch.Tensor],
               lora: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of the UNet state dict with the adapters folded in:
    ``W' = W + (alpha/r) (A B)^T``, computed in fp32 and rounded to W's
    type (the JAX order), on W's device. The identity while B == 0.
    Differentiable in A and B."""
    merged = dict(unet_sd)
    for name in adapted_names(lora):
        w = merged[name]
        # on W's device: a checkpoint's adapters are read onto the CPU
        alpha, a, b = (lora[k].to(w.device, torch.float32)
                       for k in ("alpha", f"{name}.a", f"{name}.b"))
        delta = (alpha / a.shape[-1]) * (a @ b)
        merged[name] = (w.float() + delta.t()).to(w.dtype)
    return merged


def lora_targets_present(unet_sd: Mapping[str, torch.Tensor],
                         lora: Mapping[str, torch.Tensor]) -> bool:
    """Whether every weight the adapters fold into is in ``unet_sd`` (a
    pruned checkpoint overlaid on no base has none)."""
    return all(name in unet_sd for name in adapted_names(lora))


def lora_trainable(name: str) -> bool:
    """Trainable-leaf predicate for ``"lora.<leaf>"`` names: the ``a`` and
    ``b`` matrices (``alpha`` stays frozen)."""
    return name.startswith("lora.") and name.endswith((".a", ".b"))
