"""The weights every run draws from its seed, on the device, in the type
they are used in, under the state-dict names the program and the
reference share.

Names and shapes come from the family's reference modules built on the meta
device. Each tower's matrices are one ``torch.randn`` call on a
``torch.Generator`` of the run's device, seeded from the run's seed and the
tower's salt in the family's ``SALT``, cut into leaves and scaled: a matrix
or kernel ~ N(0, 1 / fan_in), embeddings the same by their width, biases 0,
norm scales 1, and the few leaves of the family's ``SPECIAL`` as the models
initialise them.
The same seed gives the same weights to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _rule(special: Dict, name: str, t: torch.Tensor):
    leaf = name.rsplit(".", 1)[-1]
    if leaf in special:
        return special[leaf]
    if leaf.endswith("bias"):
        return "fill", 0.0
    if t.dim() == 1:
        return "fill", 1.0
    return "normal", 1.0 / math.sqrt(t[0].numel())


def shapes(family, cfg, towers) -> Dict[str, Dict[str, torch.Size]]:
    with torch.device("meta"):
        mods = family.build_reference(cfg)
    return {t: {k: v.shape for k, v in mods[t].state_dict().items()} for t in towers}


@torch.no_grad()
def draw_weights(family, cfg, seed: int, towers, dtype: torch.dtype,
                 device) -> Dict[str, Dict[str, torch.Tensor]]:
    """tower -> state dict of ``dtype`` tensors on ``device``, from ``seed``,
    for ``towers`` of ``family`` (``common.family``)."""
    device = torch.device(device)
    out = {}
    for tower, sd in shapes(family, cfg, towers).items():
        rules = {k: _rule(family.SPECIAL, k, torch.empty(s, device="meta"))
                 for k, s in sd.items()}
        total = sum(math.prod(s) for k, s in sd.items() if rules[k][0] == "normal")
        gen = torch.Generator(device=device).manual_seed(
            (int(seed) * 1_000_003 + family.SALT[tower]) % (1 << 63))
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        off, tensors = 0, {}
        for k, s in sd.items():
            kind, arg = rules[k]
            if kind == "normal":
                n = math.prod(s)
                tensors[k] = flat[off:off + n].view(s).mul_(arg)
                off += n
            elif kind == "value":
                tensors[k] = torch.tensor(arg, dtype=dtype, device=device)
            else:
                tensors[k] = torch.full(s, arg, dtype=dtype, device=device)
        out[tower] = tensors
    return out
