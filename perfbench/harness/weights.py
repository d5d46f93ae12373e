"""The weights every run draws from its seed, on the device, in the type
they are used in, under the state-dict names the program and the
reference share.

Names and shapes come from the reference modules built on the meta device.
Each tower's matrices are one ``torch.randn`` call on a ``torch.Generator``
of the run's device, cut into leaves and scaled: a matrix or kernel
~ N(0, 1 / fan_in), embeddings the same by their width, biases 0, norm
scales 1, and the few leaves of ``SPECIAL`` as the models initialise them.
The same seed gives the same weights to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference.hierarchical import ROUTING_INIT

SPECIAL = {  # last name component -> (rule, argument)
    "token_offsets": ("normal", 0.02), "level_anchors": ("normal", 0.02),
    "queries": ("normal", 0.02), "clip_pos_embed": ("normal", 0.02),
    "query_pos": ("fill", 0.0), "relative_position_bias_table": ("fill", 0.0),
    "alpha": ("fill", 0.0), "running_mean": ("fill", 0.0), "running_var": ("fill", 1.0),
    "routing_matrix": ("routing", None), "early": ("fill", 0.0), "mid": ("fill", 0.0),
    "late": ("fill", 0.0),
}
TOWER_SALT = {"clap_audio": 1, "clip_text": 2, "hierarchical": 3, "unet": 4, "vae": 5}


def build_reference(cfg) -> Dict[str, torch.nn.Module]:
    """The reference towers of a configuration namespace (``model`` group)."""
    from perfbench.reference.clip_text import CLIPTextEncoder
    from perfbench.reference.hierarchical import HierarchicalAudioEncoder
    from perfbench.reference.htsat import ClapAudioTower
    from perfbench.reference.unet import UNet2DCondition
    from perfbench.reference.vae import AutoencoderKL

    return {"clap_audio": ClapAudioTower(cfg.clap.audio),
            "clip_text": CLIPTextEncoder(cfg.diffusion.clip_text),
            "hierarchical": HierarchicalAudioEncoder(cfg.condition),
            "unet": UNet2DCondition(cfg.diffusion.unet),
            "vae": AutoencoderKL(cfg.diffusion.vae)}


def _rule(name: str, t: torch.Tensor):
    leaf = name.rsplit(".", 1)[-1]
    if leaf in SPECIAL:
        return SPECIAL[leaf]
    if leaf.endswith("bias"):
        return "fill", 0.0
    if t.dim() == 1:
        return "fill", 1.0
    return "normal", 1.0 / math.sqrt(t[0].numel())


def shapes(cfg, towers) -> Dict[str, Dict[str, torch.Size]]:
    with torch.device("meta"):
        mods = build_reference(cfg)
    return {t: {k: v.shape for k, v in mods[t].state_dict().items()} for t in towers}


@torch.no_grad()
def draw_weights(cfg, seed: int, towers, dtype: torch.dtype,
                 device) -> Dict[str, Dict[str, torch.Tensor]]:
    """tower -> state dict of ``dtype`` tensors on ``device``, from ``seed``."""
    device = torch.device(device)
    out = {}
    for tower, sd in shapes(cfg, towers).items():
        rules = {k: _rule(k, torch.empty(s, device="meta")) for k, s in sd.items()}
        total = sum(math.prod(s) for k, s in sd.items() if rules[k][0] == "normal")
        gen = torch.Generator(device=device).manual_seed(
            (int(seed) * 1_000_003 + TOWER_SALT[tower]) % (1 << 63))
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        off, tensors = 0, {}
        for k, s in sd.items():
            kind, arg = rules[k]
            if kind == "normal":
                n = math.prod(s)
                tensors[k] = flat[off:off + n].view(s).mul_(arg)
                off += n
            elif kind == "routing":
                tensors[k] = torch.tensor(ROUTING_INIT, dtype=dtype, device=device)
            else:
                tensors[k] = torch.full(s, arg, dtype=dtype, device=device)
        out[tower] = tensors
    return out
