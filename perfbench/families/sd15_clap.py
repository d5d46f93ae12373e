"""The SD v1.5 + CLAP family: the SD v1.5 UNet, VAE and CLIP ViT-L text
tower, the CLAP HTSAT audio tower and the hierarchical audio stack. What
the harness knows of this model and of no other: the towers it draws and
their salts, its reference towers, one lane's reference image and the
stage-2 training reference (``perfbench/reference/pipeline.py``), and the
work of a request or a micro-step, counted on the reference on the meta
device.

A configuration file names its family under ``"family"``; the harness
loads ``perfbench/families/<family>.py`` by path (``common.family``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness.work import GN_OPS_PER_ELEMENT, Recorder, attention_work, recording
from perfbench.reference import pipeline
from perfbench.reference.clip_text import CLIPTextEncoder
from perfbench.reference.frontend import log_mel_spectrogram
from perfbench.reference.hierarchical import ROUTING_INIT, HierarchicalAudioEncoder
from perfbench.reference.htsat import ClapAudioTower
from perfbench.reference.unet import UNet2DCondition
from perfbench.reference.vae import AutoencoderKL

SERVE_TOWERS = ("clap_audio", "clip_text", "hierarchical", "unet", "vae")
TRAIN_TOWERS = ("clap_audio", "clip_text", "hierarchical", "unet")
# each tower's generator is seeded from the run's seed and its salt
SALT = {"clap_audio": 1, "clip_text": 2, "hierarchical": 3, "unet": 4, "vae": 5}
# leaves drawn as the models initialise them, by last name component:
# ("normal", std), ("fill", value) or ("value", the leaf's contents)
SPECIAL = {
    "token_offsets": ("normal", 0.02), "level_anchors": ("normal", 0.02),
    "queries": ("normal", 0.02), "clip_pos_embed": ("normal", 0.02),
    "query_pos": ("fill", 0.0), "relative_position_bias_table": ("fill", 0.0),
    "alpha": ("fill", 0.0), "running_mean": ("fill", 0.0), "running_var": ("fill", 1.0),
    "routing_matrix": ("value", ROUTING_INIT), "early": ("fill", 0.0), "mid": ("fill", 0.0),
    "late": ("fill", 0.0),
}


def build_reference(cfg) -> Dict[str, torch.nn.Module]:
    """The reference towers of a configuration namespace (``model`` group)."""
    return {"clap_audio": ClapAudioTower(cfg.clap.audio),
            "clip_text": CLIPTextEncoder(cfg.diffusion.clip_text),
            "hierarchical": HierarchicalAudioEncoder(cfg.condition),
            "unet": UNet2DCondition(cfg.diffusion.unet),
            "vae": AutoencoderKL(cfg.diffusion.vae)}


def latent_shape(cfg) -> Tuple[int, int, int]:
    """One image's latents: (height, width, channels)."""
    lat = cfg.diffusion.image_size // 8
    return (lat, lat, cfg.diffusion.vae.latent_channels)


def text_length(cfg) -> int:
    """The tokens of a prompt."""
    return cfg.diffusion.clip_text.max_length


class Reference(pipeline.Reference):
    """``pipeline.Reference`` over this family's towers."""

    def __init__(self, cfg, weights, device, towers):
        super().__init__(cfg, weights, device, towers, build_reference)


Stage2 = pipeline.Stage2


def _meta_reference(cfg, towers):
    with torch.device("meta"):
        mods = build_reference(cfg)
    return {t: mods[t].eval().requires_grad_(False) for t in towers}


def request_work(cfg, batch: int, steps: int, itemsize: int) -> Dict[str, float]:
    """One served request of ``batch`` images: CLAP, the hierarchical
    encoder, CLIP text over the prompt and the negative, ``steps`` UNet
    forwards at CFG batch 2 * batch, the VAE decode."""
    m = _meta_reference(cfg, SERVE_TOWERS)
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
    m = _meta_reference(cfg, TRAIN_TOWERS)
    for tower in ("hierarchical", "unet"):
        for n, p in m[tower].named_parameters():
            p.requires_grad_(pipeline.stage2_trainable(f"{tower}.{n}"))
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
