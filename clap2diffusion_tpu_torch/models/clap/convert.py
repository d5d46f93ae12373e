"""HF CLAP weights -> the port's ``clap_audio`` and ``clap_text`` state dicts
(counterpart of ``clap2diffusion_tpu/models/clap/convert.py``).

``convert_clap_audio`` takes an HF ``ClapModel`` state dict (audio tower
under ``audio_model.audio_encoder.``) or a ``ClapAudioModelWithProjection``
one (under ``audio_encoder.``); the projection is ``audio_projection.`` in
both. ``convert_clap_text`` takes the text side of a ``ClapModel``
(``text_model.*`` or the same keys without the prefix, and
``text_projection.*``). The port's towers carry the HF names, so the keys
are picked and checked as in ``models/convert.py``; every other key is
ignored. ``convert_clap`` converts a whole ``ClapModel`` dict: both towers
and the ``logit_scale_a`` / ``logit_scale_t`` extras.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from clap2diffusion_tpu_torch.core.config import CLAPTextConfig, HTSATConfig
from clap2diffusion_tpu_torch.models.clap.htsat import ClapAudioTower
from clap2diffusion_tpu_torch.models.clap.text import ClapTextTower
from clap2diffusion_tpu_torch.models.convert import select, template


def convert_clap_audio(sd: Mapping, cfg: HTSATConfig | None = None) -> Dict[str, torch.Tensor]:
    """HF ClapModel (or ClapAudioModelWithProjection) state dict -> the
    audio tower's state dict."""
    shapes = template(ClapAudioTower, cfg or HTSATConfig())
    full = any(k.startswith("audio_model.") for k in sd)
    enc = {k: s for k, s in shapes.items() if k.startswith("audio_encoder.")}
    proj = {k: s for k, s in shapes.items() if not k.startswith("audio_encoder.")}
    out = select(sd, enc, "audio_model." if full else "", what="CLAP audio")
    out.update(select(sd, proj, what="CLAP audio"))
    return out


def has_text_tower(sd: Mapping) -> bool:
    """Whether ``sd`` carries a CLAP text tower (the JAX converter tool's
    test: its word embeddings, with or without ``text_model.``)."""
    return ("text_model.embeddings.word_embeddings.weight" in sd
            or "embeddings.word_embeddings.weight" in sd)


def convert_clap_text(sd: Mapping, cfg: CLAPTextConfig | None = None) -> Dict[str, torch.Tensor]:
    """HF ClapModel state dict (its text side) -> the text tower's state
    dict."""
    shapes = template(ClapTextTower, cfg or CLAPTextConfig())
    full = any(k.startswith("text_model.") for k in sd)
    model = {k[len("text_model."):]: s for k, s in shapes.items() if k.startswith("text_model.")}
    proj = {k: s for k, s in shapes.items() if k.startswith("text_projection.")}
    out = {"text_model." + k: v for k, v in select(
        sd, model, "text_model." if full else "", what="CLAP text").items()}
    out.update(select(sd, proj, what="CLAP text"))
    return out


def convert_clap(sd: Mapping, audio_cfg: HTSATConfig | None = None,
                 text_cfg: CLAPTextConfig | None = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, float]]:
    """A whole HF ClapModel state dict -> (the audio tower's state dict,
    the text tower's, and the extras ``logit_scale_a`` / ``logit_scale_t``
    where the dict has them, as floats)."""
    extras = {k: float(sd[k]) for k in ("logit_scale_a", "logit_scale_t") if k in sd}
    return convert_clap_audio(sd, audio_cfg), convert_clap_text(sd, text_cfg), extras
