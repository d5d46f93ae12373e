"""HF CLAP weights -> the port's ``clap_audio`` state dict (counterpart of
``clap2diffusion_tpu/models/clap/convert.py::convert_clap_audio``).

Takes an HF ``ClapModel`` state dict (audio tower under
``audio_model.audio_encoder.``) or a ``ClapAudioModelWithProjection`` one
(under ``audio_encoder.``); the projection is ``audio_projection.`` in
both. The port's HTSAT tower carries the HF names, so the keys are picked
and checked as in ``models/convert.py``. The text tower
(``text_model.*``, ``text_projection.*``), ``logit_scale_*`` and every
other key are ignored: ``clap_text`` is not ported (ROADMAP Queue 1, item 7).
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

from clap2diffusion_tpu_torch.core.config import HTSATConfig
from clap2diffusion_tpu_torch.models.clap.htsat import ClapAudioTower
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


def text_tower_keys(sd: Mapping) -> List[str]:
    """The keys of a CLAP text tower in ``sd`` (which the port skips)."""
    return sorted(k for k in sd if k.startswith(("text_model.", "text_projection.")))
