"""Checkpoints of (params, optimizer state, step, EMA) (port of
``clap2diffusion_tpu/train/checkpoint.py``).

``torch.save`` takes the place of orbax: each checkpoint is a directory
``<ckpt_dir>/<name>/`` holding ``state.pt``, written to a temporary file
and renamed. Params are the state's dict tower -> name -> tensor; with a
``trainable`` predicate the frozen UNet body is pruned before saving
(``prune_frozen_unet``) and taken from the caller's state at restore.
``merge_stage_params`` folds a stage's weights (or their EMA shadow) into a
pipeline's per-tower state dicts for serving. ``load_torch_checkpoint``
reads the reference's ``.pth`` artifacts.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, Optional

import torch

from clap2diffusion_tpu_torch.train.lora import lora_targets_present, merge_lora

_FILE = "state.pt"


def _deep_overlay(base, over):
    """Overlay ``over`` onto ``base``: dicts merge by key, anything else is
    replaced."""
    if isinstance(over, dict) and isinstance(base, dict):
        out = dict(base)
        for k, v in over.items():
            out[k] = _deep_overlay(base[k], v) if k in base else v
        return out
    return over


def prune_frozen_unet(params: Dict[str, Dict[str, Any]],
                      trainable: Optional[Callable[[str], bool]]) -> Dict[str, Dict[str, Any]]:
    """Drop the frozen UNet body: keep the UNet leaves ``trainable``
    selects ("unet.<name>") and every ``audio_inject`` processor; drop the
    ``unet`` entry when nothing is kept. Other towers pass unchanged."""
    if trainable is None or "unet" not in params:
        return params
    unet = {n: t for n, t in params["unet"].items()
            if trainable(f"unet.{n}") or "audio_inject" in n}
    pruned = {k: v for k, v in params.items() if k != "unet"}
    if unet:
        pruned["unet"] = unet
    return pruned


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_checkpoint(ckpt_dir: str, state, name: str = "state",
                    trainable: Optional[Callable[[str], bool]] = None) -> str:
    """Write ``state`` (a ``train.stages.TrainState``) under
    ``<ckpt_dir>/<name>/``; returns that directory."""
    path = os.path.join(os.path.abspath(ckpt_dir), name)
    os.makedirs(path, exist_ok=True)
    payload = {
        "params": _cpu(prune_frozen_unet(state.params, trainable)),
        "opt_state": _cpu(state.opt.state_dict()),
        "step": int(state.step),
        "ema_params": _cpu(state.ema),
    }
    tmp = os.path.join(path, f"{_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def load_payload(ckpt_dir: str, name: str = "state") -> Dict[str, Any]:
    """The saved dict (params, opt_state, step, ema_params), on the CPU."""
    return torch.load(os.path.join(os.path.abspath(ckpt_dir), name, _FILE),
                      map_location="cpu", weights_only=True)


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, state, name: str = "state",
                       trainable: Optional[Callable[[str], bool]] = None):
    """Load a checkpoint into ``state`` in place (its tensors keep their
    device and type) and return it. The saved params overlay the state's:
    leaves a pruned checkpoint left out keep the state's values."""
    payload = load_payload(ckpt_dir, name)
    for tower, sd in payload["params"].items():
        for n, t in sd.items():
            state.params[tower][n].copy_(t)
    state.opt.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    if state.ema is not None and payload.get("ema_params") is not None:
        for k, t in payload["ema_params"].items():
            state.ema[k].copy_(t)
    return state


def merge_stage_params(pipeline_params: Dict[str, Dict[str, torch.Tensor]],
                       payload: Dict[str, Any], stage: int, use_ema: bool = False,
                       dtype: Optional[torch.dtype] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fold a trained stage's weights, or their EMA shadow, into a full
    per-tower parameter dict for serving. The shadow covers only the
    trainable leaves ("tower.name" keys); frozen leaves come from the saved
    params, and leaves a pruned checkpoint left out from
    ``pipeline_params``. A stage-2 ``"lora"`` tower (or its shadow) is
    folded into the UNet where its target weights are present, and never
    returned as a tower."""
    src = {tw: dict(sd) for tw, sd in payload["params"].items()}
    if use_ema:
        ema = payload.get("ema_params")
        if ema is None:
            raise ValueError("checkpoint carries no ema_params — train with "
                             "train.stageN.use_ema=true to produce an EMA shadow")
        for key, val in ema.items():
            tower, leaf = key.split(".", 1)
            src[tower][leaf] = val
    if dtype is not None:
        src = {tw: {n: t.to(dtype) for n, t in sd.items()} for tw, sd in src.items()}
    if stage == 1:
        return {**pipeline_params, "adapter": src["adapter"]}
    lora = src.pop("lora", None)
    merged = _deep_overlay(dict(pipeline_params), src)
    # stage 2 trained LoRA adapters (train/lora.py): fold them into the
    # UNet's weights for serving; with no base weights to fold into (the
    # export path's empty base, a pruned checkpoint on its own) the fold is
    # skipped, as in JAX
    unet = merged.get("unet")
    if lora is not None and unet is not None and lora_targets_present(unet, lora):
        merged["unet"] = merge_lora(unet, lora)
    return merged


def stage_from_name(name: str) -> int:
    """The stage number in a checkpoint name such as ``stage2_final``."""
    m = re.search(r"stage(\d)", name)
    if not m:
        raise ValueError(f"cannot infer training stage from checkpoint name {name!r}; "
                         "expected a run_stage artifact like 'stage2_final'")
    return int(m.group(1))


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A reference ``.pth`` file, loaded with ``weights_only=True`` (as the
    reference's inference script loads it) onto the CPU: its nested dicts
    as they are, with torch tensors for leaves."""
    return torch.load(path, map_location="cpu", weights_only=True)
