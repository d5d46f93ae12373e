"""The training loop (port of ``clap2diffusion_tpu/train/trainer.py``): data ->
frozen-encoder embeddings -> stage steps -> logging and checkpoints, on one
device.

``run_stage(cfg, stage, params, ...)`` takes the per-tower state dicts that
``convert.from_flax`` returns (or ``init_params`` draws) and runs stage 1,
2 or 3 eagerly, one micro-step per batch, on CUDA unless ``device="cpu"``
is passed; it never moves to the CPU on its own. Batches stream from the
latent dataset through the prefetching loader; CLAP audio embeddings and
CLIP text contexts come from the frozen towers under ``torch.no_grad`` or
from the ``emb/{id}.npz`` cache beside the data.

``steps_per_call`` has no eager counterpart: the JAX package runs that many
steps in one compiled call and decides logging, validation and periodic
saves only at the end of such a call. The port steps one batch at a time
and takes those decisions at the same micro-steps (every
``steps_per_call`` from the start, and at the last step); it reads the
field nowhere else. A SIGTERM or SIGINT saves ``stage{N}_preempt`` after
the current micro-step and re-raises the signal. Multi-device training,
LoRA (``lora_rank > 0``) and UNet rematerialisation (``remat``) are not
ported and raise.
"""

from __future__ import annotations

import json
import math
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from clap2diffusion_tpu_torch.core.config import Config
from clap2diffusion_tpu_torch.core.device import resolve_device
from clap2diffusion_tpu_torch.data.latent_dataset import AudioCapsLatentDataset, PrefetchLoader
from clap2diffusion_tpu_torch.diffusion.pipeline import _special_init, build_modules, random_init_
from clap2diffusion_tpu_torch.models.clap.frontend import log_mel_spectrogram
from clap2diffusion_tpu_torch.models.clap.htsat import ClapAudioTower
from clap2diffusion_tpu_torch.models.clip_text import CLIPTextEncoder
from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer
from clap2diffusion_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from clap2diffusion_tpu_torch.train.stages import (
    BATCH_KEYS,
    MAKE_STAGE,
    TrainState,
    train_step,
)
from clap2diffusion_tpu_torch.utils.logging import MetricLogger


def init_params(cfg: Config, seed: int = 0, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random fp32 weights for every tower of the pipeline (the adapter
    included), drawn on ``device`` from one seeded ``torch.Generator`` with
    the pipeline's initialisation rule."""
    dev = resolve_device(device)
    with torch.device("meta"):
        mods = build_modules(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, m in mods.items():
        m.to_empty(device=dev)
        random_init_(m, gen, _special_init(cfg))
        out[name] = {k: v.detach() for k, v in m.state_dict().items()}
    return out


def _tower(module: nn.Module, sd: Dict[str, torch.Tensor], device) -> nn.Module:
    module.to_empty(device=device)
    module.load_state_dict(sd, strict=True)
    return module.float().eval().requires_grad_(False)


class EmbeddingFrontend:
    """Frozen CLAP-audio + CLIP-text towers in fp32, applied per batch.

    With ``data_root`` set, per-sample embeddings cached as
    ``emb/{id}.npz`` (clap, text_ctx, text_emb) are used instead of the
    towers when every sample of the batch has one."""

    def __init__(self, cfg: Config, params: Dict, data_root: Optional[str] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.emb_dir = os.path.join(data_root, "emb") if data_root else None
        with torch.device("meta"):
            clap, clip = ClapAudioTower(cfg.clap.audio), CLIPTextEncoder(cfg.diffusion.clip_text)
        self.clap = _tower(clap, params["clap_audio"], self.device)
        self.clip = _tower(clip, params["clip_text"], self.device)
        self.tokenizer = CLIPTokenizer(max_length=cfg.diffusion.clip_text.max_length)

    @torch.no_grad()
    def embed_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        dev = self.device
        latent = torch.as_tensor(np.asarray(batch["latent"], np.float32), device=dev)
        cached = self._load_cached(batch.get("audio_id", []))
        if cached is not None:
            return {**{k: torch.as_tensor(v, device=dev) for k, v in cached.items()},
                    "latent": latent}
        wav = torch.as_tensor(np.asarray(batch["audio"], np.float32), device=dev)
        clap = self.clap(log_mel_spectrogram(wav, self.cfg.clap.frontend))
        ids = torch.as_tensor(np.asarray(self.tokenizer(batch["caption"]), np.int32), device=dev)
        ctx = self.clip(ids)
        return {"clap": clap, "latent": latent, "text_ctx": ctx, "text_emb": ctx.mean(dim=1)}

    def _load_cached(self, ids) -> Optional[Dict[str, np.ndarray]]:
        if not self.emb_dir or not ids:
            return None
        rows = []
        for sid in ids:
            path = os.path.join(self.emb_dir, f"{sid}.npz")
            if not os.path.exists(path):
                return None  # any miss: compute the whole batch
            with np.load(path) as z:
                rows.append({k: z[k] for k in ("clap", "text_ctx", "text_emb")})
        return {k: np.stack([r[k] for r in rows]) for k in ("clap", "text_ctx", "text_emb")}


def _dataset(cfg: Config, data_root: str, split: str, pairing: str) -> AudioCapsLatentDataset:
    return AudioCapsLatentDataset(
        data_root, split=split, audio_duration=cfg.data.duration_s,
        sample_rate=cfg.data.sample_rate, composition_strategy=pairing, seed=cfg.data.seed,
        latent_hw=cfg.data.latent_shape[1])


def run_stage(cfg: Config, stage: int, params: Dict, data_root: Optional[str] = None,
              max_steps: Optional[int] = None, checkpoint_dir: Optional[str] = None,
              log_dir: Optional[str] = None, seed: Optional[int] = None,
              resume_from: Optional[str] = None, device=None) -> TrainState:
    """Run one training stage end to end; returns the final ``TrainState``.

    ``params``: tower -> state dict (any device and type; the stage copies
    its towers to ``device`` as fp32 masters, so the caller's tensors are
    never modified). ``max_steps`` counts micro-steps. ``resume_from``
    names a checkpoint in ``checkpoint_dir`` whose params, optimizer state
    and step are restored before continuing. ``device=None`` means CUDA."""
    if os.environ.get("C2D_INT8") == "1":
        # as the JAX run_stage: the quantisation's round() has zero gradient
        raise RuntimeError(
            "C2D_INT8=1 is a serve-only mode (clap2diffusion_tpu/ops/quant.py); unset it for "
            "training — the quantization round() has zero gradient.")
    dev = resolve_device(device)
    if stage not in MAKE_STAGE:
        raise ValueError(f"unknown stage {stage}")
    scfg = getattr(cfg.train, f"stage{stage}")
    if scfg.lora_rank > 0:
        raise NotImplementedError("train.stageN.lora_rank > 0 (LoRA adapters) is not ported "
                                  "to the PyTorch package yet; set it to 0")
    if stage > 1 and cfg.diffusion.unet.remat:
        raise NotImplementedError("diffusion.unet.remat=True (UNet rematerialisation) is not "
                                  "ported to the PyTorch package yet; set it to false")
    seed = cfg.train.seed if seed is None else seed
    data_root = data_root or cfg.data.data_root
    steps = max_steps if max_steps is not None else scfg.steps

    st = MAKE_STAGE[stage](cfg)
    state = st.create_state({
        tw: {n: t.detach().to(dev, torch.float32, copy=True) for n, t in params[tw].items()}
        for tw in st.towers})
    if resume_from and checkpoint_dir:
        restore_checkpoint(checkpoint_dir, state, name=resume_from, trainable=st.trainable)
    frontend = EmbeddingFrontend(cfg, params, data_root=data_root, device=dev)
    loader = PrefetchLoader(_dataset(cfg, data_root, "train", cfg.data.pairing),
                            batch_size=scfg.batch_size, seed=seed, prefetch=cfg.data.prefetch)
    logger = MetricLogger(log_dir or cfg.train.log_dir, run_name=f"stage{stage}")
    keys = BATCH_KEYS[stage]
    spc = max(1, scfg.steps_per_call)
    generator = torch.Generator(device=dev).manual_seed(seed)
    val = {"batches": None}

    def with_ema(s: TrainState) -> TrainState:
        """The weights serving would use: the EMA shadow over the trainable
        leaves (what ``merge_stage_params(use_ema=True)`` serves)."""
        if s.ema is None:
            return s
        params_ema = {tw: {n: s.ema.get(f"{tw}.{n}", t) for n, t in sd.items()}
                      for tw, sd in s.params.items()}
        return TrainState(params=params_ema, opt=s.opt, step=s.step,
                          frozen_compute=s.frozen_compute)

    def eval_metrics(s: TrainState) -> Optional[Dict[str, float]]:
        """The stage's own loss on ``eval_batches`` fixed val batches, with
        a generator reseeded per evaluation so evaluations compare."""
        if val["batches"] is None:
            try:
                ds = _dataset(cfg, data_root, "val", "matching")
            except (OSError, ValueError, KeyError) as e:
                print(f"[run_stage] eval_every disabled: {e}")
                ds = None
            order = np.arange(len(ds) if ds else 0)
            np.random.RandomState(cfg.data.seed).shuffle(order)
            bs = scfg.batch_size
            val["batches"] = [
                {k: v for k, v in frontend.embed_batch(PrefetchLoader._collate(
                    [ds[int(i)] for i in order[b * bs:(b + 1) * bs]])).items() if k in keys}
                for b in range(min(scfg.eval_batches, len(order) // bs))]
            if ds is not None and not val["batches"]:
                print(f"[run_stage] eval_every disabled: val split smaller than batch {bs}")
        if not val["batches"]:
            return None
        es = with_ema(s)
        gen = torch.Generator(device=dev).manual_seed(seed ^ 0xE7A1)
        totals: Dict[str, list] = {}
        with torch.no_grad():
            for b in val["batches"]:
                for k, v in st.loss(es, b, gen)[1].items():
                    if torch.is_tensor(v) and v.dim() == 0:
                        totals.setdefault(k, []).append(float(v))
        return {"val_" + k: float(np.mean(v)) for k, v in totals.items()}

    caught = {"sig": None}
    restore_sigs = []
    if checkpoint_dir:
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev = signal.signal(sig, lambda sn, fr: caught.update(sig=sn))
                restore_sigs.append((sig, prev))
        except ValueError:  # not the main thread: no handlers, no preemption save
            restore_sigs = []

    def restore_signals():
        for sig, prev in restore_sigs:
            signal.signal(sig, prev)

    best_sidecar = (os.path.join(checkpoint_dir, f"stage{stage}_best_val.json")
                    if checkpoint_dir else None)
    best_val = math.inf
    if resume_from and best_sidecar and os.path.exists(best_sidecar):
        with open(best_sidecar) as f:
            best_val = float(json.load(f)["val_total"])

    done = start = state.step
    epoch = 0
    t0 = time.time()
    try:
        while done < steps:
            for batch in loader.epoch(epoch):
                emb = frontend.embed_batch(batch)
                metrics = train_step(st, state, {k: emb[k] for k in keys}, generator)
                done += 1
                if (done - start) % spc == 0 or done >= steps:  # a JAX call boundary
                    if done % scfg.log_every < spc or done <= spc:
                        scalars = {k: float(v) for k, v in metrics.items()}
                        scalars["steps_per_s"] = (done - start) / (time.time() - t0)
                        logger.log(done, scalars)
                    if (scfg.eval_every > 0 and done >= scfg.eval_every
                            and done % scfg.eval_every < spc):
                        vm = eval_metrics(state)
                        if vm:
                            logger.log(done, vm)
                        if vm and checkpoint_dir and vm.get("val_total", math.inf) < best_val:
                            best_val = vm["val_total"]
                            save_checkpoint(checkpoint_dir, state, name=f"stage{stage}_best",
                                            trainable=st.trainable)
                            with open(best_sidecar, "w") as f:
                                json.dump({"val_total": best_val, "step": done}, f)
                    if (checkpoint_dir and done % scfg.save_every < spc
                            and done >= scfg.save_every):
                        save_checkpoint(checkpoint_dir, state, name=f"stage{stage}_step{done}",
                                        trainable=st.trainable)
                if caught["sig"] is not None:
                    sig, caught["sig"] = caught["sig"], None
                    save_checkpoint(checkpoint_dir, state, name=f"stage{stage}_preempt",
                                    trainable=st.trainable)
                    logger.log(done, {"preempted_by_signal": float(sig)})
                    restore_signals()
                    restore_sigs.clear()
                    signal.raise_signal(sig)  # the caller's disposition: exit or raise
                if done >= steps:
                    break
            epoch += 1
        if checkpoint_dir:
            save_checkpoint(checkpoint_dir, state, name=f"stage{stage}_final",
                            trainable=st.trainable)
    finally:
        restore_signals()
        logger.close()
    return state
