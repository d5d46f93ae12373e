"""The training loop (port of ``clap2diffusion_tpu/train/trainer.py``): data ->
frozen-encoder embeddings -> stage steps -> logging and checkpoints, on one
device.

``run_stage(cfg, stage, params, ...)`` takes the per-tower state dicts that
``convert.from_flax`` returns (or ``diffusion.pipeline.init_params``
draws) and runs stage 1, 2 or 3 eagerly, one micro-step per batch, on CUDA
unless ``device="cpu"`` is passed; it never moves to the CPU on its own.
Batches stream from the latent dataset through the prefetching loader; CLAP
audio embeddings and CLIP text contexts come from the frozen towers under
``torch.no_grad`` or from the ``emb/{id}.npz`` cache beside the data.

``steps_per_call`` has no eager counterpart: the JAX package runs that many
steps in one compiled call and decides logging, validation and periodic
saves only at the end of such a call. The port steps one batch at a time
and takes those decisions at the same micro-steps (every
``steps_per_call`` from the start, and at the last step); it reads the
field nowhere else. A SIGTERM or SIGINT saves ``stage{N}_preempt`` after
the current micro-step and re-raises the signal; under a process group a
signal to any rank does so on every rank, at the same micro-step. Stage 2 with
``lora_rank > 0`` adds the LoRA adapter tower (``train/lora.py``); stages 1
and 3 ignore the field, as the JAX trainer does. ``diffusion.unet.remat``
recomputes the UNet's blocks in the backward (``models/unet.py``).

Several processes (one per card): ``run_stage`` joins the job's process
group first (``parallel/distributed.py::initialize_distributed``, a no-op
in one process) and trains on a ``(data, model)`` mesh of its ranks
(``choose_mesh_axes``, ``cfg.train.model_parallel``). Each data rank reads
its shard of the training set (``PrefetchLoader(shard_index=,
num_shards=)``) and its gradients and metrics are averaged over the data
axis; the model ranks of one data index read the same samples, and the
wide Dense layers are column-parallel over them (``parallel/sharding.py``).
A rank is one card, so the port's global batch is ``batch_size`` times the
number of data ranks, where the JAX package's is ``batch_size`` times its
processes, each a host of several chips (ROADMAP known delta 20). Logging,
metrics and checkpoint files are the coordinator's; a checkpoint gathers
the sharded leaves first, and the other ranks wait at a barrier. The
validation batch count is the minimum over the ranks.
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
from clap2diffusion_tpu_torch.models.clap.frontend import log_mel_spectrogram
from clap2diffusion_tpu_torch.models.clap.htsat import ClapAudioTower
from clap2diffusion_tpu_torch.models.clip_text import CLIPTextEncoder
from clap2diffusion_tpu_torch.models.layers import DataSlice
from clap2diffusion_tpu_torch.models.tokenizer import CLIPTokenizer
from clap2diffusion_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_coordinator,
    process_count,
)
from clap2diffusion_tpu_torch.parallel.sharding import (
    all_mean,
    gather_rows,
    local_rows,
    make_sharded_step,
    make_train_mesh,
    replicate,
    shard_params,
)
from clap2diffusion_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from clap2diffusion_tpu_torch.train.lora import init_lora
from clap2diffusion_tpu_torch.train.stages import (
    BATCH_KEYS,
    MAKE_STAGE,
    TrainState,
    train_step,
)
from clap2diffusion_tpu_torch.utils.logging import MetricLogger


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
    def encode_audio(self, wav) -> torch.Tensor:
        """Waveforms [B, samples] -> CLAP embeddings [B, 512] (fp32)."""
        wav = torch.as_tensor(np.asarray(wav, np.float32), device=self.device)
        return self.clap(log_mel_spectrogram(wav, self.cfg.clap.frontend))

    @torch.no_grad()
    def encode_text(self, ids):
        """Token ids [B, 77] -> (text context [B, 77, 768], its mean over
        tokens [B, 768])."""
        ctx = self.clip(torch.as_tensor(np.asarray(ids, np.int32), device=self.device))
        return ctx, ctx.mean(dim=1)

    @torch.no_grad()
    def embed_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        dev = self.device
        latent = torch.as_tensor(np.asarray(batch["latent"], np.float32), device=dev)
        cached = self._load_cached(batch.get("audio_id", []))
        if cached is not None:
            return {**{k: torch.as_tensor(v, device=dev) for k, v in cached.items()},
                    "latent": latent}
        ctx, emb = self.encode_text(self.tokenizer(batch["caption"]))
        return {"clap": self.encode_audio(batch["audio"]), "latent": latent,
                "text_ctx": ctx, "text_emb": emb}

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


def choose_mesh_axes(n_dev: int, model_parallel: int, batch_size: int,
                     nproc: int) -> tuple:
    """The (data, model) mesh axis sizes for a training run (a copy of the
    JAX function, with its checks). One process: the data axis is the
    largest device count dividing the global batch. Several: the mesh must
    cover every process's devices, so all are used and the divisibility is
    checked. The port has one device per process (``n_dev == nproc``)."""
    mp = max(1, model_parallel)
    if n_dev % mp != 0:
        raise ValueError(f"model_parallel={mp} does not divide {n_dev} devices")
    global_batch = batch_size * nproc
    avail_dp = n_dev // mp
    if nproc > 1:
        dp = avail_dp
        if global_batch % dp != 0:
            raise ValueError(
                f"multi-host run: global batch {global_batch} "
                f"(batch_size {batch_size} x {nproc} processes) must be "
                f"divisible by the data axis {dp} "
                f"(= {n_dev} devices / model_parallel {mp})")
    else:
        dp = max(d for d in range(1, avail_dp + 1) if global_batch % d == 0)
    return dp, mp


class _NullLogger:
    """What a rank other than the coordinator logs to."""

    def log(self, step, metrics) -> None:
        pass

    def close(self) -> None:
        pass


def _barrier() -> None:
    if process_count() > 1:
        torch.distributed.barrier()


def _sharded_keys(st, params, mesh) -> set:
    """Shard each tower of the stage over the mesh's model axis (its
    module's wide Dense layers and ``params``' tensors of them, in place);
    the "tower.name" keys that were sharded."""
    keys = set()
    for tw, module in st.modules.items():
        local = shard_params(module, params[tw], mesh)
        keys |= {f"{tw}.{n}" for n, t in local.items() if t is not params[tw][n]}
        params[tw] = local
    return keys


def _full_state(state: TrainState, keys: set, mesh):
    """The state with every model-sharded leaf gathered whole (a collective:
    every rank calls it), for a checkpoint."""
    from types import SimpleNamespace

    def full(k, t):
        return gather_rows(t, mesh) if k in keys else t

    sd = state.opt.state_dict()
    opt = {**sd, **{part: None if sd[part] is None else
                    {k: full(k, t) for k, t in sd[part].items()}
                    for part in ("acc", "mu", "nu")}}
    return SimpleNamespace(
        params={tw: {n: full(f"{tw}.{n}", t) for n, t in p.items()}
                for tw, p in state.params.items()},
        opt=SimpleNamespace(state_dict=lambda: opt), step=state.step,
        ema=None if state.ema is None else {k: full(k, t) for k, t in state.ema.items()})


def stage_state(cfg: Config, stage: int, params: Dict, mesh, device, seed: int):
    """(stage, state, sharded keys): the stage's towers copied from
    ``params`` to ``device`` as fp32 masters (the trainable ones made equal
    to rank 0's, the LoRA tower drawn for stage 2 with ``lora_rank > 0``),
    sharded over ``mesh``'s model axis, and the state built on them."""
    st = MAKE_STAGE[stage](cfg)
    scfg = st.scfg
    masters = {tw: {n: t.detach().to(device, torch.float32, copy=True)
                    for n, t in params[tw].items()} for tw in st.towers if tw != "lora"}
    if "lora" in st.towers:
        # stage 2 only, as in JAX; A is drawn from the seed of the JAX key
        # (seed + 0x10A5), by a torch.Generator (ROADMAP known delta 16)
        masters["lora"] = init_lora(
            masters["unet"], scfg.lora_rank,
            torch.Generator(device=device).manual_seed(seed + 0x10A5), alpha=scfg.lora_alpha)
    # the trainable leaves start from rank 0's values; the frozen ones are
    # what every rank's caller drew or loaded alike
    replicate({tw: {n: t for n, t in sd.items() if st.trainable(f"{tw}.{n}")}
               for tw, sd in masters.items()}, mesh)
    sharded = _sharded_keys(st, masters, mesh)
    state = st.create_state(masters)
    state.opt.sharded = frozenset(k for k in sharded if k in state.opt.params)
    state.opt.shard_group = mesh.group("model")
    return st, state, sharded


def run_stage(cfg: Config, stage: int, params: Dict, data_root: Optional[str] = None,
              max_steps: Optional[int] = None, checkpoint_dir: Optional[str] = None,
              log_dir: Optional[str] = None, seed: Optional[int] = None,
              resume_from: Optional[str] = None, device=None) -> TrainState:
    """Run one training stage end to end; returns the final ``TrainState``.

    ``params``: tower -> state dict (any device and type; the stage copies
    its towers to ``device`` as fp32 masters, so the caller's tensors are
    never modified). ``max_steps`` counts micro-steps. ``resume_from``
    names a checkpoint in ``checkpoint_dir`` whose params, optimizer state
    and step are restored before continuing. ``device=None`` means CUDA
    (this rank's card in a job of several processes)."""
    if os.environ.get("C2D_INT8") == "1":
        # as the JAX run_stage: the quantisation's round() has zero gradient
        raise RuntimeError(
            "C2D_INT8=1 is a serve-only mode (clap2diffusion_tpu/ops/quant.py); unset it for "
            "training — the quantization round() has zero gradient.")
    initialize_distributed(device=device)
    dev = resolve_device(device)
    if stage not in MAKE_STAGE:
        raise ValueError(f"unknown stage {stage}")
    scfg = getattr(cfg.train, f"stage{stage}")
    seed = cfg.train.seed if seed is None else seed
    data_root = data_root or cfg.data.data_root
    steps = max_steps if max_steps is not None else scfg.steps

    nproc = process_count()
    dp, mp = choose_mesh_axes(nproc, cfg.train.model_parallel, scfg.batch_size, nproc)
    mesh = make_train_mesh(dp * mp, model_parallel=mp)
    st, state, sharded = stage_state(cfg, stage, params, mesh, dev, seed)
    if resume_from and checkpoint_dir:
        restore_checkpoint(checkpoint_dir, state, name=resume_from, trainable=st.trainable,
                           local=lambda k, t: local_rows(t, mesh) if k in sharded else t)
    frontend = EmbeddingFrontend(cfg, params, data_root=data_root, device=dev)
    loader = PrefetchLoader(_dataset(cfg, data_root, "train", cfg.data.pairing),
                            batch_size=scfg.batch_size, seed=seed, prefetch=cfg.data.prefetch,
                            shard_index=mesh.coord("data"), num_shards=dp)
    coordinator = is_coordinator()
    logger = (MetricLogger(log_dir or cfg.train.log_dir, run_name=f"stage{stage}")
              if coordinator else _NullLogger())
    keys = BATCH_KEYS[stage]
    spc = max(1, scfg.steps_per_call)
    generator = torch.Generator(device=dev).manual_seed(seed)
    if dp > 1:  # this rank's rows of the draws for the global batch
        generator = DataSlice(generator, mesh.coord("data"), dp)
    step_fn = train_step if mesh.devices == 1 else make_sharded_step(train_step, mesh)
    val = {"batches": None}

    def save(name: str) -> None:
        """Every rank gathers; the coordinator writes; the others wait."""
        full = _full_state(state, sharded, mesh) if sharded else state
        if coordinator:
            save_checkpoint(checkpoint_dir, full, name=name, trainable=st.trainable)
        _barrier()

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
            # the same shuffle on every rank, then each data rank's strided
            # share; the count agreed as the minimum over the ranks, since
            # the evaluation's collectives must pair up
            order = np.arange(len(ds) if ds else 0)
            np.random.RandomState(cfg.data.seed).shuffle(order)
            bs = scfg.batch_size
            nb = min(scfg.eval_batches, len(order) // (bs * dp))
            order = order[mesh.coord("data")::dp]
            if nproc > 1:
                nb_t = torch.tensor([nb], device="cpu" if torch.distributed.get_backend()
                                    == "gloo" else dev)
                torch.distributed.all_reduce(nb_t, op=torch.distributed.ReduceOp.MIN)
                nb = int(nb_t.item())
            val["batches"] = [
                {k: v for k, v in frontend.embed_batch(PrefetchLoader._collate(
                    [ds[int(i)] for i in order[b * bs:(b + 1) * bs]])).items() if k in keys}
                for b in range(nb)]
            if ds is not None and not val["batches"]:
                print(f"[run_stage] eval_every disabled: val split smaller than batch {bs} "
                      f"x {dp} data ranks")
        if not val["batches"]:
            return None
        es = with_ema(s)
        gen = torch.Generator(device=dev).manual_seed(seed ^ 0xE7A1)
        if dp > 1:
            gen = DataSlice(gen, mesh.coord("data"), dp)
        totals: Dict[str, list] = {}
        with torch.no_grad():
            for b in val["batches"]:
                for k, v in st.loss(es, b, gen)[1].items():
                    if torch.is_tensor(v) and v.dim() == 0:
                        totals.setdefault(k, []).append(float(v))
        means = {k: torch.tensor(float(np.mean(v)), dtype=torch.float64, device=dev)
                 for k, v in totals.items()}
        all_mean(means.values(), mesh.group("data"))
        return {"val_" + k: float(v) for k, v in means.items()}

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

    # the preemption save is collective, so the ranks agree on the signal
    # after every micro-step: one rank's signal stops them all at the same
    # micro-step. The flag goes over Gloo on the host, never syncing a card.
    flag_group = None
    if restore_sigs and nproc > 1 and torch.distributed.get_backend() != "gloo":
        flag_group = torch.distributed.new_group(backend="gloo")

    def preempting() -> Optional[int]:
        sig = caught["sig"]
        if restore_sigs and nproc > 1:
            t = torch.tensor([sig or 0], dtype=torch.int64)
            torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=flag_group)
            sig = int(t.item()) or None
        return sig

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
                metrics = step_fn(st, state, {k: emb[k] for k in keys}, generator)
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
                            save(f"stage{stage}_best")
                            if coordinator:
                                with open(best_sidecar, "w") as f:
                                    json.dump({"val_total": best_val, "step": done}, f)
                    if (checkpoint_dir and done % scfg.save_every < spc
                            and done >= scfg.save_every):
                        save(f"stage{stage}_step{done}")
                sig = preempting()
                if sig is not None:
                    caught["sig"] = None
                    save(f"stage{stage}_preempt")
                    logger.log(done, {"preempted_by_signal": float(sig)})
                    restore_signals()
                    restore_sigs.clear()
                    signal.raise_signal(sig)  # the caller's disposition: exit or raise
                if done >= steps:
                    break
            epoch += 1
        if checkpoint_dir:
            save(f"stage{stage}_final")
    finally:
        restore_signals()
        logger.close()
    return state
