"""Stage 1/2/3 training steps (port of ``clap2diffusion_tpu/train/stages.py``).

- Stage 1 trains the AudioAdapter on (CLAP, text embedding) pairs: MSE +
  InfoNCE.
- Stage 2 trains the hierarchical decomposer and projector and the UNet's
  audio-injection branches, with the UNet body frozen: diffusion MSE + 0.1
  orthogonality + 0.01 entropy, the assignment temperature annealed by the
  micro-step count. With ``train.stage2.lora_rank > 0`` it also trains LoRA
  adapters of the cross-attention projections (``train/lora.py``), a
  ``"lora"`` tower folded into the UNet's compute-type weights on every
  micro-step, after the cast.
- Stage 3 trains the leaves the JAX predicate selects (projector
  ``out_proj``/``out_norm``, every ``output_proj``; see
  ``stage3_trainable``): 2.0 diffusion + 0.5 consistency + 0.3 alignment,
  Norm-60 applied in the loop.

Parameters live in ``TrainState.params``, a dict tower -> name -> fp32
master tensor (the port's state-dict names); trainable leaves have
``requires_grad`` and everything else does not, which is the JAX package's
``_stop_frozen``: autograd builds no weight gradient for a frozen leaf and
no graph at all where no trainable leaf is upstream. Modules are applied
functionally (``torch.func.functional_call``) on these tensors.

Mixed precision (``_compute_cast``): the UNet forward and backward run in
``cfg.train.compute_dtype`` (bf16 by default); its trainable leaves are cast
on every micro-step through a differentiable ``.to()``, so their gradients
come back fp32. The frozen UNet body is cast once, when the state is
created: it never changes, so the numbers are those of casting it on every
step. Cached fp16 text contexts are cast to the compute type as well.
Losses are fp32. Dropout (rate 0.1) is on in the hierarchical encoder and
the stage-1 adapter, drawn from the step's ``torch.Generator``; the UNet's
injection dropout stays off, as the JAX step applies the UNet
deterministically.

``TrainState.step`` counts micro-steps; the optimizer applies one update
every ``grad_accum`` of them (``train/optim.py``), and the EMA shadow is
updated on every micro-step, as the JAX ``_apply_updates`` does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from clap2diffusion_tpu_torch.core.config import Config
from clap2diffusion_tpu_torch.diffusion.ddim import NoiseSchedule
from clap2diffusion_tpu_torch.models.condition.adapter import AudioAdapter
from clap2diffusion_tpu_torch.models.condition.hierarchical import HierarchicalAudioEncoder
from clap2diffusion_tpu_torch.models.condition.temperature import temperature_from_config
from clap2diffusion_tpu_torch.models.layers import draw
from clap2diffusion_tpu_torch.models.unet import UNet2DCondition
from clap2diffusion_tpu_torch.ops.token_norm import rescale_to_norm
from clap2diffusion_tpu_torch.parallel.sharding import all_mean
from clap2diffusion_tpu_torch.train import losses as L
from clap2diffusion_tpu_torch.train.lora import lora_trainable, merge_lora
from clap2diffusion_tpu_torch.train.optim import Optimizer, ema_update

Params = Dict[str, Dict[str, torch.Tensor]]
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def stage1_trainable(name: str) -> bool:
    return True  # the whole adapter


def stage2_trainable(name: str) -> bool:
    """JAX ``path_matcher("decomposer", "projector", "audio_inject")``."""
    return any(s in name for s in ("decomposer", "projector", "audio_inject"))


def stage3_trainable(name: str) -> bool:
    """The JAX stage-3 predicate, which tests substrings of the joined flax
    path: ``projector`` with ``out_proj`` or ``out_norm``, or any
    ``output_proj``. On flax paths that selects the projector's
    ``out_proj``/``out_norm``, every projector block's attention
    ``out_proj``, the decomposer's ``cross_hierarchy_attn/output_proj`` and
    the adapter's ``output_proj`` (not its ``output_norm``). The adapter's
    torch names keep both under ``output_proj.{0,1}``, so its LayerNorm
    (``output_proj.1``) is excluded by name."""
    if name.startswith("adapter."):
        return ".output_proj.0." in name
    return (("projector" in name and ("out_proj" in name or "out_norm" in name))
            or "output_proj" in name)


def _cast_to(x, dtype: torch.dtype):
    """fp32 and fp16 tensors go to the compute type; others pass."""
    if isinstance(x, dict):
        return {k: _cast_to(v, dtype) for k, v in x.items()}
    if isinstance(x, torch.Tensor) and x.dtype in (torch.float32, torch.float16):
        return x.to(dtype)
    return x


def sample_noising(schedule: NoiseSchedule, latents: torch.Tensor,
                   generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(noise, t): standard normal noise like the latents and integer
    timesteps in [0, T), both from ``generator`` (a ``DataSlice`` of one
    under data parallelism)."""
    t = draw(lambda shape, **kw: torch.randint(0, schedule.num_train_timesteps, shape, **kw),
             (latents.shape[0],), generator, device=latents.device)
    noise = draw(torch.randn, latents.shape, generator, device=latents.device,
                 dtype=latents.dtype)
    return noise, t


@dataclass
class TrainState:
    """fp32 master parameters, optimizer state, micro-step count and the
    EMA shadow of the trainable leaves (``"tower.name"`` keys)."""

    params: Params
    opt: Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None
    # frozen leaves of the compute-type towers, cast once (never saved)
    frozen_compute: Params = field(default_factory=dict)

    def trainable_leaves(self) -> Dict[str, torch.Tensor]:
        return {f"{tw}.{n}": t for tw, sd in self.params.items()
                for n, t in sd.items() if t.requires_grad}


class Stage:
    """One stage's modules, trainable predicate and loss."""

    def __init__(self, cfg: Config, number: int, towers: Tuple[str, ...],
                 trainable: Callable[[str], bool], loss: Callable,
                 compute_towers: Tuple[str, ...] = ()):
        self.cfg, self.number, self.towers = cfg, number, towers
        self.scfg = getattr(cfg.train, f"stage{number}")
        self.trainable = trainable
        self.compute_towers = compute_towers
        self.compute_dtype = _DTYPES[cfg.train.compute_dtype]
        self._loss = loss
        builders = {
            "adapter": lambda: AudioAdapter(cfg.condition),
            "hierarchical": lambda: HierarchicalAudioEncoder(cfg.condition),
            "unet": lambda: UNet2DCondition(cfg.diffusion.unet),
        }
        with torch.device("meta"):  # the "lora" tower has no module of its own
            self.modules: Dict[str, nn.Module] = {t: builders[t]() for t in towers
                                                  if t in builders}
        self.schedule: Optional[NoiseSchedule] = None

    def create_state(self, params: Params) -> TrainState:
        """Take ``params`` (tower -> name -> tensor; fp32 masters on the
        training device, owned by the state from here on), mark the
        trainable leaves and build the optimizer and the EMA shadow."""
        for tw, sd in params.items():
            for n, t in sd.items():
                t.requires_grad_(self.trainable(f"{tw}.{n}"))
        state = TrainState(params=params, opt=None)
        leaves = state.trainable_leaves()
        state.opt = Optimizer(self.scfg, leaves)
        if self.scfg.use_ema:
            state.ema = {k: t.detach().clone() for k, t in leaves.items()}
        with torch.no_grad():
            for tw in self.compute_towers:
                state.frozen_compute[tw] = {
                    n: (t.to(self.compute_dtype).contiguous(memory_format=torch.channels_last)
                        if t.dim() == 4 else t.to(self.compute_dtype))
                    for n, t in params[tw].items() if not t.requires_grad
                }
        return state

    def apply(self, state: TrainState, tower: str, *args, **kwargs):
        """Run a tower's module on the state's tensors; a compute-type tower
        gets its trainable leaves cast (differentiably) on this call, and
        the UNet the LoRA adapters folded in after the cast, as the JAX
        step folds them."""
        sd = state.params[tower]
        if tower in self.compute_towers:
            frozen = state.frozen_compute[tower]
            sd = {**frozen, **{n: t.to(self.compute_dtype) for n, t in sd.items()
                               if n not in frozen}}
        if tower == "unet" and "lora" in state.params:
            sd = merge_lora(sd, state.params["lora"])
        return functional_call(self.modules[tower], sd, args, kwargs)

    def loss(self, state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator], noising=None, deterministic: bool = False):
        """(total, losses) at ``state.step``. ``noising`` = (noise, t) replaces
        the draw from ``generator``; ``deterministic=True`` turns dropout
        off (both for tests)."""
        if self.schedule is None and self.number > 1:
            self.schedule = NoiseSchedule.create(self.cfg.diffusion.scheduler,
                                                 device=batch["latent"].device)
        return self._loss(self, state, batch, generator, noising, deterministic)

    def _unet_eps(self, state, batch, routed, generator, noising):
        latents = batch["latent"]
        noise, t = noising if noising is not None else sample_noising(
            self.schedule, latents, generator)
        noisy = self.schedule.add_noise(latents, noise, t)
        cdt = self.compute_dtype
        eps = self.apply(state, "unet", _cast_to(noisy, cdt), t,
                         _cast_to(batch["text_ctx"], cdt), _cast_to(routed, cdt))
        return L.diffusion_mse(eps.float(), noise)


def _stage1_loss(stage: Stage, state, batch, generator, noising, deterministic):
    tokens = stage.apply(state, "adapter", batch["clap"], deterministic=deterministic,
                         generator=generator)
    losses = L.stage1_losses(tokens, batch["text_emb"], stage.cfg.train.infonce_temperature)
    return losses["total"], losses


def _stage2_loss(stage: Stage, state, batch, generator, noising, deterministic):
    temperature = temperature_from_config(state.step, stage.cfg.condition)
    _, info = stage.apply(state, "hierarchical", batch["clap"], temperature, return_all=True,
                          deterministic=deterministic, generator=generator)
    losses = {
        "diffusion": stage._unet_eps(state, batch, info["routed"], generator, noising),
        "orthogonality": info["losses"]["orthogonality"],
        "entropy": info["losses"]["entropy"],
        "prior": info["losses"]["prior"],
    }
    total = L.weighted_total(losses, stage.scfg.loss_weights)
    losses["total"] = total
    losses["temperature"] = torch.tensor(temperature)
    return total, losses


def _stage3_loss(stage: Stage, state, batch, generator, noising, deterministic):
    c = stage.cfg.condition
    adapter_tokens = rescale_to_norm(stage.apply(state, "adapter", batch["clap"]),
                                     c.audio_norm_target)
    _, info = stage.apply(state, "hierarchical", batch["clap"], c.temperature_final,
                          return_all=True, deterministic=deterministic, generator=generator)
    routed = {k: rescale_to_norm(v, c.audio_norm_target) for k, v in info["routed"].items()}
    losses = {
        "diffusion": stage._unet_eps(state, batch, routed, generator, noising),
        "consistency": L.consistency_loss(info["routed"]),
        "alignment": L.alignment_loss(adapter_tokens, batch["text_emb"]),
    }
    total = L.weighted_total(losses, stage.scfg.loss_weights)
    losses["total"] = total
    return total, losses


def make_stage1_step(cfg: Config) -> Stage:
    """The 16-token AudioAdapter on (clap, text_emb) pairs."""
    return Stage(cfg, 1, ("adapter",), stage1_trainable, _stage1_loss)


def stage2_lora_trainable(name: str) -> bool:
    """Stage 2 with LoRA: the base predicate or an adapter matrix."""
    return stage2_trainable(name) or lora_trainable(name)


def make_stage2_step(cfg: Config) -> Stage:
    """Hierarchical encoder + UNet injection branches; frozen UNet body;
    with ``lora_rank > 0`` the ``"lora"`` adapter tower too."""
    if cfg.train.stage2.lora_rank > 0:
        return Stage(cfg, 2, ("hierarchical", "unet", "lora"), stage2_lora_trainable,
                     _stage2_loss, compute_towers=("unet",))
    return Stage(cfg, 2, ("hierarchical", "unet"), stage2_trainable, _stage2_loss,
                 compute_towers=("unet",))


def make_stage3_step(cfg: Config) -> Stage:
    """Output-layer fine-tune with Norm-60 in the loop."""
    return Stage(cfg, 3, ("hierarchical", "adapter", "unet"), stage3_trainable, _stage3_loss,
                 compute_towers=("unet",))


MAKE_STAGE = {1: make_stage1_step, 2: make_stage2_step, 3: make_stage3_step}
BATCH_KEYS = {1: ("clap", "text_emb"), 2: ("clap", "latent", "text_ctx"),
              3: ("clap", "latent", "text_ctx", "text_emb")}


def grads_of(total: torch.Tensor, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """d total / d leaf for every trainable leaf; a leaf the loss does not
    reach gets zeros, as in JAX."""
    names = list(leaves)
    grads = torch.autograd.grad(total, [leaves[n] for n in names], allow_unused=True)
    return {n: torch.zeros_like(leaves[n]) if g is None else g for n, g in zip(names, grads)}


def train_step(stage: Stage, state: TrainState, batch: Dict[str, torch.Tensor],
               generator: torch.Generator, mesh=None) -> Dict[str, torch.Tensor]:
    """One micro-step: loss, gradients, optimizer (an update every
    ``grad_accum`` micro-steps), EMA, step + 1. Returns the step's scalar
    metrics as device tensors (no host sync). On a ``mesh`` with a data
    axis the gradients and the metrics are averaged over it
    (``parallel/sharding.py``): the mean over the global batch."""
    total, losses = stage.loss(state, batch, generator)
    leaves = state.trainable_leaves()
    grads = grads_of(total, leaves)
    group = None if mesh is None else mesh.group("data")
    all_mean(grads.values(), group)
    state.opt.step(grads)
    if state.ema is not None:
        ema_update(state.ema, leaves, stage.scfg.ema_decay)
    state.step += 1
    metrics = {k: v.detach() for k, v in losses.items() if torch.is_tensor(v) and v.dim() == 0}
    if group is not None:
        metrics = {k: v.float().clone() for k, v in metrics.items()}
        all_mean(metrics.values(), group)
    return metrics
