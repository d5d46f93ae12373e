"""Optimizer stack (port of ``clap2diffusion_tpu/train/optim.py``):
warmup-cosine learning rate, global-norm clipping, AdamW, gradient
accumulation, EMA, the adaptive loss balancer and adaptive clipping.

``Optimizer`` reproduces the JAX package's
``masked(MultiSteps(chain(clip_by_global_norm, adamw)))`` step for step, in
optax's own formulas and order of operations:

- only trainable leaves get state (accumulator and Adam moments); frozen
  leaves are never handed to it;
- accumulation as ``optax.MultiSteps``: a running mean
  ``acc += (g - acc) / (mini_step + 1)`` over ``grad_accum`` micro-steps,
  then one clip + AdamW update; the learning-rate schedule and Adam's bias
  correction count updates, not micro-steps;
- ``optax.clip_by_global_norm``: the norm over all trainable leaves, and
  ``g / norm * max_norm`` only when the norm is not below ``max_norm``;
- ``optax.adamw``: eps added after the square root, decay ``wd * p`` added
  to the Adam direction, the sum scaled by ``-lr(count)`` with the count of
  updates before this one.

Parameters are fp32 masters updated in place under ``torch.no_grad``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable

import torch

from clap2diffusion_tpu_torch.core.config import StageConfig


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)
    return schedule


def lr_schedule(cfg: StageConfig) -> Callable[[int], float]:
    """Learning rate as a function of the update count (optax's schedules:
    warmup-cosine's ``decay_steps`` counts the warmup)."""
    if cfg.lr_schedule == "warmup_cosine":
        warmup = max(cfg.warmup_steps, 1)
        decay = max(cfg.steps, cfg.warmup_steps + 1)
        alpha = 0.0 if cfg.lr == 0.0 else cfg.min_lr / cfg.lr
        warm, cos = _linear(0.0, cfg.lr, warmup), _cosine(cfg.lr, decay - warmup, alpha)
        return lambda count: warm(count) if count < warmup else cos(count - warmup)
    if cfg.lr_schedule == "cosine":
        return _cosine(cfg.lr, max(cfg.steps, 1), cfg.min_lr / cfg.lr if cfg.lr > 0 else 0.0)
    if cfg.lr_schedule == "constant":
        return lambda count: cfg.lr
    raise ValueError(f"unknown lr schedule {cfg.lr_schedule!r}")


class Optimizer:
    """clip + AdamW under gradient accumulation, over ``params`` (name ->
    fp32 tensor, the trainable leaves only)."""

    def __init__(self, cfg: StageConfig, params: Dict[str, torch.Tensor]):
        self.cfg = cfg
        self.params = params
        self.schedule = lr_schedule(cfg)
        self.mini_step = 0
        self.count = 0  # updates applied
        zeros = lambda: {n: torch.zeros_like(p, memory_format=torch.preserve_format)
                         for n, p in params.items()}
        self.acc = zeros() if cfg.grad_accum > 1 else None
        self.mu, self.nu = zeros(), zeros()

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> bool:
        """One micro-step; returns True when it applied an update."""
        if self.acc is not None:
            for n, g in grads.items():
                acc = self.acc[n]
                acc.add_((g - acc) / (self.mini_step + 1))
            emit = self.mini_step == self.cfg.grad_accum - 1
            self.mini_step = (self.mini_step + 1) % self.cfg.grad_accum
            if not emit:
                return False
            grads = {n: a.clone() for n, a in self.acc.items()}
            for a in self.acc.values():
                a.zero_()
        self._update(grads)
        return True

    def _update(self, grads: Dict[str, torch.Tensor]) -> None:
        c = self.cfg
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = norm >= c.grad_clip
        lr = self.schedule(self.count)
        self.count += 1
        bc1, bc2 = 1 - c.adam_b1 ** self.count, 1 - c.adam_b2 ** self.count
        for n, p in self.params.items():
            g = grads[n]
            g = torch.where(clip, g / norm * c.grad_clip, g)
            mu, nu = self.mu[n], self.nu[n]
            mu.copy_((1 - c.adam_b1) * g + c.adam_b1 * mu)
            nu.copy_((1 - c.adam_b2) * (g * g) + c.adam_b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + c.adam_eps) + c.weight_decay * p
            p.add_(-lr * u)

    def state_dict(self) -> Dict:
        return {"mini_step": self.mini_step, "count": self.count, "acc": self.acc,
                "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        self.mini_step, self.count = int(sd["mini_step"]), int(sd["count"])
        for mine, theirs in ((self.acc, sd["acc"]), (self.mu, sd["mu"]), (self.nu, sd["nu"])):
            if (mine is None) != (theirs is None):
                raise ValueError("checkpoint optimizer state does not match grad_accum")
            for n, t in (mine or {}).items():
                t.copy_(theirs[n])


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> None:
    """In place: e = decay * e + (1 - decay) * p for every shadowed leaf."""
    for n, e in ema.items():
        e.copy_(decay * e + (1.0 - decay) * params[n])


class LossBalancer:
    """Inverse-magnitude loss reweighting, refreshed every ``update_every``
    calls from the running magnitudes (host-side state)."""

    def __init__(self, loss_names: Iterable[str], update_every: int = 100):
        self.names = list(loss_names)
        self.update_every = update_every
        self.history: Dict[str, list] = {n: [] for n in self.names}
        self.weights: Dict[str, float] = {n: 1.0 for n in self.names}
        self._step = 0

    def update(self, losses: Dict[str, float]) -> Dict[str, float]:
        self._step += 1
        for n in self.names:
            if n in losses:
                self.history[n].append(float(losses[n]))
                self.history[n] = self.history[n][-self.update_every:]
        if self._step % self.update_every == 0:
            mags = {n: (sum(h) / len(h) if h else 1.0) for n, h in self.history.items()}
            total = sum(abs(m) for m in mags.values()) + 1e-8
            k = len(self.names)
            self.weights = {n: total / (k * (abs(m) + 1e-8)) for n, m in mags.items()}
        return dict(self.weights)


class AdaptiveClip:
    """Clip to mean + 2 std of the last ``history`` global norms once
    ``min_samples`` norms are seen, to ``max_norm`` before that."""

    def __init__(self, max_norm: float, history: int = 100, min_samples: int = 10):
        self.max_norm, self.history, self.min_samples = max_norm, history, min_samples
        self.norms = torch.zeros(history, dtype=torch.float32)
        self.count = 0

    @torch.no_grad()
    def __call__(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        g_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values())).cpu()
        valid = self.norms[:min(self.count, self.history)]
        n = max(len(valid), 1)
        mean = valid.sum() / n
        var = ((valid - mean) ** 2).sum() / n
        threshold = mean + 2.0 * torch.sqrt(var) if self.count >= self.min_samples \
            else torch.tensor(self.max_norm)
        threshold = torch.clamp(threshold, min=1e-6)
        scale = torch.clamp(threshold / (g_norm + 1e-6), max=1.0)
        self.norms[self.count % self.history] = g_norm
        self.count += 1
        return {k: g * scale.to(g.device, g.dtype) for k, g in grads.items()}
