"""The plain reference of one served image and of one stage-2 micro-step.

Serving: int16 PCM divided by its peak -> log-mel -> HTSAT -> the
hierarchical encoder (Norm-60 over every routed token of the request's
batch) -> CLIP text for the prompt and the empty negative -> 50 DDIM steps
(leading spacing, offset 1, eta 0) with classifier-free guidance -> VAE
decode -> (x + 1) * 127.5 clamped to [0, 255], not rounded. Float32
throughout; the caller switches TF32 off.

Training: stage 2 of the configuration (the decomposer, projector and
audio-injection leaves trainable), its loss, gradients, accumulation,
global-norm clip, AdamW with warmup-cosine and EMA, written out from the
formulas of optax's ``MultiSteps(chain(clip_by_global_norm, adamw))``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch.func import functional_call

from perfbench.reference.frontend import log_mel_spectrogram
from perfbench.reference.plain import rescale_to_norm
from perfbench.reference.temperature import temperature_at_step


def alphas_cumprod(sched, device) -> torch.Tensor:
    t = sched.num_train_timesteps
    if sched.beta_schedule == "scaled_linear":
        betas = torch.linspace(sched.beta_start ** 0.5, sched.beta_end ** 0.5, t,
                               dtype=torch.float32) ** 2
    else:
        betas = torch.linspace(sched.beta_start, sched.beta_end, t, dtype=torch.float32)
    return torch.cumprod(1.0 - betas, dim=0).to(device)


def ddim_grid(steps: int, train_steps: int) -> List[tuple]:
    ts = [int(t) for t in (np.arange(steps) * (train_steps // steps) + 1)[::-1]]
    return list(zip(ts, ts[1:] + [-1]))


def dequantize(wav: np.ndarray, device) -> torch.Tensor:
    """A waveform as the program receives it -> float32 [samples]: int16
    divided by its own peak (at least 1), float as it is."""
    w = torch.as_tensor(np.asarray(wav), device=device)
    if w.dtype != torch.int16:
        return w.float()
    w = w.float()
    return w / torch.clamp(w.abs().amax(), min=1.0)


class Reference:
    """The reference towers on ``device`` in float32, from ``weights``
    (tower -> state dict, any type: the values are taken as they are), as
    ``build`` (configuration -> tower -> module) makes them."""

    def __init__(self, cfg, weights: Dict[str, Dict[str, torch.Tensor]], device,
                 towers: Sequence[str], build: Callable[..., Dict[str, torch.nn.Module]]):
        self.cfg, self.device = cfg, torch.device(device)
        with torch.device("meta"):
            mods = build(cfg)
        for name in towers:
            m = mods[name]
            m.to_empty(device=self.device)
            m.load_state_dict({k: v.float() for k, v in weights[name].items()}, strict=True)
            m.float().eval().requires_grad_(False)
            setattr(self, name, m)
        self.alphas = alphas_cumprod(cfg.diffusion.scheduler, self.device)

    @torch.no_grad()
    def clap(self, wavs: Sequence[np.ndarray]) -> torch.Tensor:
        """[n, 512] CLAP embeddings of the waveforms."""
        wf = torch.stack([dequantize(w, self.device) for w in wavs])
        return self.clap_audio(log_mel_spectrogram(wf, self.cfg.clap.frontend))

    @torch.no_grad()
    def routed(self, wavs: Sequence[np.ndarray], temperature: float,
               norm_target: float) -> Dict[str, torch.Tensor]:
        """The routed audio tokens of one request's batch (one waveform per
        lane), each level rescaled to ``norm_target`` over the whole batch."""
        _, info = self.hierarchical(self.clap(wavs), temperature, return_all=True)
        return {lvl: rescale_to_norm(t, norm_target) for lvl, t in info["routed"].items()}

    @torch.no_grad()
    def image(self, latents: torch.Tensor, cond_ids: np.ndarray, uncond_ids: np.ndarray,
              routed: Dict[str, torch.Tensor], steps: int, guidance: float) -> torch.Tensor:
        """One lane: latents [1, h, w, 4], ids [1, 77], routed tokens [1, K, D]
        -> float image [1, H, W, 3] in [0, 255]."""
        ids = torch.as_tensor(np.concatenate([uncond_ids, cond_ids]).astype(np.int64),
                              device=self.device)
        ctx = self.clip_text(ids)
        audio = {k: torch.cat([v, v]) for k, v in routed.items()}
        x = latents.float()
        for t, t_prev in ddim_grid(steps, self.cfg.diffusion.scheduler.num_train_timesteps):
            tt = torch.full((2,), t, dtype=torch.int64, device=self.device)
            eps_u, eps_c = self.unet(torch.cat([x, x]), tt, ctx, audio).chunk(2)
            eps = eps_u + guidance * (eps_c - eps_u)
            a_t, a_p = self.alphas[t], self.alphas[max(t_prev, 0)]
            x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
            x = torch.sqrt(a_p) * x0 + torch.sqrt(1.0 - a_p) * eps
        img = self.vae.decode_latent(x)
        return torch.clamp((img + 1.0) * 127.5, 0.0, 255.0)


# -- stage-2 training -------------------------------------------------------

def stage2_trainable(name: str) -> bool:
    return any(s in name for s in ("decomposer", "projector", "audio_inject"))


def lr_at(scfg, count: int) -> float:
    """Warmup (linear from 0) then cosine to ``min_lr``, by update count."""
    warmup = max(scfg.warmup_steps, 1)
    decay = max(scfg.steps, scfg.warmup_steps + 1) - warmup
    if count < warmup:
        return scfg.lr * min(max(count, 0), warmup) / warmup
    alpha = 0.0 if scfg.lr == 0.0 else scfg.min_lr / scfg.lr
    c = min(count - warmup, decay)
    return scfg.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)


class Stage2:
    """fp32 stage-2 training of the reference towers ``hierarchical`` and
    ``unet`` (``clap_audio`` and ``clip_text`` frozen, as the frontend)."""

    def __init__(self, ref: Reference, scfg):
        self.ref, self.scfg = ref, scfg
        self.params = {}
        for tower in ("hierarchical", "unet"):
            for n, p in getattr(ref, tower).state_dict().items():
                name = f"{tower}.{n}"
                self.params[name] = p.clone().requires_grad_(stage2_trainable(name))
        self.train = {n: p for n, p in self.params.items() if p.requires_grad}
        self.acc = {n: torch.zeros_like(p) for n, p in self.train.items()}
        self.mu = {n: torch.zeros_like(p) for n, p in self.train.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.train.items()}
        self.ema = {n: p.detach().clone() for n, p in self.train.items()}
        self.mini, self.count, self.step = 0, 0, 0

    def _tower(self, tower: str) -> Dict[str, torch.Tensor]:
        pre = tower + "."
        return {n[len(pre):]: p for n, p in self.params.items() if n.startswith(pre)}

    def loss(self, wavs: np.ndarray, ids: np.ndarray, latents: torch.Tensor,
             generator: torch.Generator):
        ref, cond = self.ref, self.ref.cfg.condition
        with torch.no_grad():
            clap = ref.clap(list(wavs))
            ctx = ref.clip_text(torch.as_tensor(ids.astype(np.int64), device=ref.device))
        temperature = temperature_at_step(
            self.step, cond.temperature_initial, cond.temperature_final,
            cond.temperature_anneal_steps, cond.temperature_warmup_steps,
            cond.temperature_schedule)
        _, info = functional_call(ref.hierarchical, self._tower("hierarchical"), (clap,),
                                  {"temperature": temperature, "return_all": True,
                                   "deterministic": False, "generator": generator})
        t = torch.randint(0, ref.cfg.diffusion.scheduler.num_train_timesteps,
                          (latents.shape[0],), generator=generator, device=ref.device)
        noise = torch.randn(latents.shape, generator=generator, device=ref.device,
                            dtype=latents.dtype)
        a = ref.alphas[t].reshape(-1, 1, 1, 1)
        noisy = a.sqrt() * latents + (1.0 - a).sqrt() * noise
        eps = functional_call(ref.unet, self._tower("unet"), (noisy, t, ctx, info["routed"]))
        losses = {"diffusion": ((eps - noise) ** 2).mean(),
                  "orthogonality": info["losses"]["orthogonality"],
                  "entropy": info["losses"]["entropy"]}
        total = sum(w * losses[k] for k, w in self.scfg.loss_weights.__dict__.items()
                    if k in losses)
        return total

    def micro_step(self, wavs, ids, latents, generator) -> Dict[str, object]:
        """One micro-step; returns its loss and gradients (name -> tensor)."""
        total = self.loss(wavs, ids, latents, generator)
        names = list(self.train)
        grads = torch.autograd.grad(total, [self.train[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(self.train[n]) if g is None else g
                 for n, g in zip(names, grads)}
        s = self.scfg
        with torch.no_grad():
            for n, g in grads.items():
                self.acc[n].add_((g - self.acc[n]) / (self.mini + 1))
            self.mini += 1
            if self.mini == s.grad_accum:
                self.mini = 0
                g = {n: a.clone() for n, a in self.acc.items()}
                for a in self.acc.values():
                    a.zero_()
                norm = torch.sqrt(sum((v * v).sum() for v in g.values()))
                clip = norm >= s.grad_clip
                lr = lr_at(s, self.count)
                self.count += 1
                bc1, bc2 = 1 - s.adam_b1 ** self.count, 1 - s.adam_b2 ** self.count
                for n, p in self.train.items():
                    gn = torch.where(clip, g[n] / norm * s.grad_clip, g[n])
                    self.mu[n].mul_(s.adam_b1).add_((1 - s.adam_b1) * gn)
                    self.nu[n].mul_(s.adam_b2).add_((1 - s.adam_b2) * gn * gn)
                    u = ((self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + s.adam_eps)
                         + s.weight_decay * p)
                    p.add_(-lr * u)
            for n, e in self.ema.items():
                e.copy_(s.ema_decay * e + (1.0 - s.ema_decay) * self.train[n])
        self.step += 1
        return {"loss": float(total.detach()), "grads": grads}
