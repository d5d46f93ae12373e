"""Noise schedule, DDIM sampler and folded CFG (port of the DDIM part of
``clap2diffusion_tpu/diffusion/ddim.py``).

SD v1.5 scaled-linear betas (0.00085 -> 0.012, 1000 steps), leading-spaced
inference timesteps with steps_offset 1, eta=0, epsilon prediction. The JAX
loop is one ``lax.scan``; here it is a Python loop. The other samplers of
the JAX package are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from clap2diffusion_tpu_torch.core.config import SchedulerConfig


@dataclass(frozen=True)
class NoiseSchedule:
    alphas_cumprod: torch.Tensor  # [T] float32
    num_train_timesteps: int

    @classmethod
    def create(cls, cfg: SchedulerConfig, device=None) -> "NoiseSchedule":
        t = cfg.num_train_timesteps
        if cfg.beta_schedule == "scaled_linear":
            betas = torch.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, t,
                                   dtype=torch.float32) ** 2
        elif cfg.beta_schedule == "linear":
            betas = torch.linspace(cfg.beta_start, cfg.beta_end, t, dtype=torch.float32)
        else:
            raise ValueError(f"unknown beta schedule {cfg.beta_schedule!r}")
        alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
        return cls(alphas_cumprod=alphas_cumprod.to(device), num_train_timesteps=t)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Forward diffusion q(x_t | x_0); ``t`` is integer [B]."""
        a = self.alphas_cumprod[t]
        shape = (-1,) + (1,) * (x0.dim() - 1)
        sqrt_a = a.sqrt().reshape(shape).to(x0.dtype)
        sqrt_1ma = (1.0 - a).sqrt().reshape(shape).to(x0.dtype)
        return sqrt_a * x0 + sqrt_1ma * noise


def ddim_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000,
                   steps_offset: int = 1) -> torch.Tensor:
    """Leading-spaced DDIM timesteps, descending."""
    step = num_train_timesteps // num_inference_steps
    t = torch.arange(num_inference_steps, dtype=torch.int64) * step + steps_offset
    return t.flip(0).to(torch.int32)


def ddim_step(schedule: NoiseSchedule, latents: torch.Tensor, eps: torch.Tensor,
              t: int, t_prev: int) -> torch.Tensor:
    """One deterministic DDIM update (eta=0). ``t_prev < 0`` is the final
    step; alpha_prev then is alphas_cumprod[0] (set_alpha_to_one=False)."""
    ac = schedule.alphas_cumprod
    a_t = ac[t]
    a_prev = ac[t_prev] if t_prev >= 0 else ac[0]
    lat32 = latents.float()
    eps32 = eps.float()
    x0 = (lat32 - torch.sqrt(1.0 - a_t) * eps32) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(1.0 - a_prev) * eps32
    return (torch.sqrt(a_prev) * x0 + dir_xt).to(latents.dtype)


def ddim_sample(eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
                schedule: NoiseSchedule, latents: torch.Tensor,
                num_inference_steps: int = 50,
                timesteps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The DDIM loop; ``eps_fn(latents, t)`` predicts epsilon (CFG folded
    inside, see ``cfg_eps_fn``)."""
    ts = (ddim_timesteps(num_inference_steps, schedule.num_train_timesteps)
          if timesteps is None else timesteps).tolist()
    for t, t_prev in zip(ts, ts[1:] + [-1]):
        latents = ddim_step(schedule, latents, eps_fn(latents, t), t, t_prev)
    return latents


SAMPLERS = {"ddim": ddim_sample}


def _cat(a: Optional[Dict], b: Optional[Dict]):
    if a is None and b is None:
        return None
    if isinstance(a, dict):
        return {k: torch.cat([a[k], b[k]], dim=0) for k in a}
    return torch.cat([a, b], dim=0)


def cfg_eps_fn(unet_apply: Callable, context_cond, context_uncond,
               guidance_scale: float, audio_cond=None, audio_uncond=None,
               guidance_rescale: float = 0.0):
    """An eps_fn that folds classifier-free guidance into ONE batched UNet
    forward: [uncond; cond] along the batch axis. ``guidance_rescale`` in
    [0, 1] is the CFG-rescale of Lin et al. 2023 (eq. 15-16); 0.0 is plain
    CFG. The guided prediction is formed in float32, as the JAX program
    forms it from its float32 guidance scale."""
    ctx = _cat(context_uncond, context_cond)
    audio = _cat(audio_uncond, audio_cond)
    w = float(guidance_rescale)

    def eps_fn(latents: torch.Tensor, t: int) -> torch.Tensor:
        b = latents.shape[0]
        lat2 = torch.cat([latents, latents], dim=0)
        t2 = torch.full((2 * b,), int(t), dtype=torch.int32, device=latents.device)
        eps2 = unet_apply(lat2, t2, ctx, audio)
        eps_u, eps_c = eps2[:b], eps2[b:]
        g32 = eps_u.float() + float(guidance_scale) * (eps_c - eps_u).float()
        c32 = eps_c.float()
        axes = tuple(range(1, g32.dim()))
        std_c = c32.std(dim=axes, keepdim=True, correction=0)
        std_g = g32.std(dim=axes, keepdim=True, correction=0).clamp_min(1e-8)
        return w * (g32 * (std_c / std_g)) + (1.0 - w) * g32

    return eps_fn
