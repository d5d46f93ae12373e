"""Noise schedule, the samplers and folded CFG (port of
``clap2diffusion_tpu/diffusion/ddim.py``).

SD v1.5 scaled-linear betas (0.00085 -> 0.012, 1000 steps), leading-spaced
inference timesteps with steps_offset 1, epsilon prediction. Each JAX
sampler is one ``lax.scan`` inside the request's one compiled program;
here each is a Python loop with one UNet call per step, which on CUDA runs
once, while ``diffusion/program.py`` captures the request's program into a
CUDA graph that every later request of its signature replays. ``SAMPLERS``
holds the four of the JAX package under its names, with its uniform
signature ``(eps_fn, schedule, latents, num_inference_steps,
timesteps=None, blend_fn=None, rng=None)``:

- ``ddim``: eta=0.
- ``dpmpp_2m``: DPM-Solver++(2M), first order on the first step, in fp32.
- ``dpmpp_2m_karras``: the same on the Karras sigma grid.
- ``euler_a``: DDIM with eta=1, stochastic.

``timesteps`` overrides the grid (img2img runs its tail; ``generate``
passes every grid as Python ints, so that the loop reads no tensor on the
host), ``blend_fn(lat, t_prev)`` post-processes each update (inpainting),
and ``rng`` is the stochastic sampler's noise: a draw callable ``rng(i,
shape)`` -> fp32 standard normals for step ``i`` (see ``generator_draw``).
The deterministic samplers ignore it. The JAX package draws with threefry
from ``fold_in(key, i)``; the port's draws come from ``torch.Generator``s,
and ``generate`` draws them ahead of the program (``predraw``), which then
reads them from one stacked tensor (``stacked_draw``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from clap2diffusion_tpu_torch.core.config import SchedulerConfig
from clap2diffusion_tpu_torch.models.layers import DataSlice, draw as sliced_draw

Draw = Callable[[int, tuple], torch.Tensor]
Blend = Callable[[torch.Tensor, int], torch.Tensor]


@dataclass(frozen=True)
class NoiseSchedule:
    alphas_cumprod: torch.Tensor  # [T] float32, on the device
    num_train_timesteps: int
    # the same values on the host, for grids computed in numpy without a
    # device round trip (karras_timesteps)
    host_alphas_cumprod: np.ndarray = field(compare=False, repr=False)

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
        return cls(alphas_cumprod=alphas_cumprod.to(device), num_train_timesteps=t,
                   host_alphas_cumprod=alphas_cumprod.numpy())

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Forward diffusion q(x_t | x_0); ``t`` is integer [B]."""
        a = self.alphas_cumprod[t]
        shape = (-1,) + (1,) * (x0.dim() - 1)
        sqrt_a = a.sqrt().reshape(shape).to(x0.dtype)
        sqrt_1ma = (1.0 - a).sqrt().reshape(shape).to(x0.dtype)
        return sqrt_a * x0 + sqrt_1ma * noise

    def alpha_prev(self, t_prev: int) -> torch.Tensor:
        """alphas_cumprod at ``t_prev``; at the final step (``t_prev < 0``)
        alphas_cumprod[0] (set_alpha_to_one=False, the SD v1.5 scheduler)."""
        return self.alphas_cumprod[max(t_prev, 0)]


def ddim_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000,
                   steps_offset: int = 1) -> torch.Tensor:
    """Leading-spaced DDIM timesteps, descending."""
    step = num_train_timesteps // num_inference_steps
    t = torch.arange(num_inference_steps, dtype=torch.int64) * step + steps_offset
    return t.flip(0).to(torch.int32)


def ddim_step(schedule: NoiseSchedule, latents: torch.Tensor, eps: torch.Tensor,
              t: int, t_prev: int) -> torch.Tensor:
    """One deterministic DDIM update (eta=0)."""
    a_t = schedule.alphas_cumprod[t]
    a_prev = schedule.alpha_prev(t_prev)
    lat32 = latents.float()
    eps32 = eps.float()
    x0 = (lat32 - torch.sqrt(1.0 - a_t) * eps32) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(1.0 - a_prev) * eps32
    return (torch.sqrt(a_prev) * x0 + dir_xt).to(latents.dtype)


def img2img_timesteps(num_inference_steps: int, strength: float,
                      num_train_timesteps: int = 1000) -> torch.Tensor:
    """The tail of the DDIM grid for SDEdit img2img: the last
    ``round(steps * strength)`` timesteps (at least one), ``strength`` in
    (0, 1]; the init latent is noised to the first of them."""
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    ts = ddim_timesteps(num_inference_steps, num_train_timesteps)
    k = min(num_inference_steps, max(1, round(num_inference_steps * strength)))
    return ts[num_inference_steps - k:]


def _grid(schedule: NoiseSchedule, num_inference_steps: int,
          timesteps: Optional[Union[torch.Tensor, Sequence[int]]]):
    """(t, t_prev) pairs of the grid (``timesteps``: a tensor or ints),
    ``t_prev = -1`` at the final step."""
    ts = (ddim_timesteps(num_inference_steps, schedule.num_train_timesteps)
          if timesteps is None else timesteps)
    ts = [int(t) for t in ts]
    return list(zip(ts, ts[1:] + [-1]))


def ddim_sample(eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
                schedule: NoiseSchedule, latents: torch.Tensor,
                num_inference_steps: int = 50, timesteps: Optional[torch.Tensor] = None,
                blend_fn: Optional[Blend] = None, rng: Optional[Draw] = None) -> torch.Tensor:
    """The DDIM loop; ``eps_fn(latents, t)`` predicts epsilon (CFG folded
    inside, see ``cfg_eps_fn``). Deterministic: ``rng`` is ignored."""
    del rng
    for t, t_prev in _grid(schedule, num_inference_steps, timesteps):
        latents = ddim_step(schedule, latents, eps_fn(latents, t), t, t_prev)
        if blend_fn is not None:
            latents = blend_fn(latents, t_prev)
    return latents


def dpmpp_2m_sample(eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
                    schedule: NoiseSchedule, latents: torch.Tensor,
                    num_inference_steps: int = 20, timesteps: Optional[torch.Tensor] = None,
                    blend_fn: Optional[Blend] = None,
                    rng: Optional[Draw] = None) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022), the data-prediction multistep
    form on the DDIM grid: first order on the first step, fp32 arithmetic.
    With ``blend_fn``, the x0 history is blended too (``blend_fn(x0, -1)``,
    the x0-space blend), so that the 2M slope follows one trajectory.
    Deterministic: ``rng`` is ignored."""
    del rng
    ac = schedule.alphas_cumprod

    def coeffs(t: int):
        a = ac[max(t, 0)]  # t < 0 (final step): alphas_cumprod[0]
        alpha = torch.sqrt(a)
        sigma = torch.sqrt(torch.clamp(1.0 - a, min=1e-12))
        return alpha, sigma, torch.log(alpha) - torch.log(sigma)

    grid = _grid(schedule, num_inference_steps, timesteps)
    prev_x0, prev_lam = None, coeffs(grid[0][0])[2]
    for t, t_prev in grid:
        alpha_t, sigma_t, lam_t = coeffs(t)
        alpha_n, sigma_n, lam_n = coeffs(t_prev)
        eps = eps_fn(latents, t).float()
        lat32 = latents.float()
        x0 = (lat32 - sigma_t * eps) / alpha_t
        if blend_fn is not None:
            x0 = blend_fn(x0, -1).float()
        h = lam_n - lam_t
        if prev_x0 is None:  # first step: first order, D = x0
            d = x0
        else:
            r = (lam_t - prev_lam) / h
            d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * prev_x0
        new = (sigma_n / sigma_t) * lat32 - alpha_n * (torch.exp(-h) - 1.0) * d
        latents = new.to(latents.dtype)
        if blend_fn is not None:
            latents = blend_fn(latents, t_prev)
        prev_x0, prev_lam = x0, lam_t
    return latents


def karras_timesteps(num_inference_steps: int, schedule: NoiseSchedule,
                     rho: float = 7.0) -> torch.Tensor:
    """Karras sigma spacing (rho=7, Karras et al. 2022) mapped onto the
    training grid, in numpy float64: strictly decreasing int32 timesteps,
    collisions at the low-noise end pushed up one timestep (a repeated t
    would make the 2M update's h = 0)."""
    a = schedule.host_alphas_cumprod.astype(np.float64)
    sig = np.sqrt((1.0 - a) / a)  # EDM sigma per training timestep (ascending)
    smin, smax = sig[0], sig[-1]
    ramp = np.linspace(0.0, 1.0, num_inference_steps)
    sigmas = (smax ** (1.0 / rho) + ramp * (smin ** (1.0 / rho) - smax ** (1.0 / rho))) ** rho
    t = np.abs(np.log(sig)[None, :] - np.log(sigmas)[:, None]).argmin(axis=1).astype(np.int64)
    for i in range(len(t) - 2, -1, -1):
        if t[i] <= t[i + 1]:
            t[i] = t[i + 1] + 1
    if t[0] >= len(sig):
        raise ValueError(f"num_inference_steps={num_inference_steps} exceeds the "
                         f"{len(sig)}-step training grid")
    return torch.from_numpy(t.astype(np.int32))


def dpmpp_2m_karras_sample(eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
                           schedule: NoiseSchedule, latents: torch.Tensor,
                           num_inference_steps: int = 20,
                           timesteps: Optional[torch.Tensor] = None,
                           blend_fn: Optional[Blend] = None,
                           rng: Optional[Draw] = None) -> torch.Tensor:
    """DPM-Solver++(2M) on the Karras grid; an explicit ``timesteps`` grid
    (img2img's tail) wins, and then this is ``dpmpp_2m``."""
    if timesteps is None:
        timesteps = karras_timesteps(num_inference_steps, schedule)
    return dpmpp_2m_sample(eps_fn, schedule, latents, num_inference_steps, timesteps,
                           blend_fn)


def euler_ancestral_sample(eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
                           schedule: NoiseSchedule, latents: torch.Tensor,
                           num_inference_steps: int = 50,
                           timesteps: Optional[torch.Tensor] = None,
                           blend_fn: Optional[Blend] = None,
                           rng: Optional[Draw] = None) -> torch.Tensor:
    """Euler-ancestral (``euler_a``): on this variance-preserving grid, DDIM
    with eta=1. Each update steps to a lower noise level and adds the
    variance gap back as fresh noise ``rng(i, latents.shape)``; the final
    step (``t_prev < 0``) adds none, so it draws none. ``rng`` may be
    per lane (``generator_draw`` of one generator per image): then image
    i's noise depends on its own stream alone."""
    if rng is None:
        raise ValueError("euler_a is stochastic: pass rng= a draw callable (i, shape)")
    lanes = getattr(rng, "lanes", None)
    if lanes is not None and lanes != latents.shape[0]:
        raise ValueError(f"per-lane rng has {lanes} keys for batch {latents.shape[0]}")
    for i, (t, t_prev) in enumerate(_grid(schedule, num_inference_steps, timesteps)):
        eps = eps_fn(latents, t).float()
        lat32 = latents.float()
        a_t = schedule.alphas_cumprod[t]
        a_prev = schedule.alpha_prev(t_prev)
        x0 = (lat32 - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        if t_prev >= 0:
            # eta=1 posterior std (Song et al. 2020, DDIM eq. 16), clamped
            # only against rounding
            var = (1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)
            sigma = torch.sqrt(torch.clamp(var, min=0.0))
            dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0)) * eps
            new = torch.sqrt(a_prev) * x0 + dir_xt + sigma * rng(i, tuple(latents.shape))
        else:
            new = torch.sqrt(a_prev) * x0 + torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * eps
        latents = new.to(latents.dtype)
        if blend_fn is not None:
            latents = blend_fn(latents, t_prev)
    return latents


def generator_draw(gen: Union[torch.Generator, DataSlice, Sequence[torch.Generator]]) -> Draw:
    """A draw callable over ``torch.Generator``s: one generator draws the
    whole [B, ...] tensor each step (a ``DataSlice`` of one: this data
    rank's rows of it); a sequence of B generators (per lane) draws lane
    i's [...] from generator i, so that a lane's noise is the same whatever
    batch it runs in. fp32, on each generator's device."""
    if isinstance(gen, (torch.Generator, DataSlice)):
        dev = (gen.generator if isinstance(gen, DataSlice) else gen).device

        def draw(i: int, shape: tuple) -> torch.Tensor:
            return sliced_draw(torch.randn, shape, gen, device=dev)
        draw.lanes = None
        return draw
    gens = list(gen)

    def draw_lanes(i: int, shape: tuple) -> torch.Tensor:
        return torch.stack([torch.randn(shape[1:], generator=g, device=g.device)
                            for g in gens])
    draw_lanes.lanes = len(gens)
    return draw_lanes


SAMPLERS = {
    "ddim": ddim_sample,
    "dpmpp_2m": dpmpp_2m_sample,
    "dpmpp_2m_karras": dpmpp_2m_karras_sample,
    "euler_a": euler_ancestral_sample,
}
STOCHASTIC = ("euler_a",)  # the samplers that draw from ``rng``


def sampler_timesteps(sampler: str, schedule: NoiseSchedule, num_inference_steps: int,
                      init_steps: int = 0) -> Tuple[int, ...]:
    """The grid ``SAMPLERS[sampler]`` runs, as Python ints: the DDIM grid
    (the Karras grid for ``dpmpp_2m_karras``), or with ``init_steps`` its
    img2img tail of that many steps on the DDIM grid."""
    if init_steps > 0:
        ts = ddim_timesteps(num_inference_steps, schedule.num_train_timesteps)[
            num_inference_steps - init_steps:]
    elif sampler == "dpmpp_2m_karras":
        ts = karras_timesteps(num_inference_steps, schedule)
    else:
        ts = ddim_timesteps(num_inference_steps, schedule.num_train_timesteps)
    return tuple(int(t) for t in ts)


def predraw(rng: Draw, timesteps: Sequence[int], shape: tuple, device=None) -> torch.Tensor:
    """The stochastic sampler's noise, drawn ahead of its loop: ``rng(i,
    shape)`` for every step ``i`` of the grid that draws (all but the
    final one), in the loop's order, stacked [steps - 1, *shape] fp32. The
    draws are the loop's own, bit for bit."""
    lanes = getattr(rng, "lanes", None)
    if lanes is not None and lanes != shape[0]:
        raise ValueError(f"per-lane rng has {lanes} keys for batch {shape[0]}")
    noise = [rng(i, tuple(shape)) for i in range(len(timesteps) - 1)]
    if not noise:
        return torch.empty((0, *shape), dtype=torch.float32, device=device)
    return torch.stack(noise)


def stacked_draw(noise: torch.Tensor) -> Draw:
    """The draw callable over ``predraw``'s stack: step ``i`` reads
    ``noise[i]``."""
    def draw(i: int, shape: tuple) -> torch.Tensor:
        return noise[i]
    return draw


def _cat(a: Optional[Dict], b: Optional[Dict]):
    if a is None and b is None:
        return None
    if isinstance(a, dict):
        return {k: torch.cat([a[k], b[k]], dim=0) for k in a}
    return torch.cat([a, b], dim=0)


def cfg_eps_fn(unet_apply: Callable, context_cond, context_uncond,
               guidance_scale, audio_cond=None, audio_uncond=None,
               guidance_rescale=0.0):
    """An eps_fn that folds classifier-free guidance into ONE batched UNet
    forward: [uncond; cond] along the batch axis. ``guidance_rescale`` in
    [0, 1] is the CFG-rescale of Lin et al. 2023 (eq. 15-16); 0.0 is plain
    CFG. The guided prediction is formed in float32, as the JAX program
    forms it from its float32 guidance scale. Both scalars are floats or
    0-dim fp32 tensors (``generate`` passes device tensors, which a CUDA
    graph reads at each replay)."""
    ctx = _cat(context_uncond, context_cond)
    audio = _cat(audio_uncond, audio_cond)
    scale = guidance_scale if isinstance(guidance_scale, torch.Tensor) else float(guidance_scale)
    w = guidance_rescale if isinstance(guidance_rescale, torch.Tensor) else float(guidance_rescale)

    def eps_fn(latents: torch.Tensor, t: int) -> torch.Tensor:
        b = latents.shape[0]
        lat2 = torch.cat([latents, latents], dim=0)
        t2 = torch.full((2 * b,), int(t), dtype=torch.int32, device=latents.device)
        eps2 = unet_apply(lat2, t2, ctx, audio)
        eps_u, eps_c = eps2[:b], eps2[b:]
        g32 = eps_u.float() + scale * (eps_c - eps_u).float()
        c32 = eps_c.float()
        axes = tuple(range(1, g32.dim()))
        std_c = c32.std(dim=axes, keepdim=True, correction=0)
        std_g = g32.std(dim=axes, keepdim=True, correction=0).clamp_min(1e-8)
        return w * (g32 * (std_c / std_g)) + (1.0 - w) * g32

    return eps_fn
