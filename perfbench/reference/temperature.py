"""Temperature annealing of the soft level assignment as a function of the
step: a frozen copy of the program's ``models/condition/temperature.py``.

Hold at T_max for ``warmup_steps``, cosine (or linear) anneal to T_min by
``total_steps``, floor at 0.1. Computed in float32, as the JAX function.
"""

from __future__ import annotations

import numpy as np


TEMPERATURE_FLOOR = 0.1


def temperature_at_step(step, t_max: float = 2.0, t_min: float = 0.5,
                        total_steps: int = 5000, warmup_steps: int = 200,
                        mode: str = "cosine") -> float:
    """Temperature for an integer step, as a Python float (fp32 math)."""
    f32 = np.float32
    step = f32(step)
    if total_steps <= warmup_steps:
        return float(max(f32(t_min), f32(TEMPERATURE_FLOOR)))
    progress = np.clip((step - f32(warmup_steps)) / f32(total_steps - warmup_steps),
                       f32(0.0), f32(1.0))
    if mode == "cosine":
        t = f32(t_min) + f32(t_max - t_min) * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * progress))
    elif mode == "linear":
        t = f32(t_max) - f32(t_max - t_min) * progress
    else:
        raise ValueError(f"unknown annealing mode {mode!r}")
    if step < warmup_steps:
        t = f32(t_max)
    if step >= total_steps:
        t = f32(t_min)
    return float(max(f32(t), f32(TEMPERATURE_FLOOR)))


def temperature_from_config(step, cfg: ConditionConfig) -> float:
    return temperature_at_step(
        step, t_max=cfg.temperature_initial, t_min=cfg.temperature_final,
        total_steps=cfg.temperature_anneal_steps, warmup_steps=cfg.temperature_warmup_steps,
        mode=cfg.temperature_schedule,
    )
