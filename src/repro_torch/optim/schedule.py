"""Learning-rate schedules, the port of ``repro.optim.schedule``.

Each schedule takes the step as an int or a 0-d tensor and returns a 0-d
float32 tensor on the step's device, equal to the reference's value at
every step: the same float32 operations in the same order (Python floats
enter as float32, as jax's weakly typed scalars do).
"""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        return peak * torch.clamp(_step_f32(step) / max(warmup_steps, 1), max=1.0)

    return fn


def cosine_schedule(
    peak: float,
    warmup_steps: int,
    total_steps: int,
    floor: float = 0.1,
):
    def fn(step):
        s = _step_f32(step)
        warm = peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp(
            (s - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0,
            1.0,
        )
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, peak * cos)

    return fn
