"""Learning-rate schedules as step -> float32 tensor callables, mirroring
the reference's ``optim/schedule.py``. ``step`` is a number or a
tensor."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine_decay(lr: float, decay_steps: int, final_frac: float = 0.1):
    def f(step):
        frac = torch.clamp(_f32(step) / max(decay_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return (lr * (final_frac + (1 - final_frac) * cos)).to(torch.float32)
    return f


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_decay(lr, max(decay_steps - warmup_steps, 1), final_frac)

    def f(step):
        step = _f32(step)
        warm = lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps)).to(torch.float32)
    return f
