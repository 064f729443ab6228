"""Learning-rate schedules as step -> lr callables (port of
``repro/optim/schedules.py``): host float32 arithmetic in the
reference's order."""
from __future__ import annotations

import numpy as np

F32 = np.float32


def constant(lr: float):
    return lambda step: F32(lr)


def exponential_decay(lr: float, decay: float, every: int):
    def f(step):
        return F32(lr) * F32(decay) ** (F32(step) / F32(every))
    return f


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = np.clip(F32(step) / F32(total_steps), F32(0), F32(1))
        c = F32(0.5) * (F32(1) + np.cos(F32(np.pi) * t))
        return F32(lr) * (F32(final_frac) + (F32(1) - F32(final_frac)) * c)
    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.05):
    cos = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        s = F32(step)
        if s < warmup:
            return F32(lr) * s / F32(max(warmup, 1))
        w = min(s / F32(max(warmup, 1)), F32(1))
        return w * cos(step - warmup)
    return f
