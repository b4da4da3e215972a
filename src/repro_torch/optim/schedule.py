"""LR schedules (port of ``repro/optim/schedule.py``: constant for the MLP
under SGD, cosine for BagNet and ViT); each maps a step to a float."""
from __future__ import annotations

import math

__all__ = ["constant", "cosine_warmup"]


def constant(lr: float):
    return lambda step: float(lr)


def cosine_warmup(peak: float, warmup: int, total: int, floor: float = 0.0):
    def fn(step):
        s = float(step)
        if s < warmup:
            return peak * s / max(warmup, 1)
        prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return floor + 0.5 * (peak - floor) * (1.0 + math.cos(math.pi * prog))
    return fn
