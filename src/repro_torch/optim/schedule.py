"""LR schedule (port of ``repro/optim/schedule.py::cosine_warmup``); step -> float."""
from __future__ import annotations

import math

__all__ = ["cosine_warmup"]


def cosine_warmup(peak: float, warmup: int, total: int, floor: float = 0.0):
    def fn(step):
        s = float(step)
        if s < warmup:
            return peak * s / max(warmup, 1)
        prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return floor + 0.5 * (peak - floor) * (1.0 + math.cos(math.pi * prog))
    return fn
