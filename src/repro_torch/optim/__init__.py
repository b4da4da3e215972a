"""Optimizers and schedules of the port."""
from repro_torch.optim.optimizers import (Optimizer, adamw, clip_by_global_norm,
                                          global_grad_norm, sgd)
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "global_grad_norm", "sgd",
           "cosine_warmup"]
