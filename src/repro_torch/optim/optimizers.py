"""SGD(+momentum) and AdamW as init/update pairs on dense gradients.

Port of ``repro/optim/optimizers.py``. The optimizer state is a tree shaped
like the parameters. Unlike the pure JAX version, ``update`` writes the new
parameters and moments in place (no second copy of the model and moments)
and returns the same objects. Compact-gradient updates and lazy AdamW are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "sgd", "adamw", "clip_by_global_norm", "global_grad_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable  # params -> state
    update: Callable  # (grads, state, params, step) -> (params, state)


def _trainable(p) -> bool:
    return isinstance(p, torch.Tensor) and p.is_floating_point()


def global_grad_norm(grads) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, in float32, as a tensor (no host sync)."""
    return torch.sqrt(sum(g.to(torch.float32).square().sum() for g in tree_leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / ‖g‖)``; returns (grads, norm)."""
    gn = global_grad_norm(grads)
    scale = torch.clamp(max_norm / gn.clamp_min(1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def sgd(lr: Callable | float, momentum: float = 0.0, clip: Optional[float] = None):
    lr_fn = _lr_fn(lr)

    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        if clip is not None:
            grads, _ = clip_by_global_norm(grads, clip)
        lr_t = lr_fn(step)
        if momentum == 0.0:
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                if _trainable(p):
                    p.copy_((p.to(torch.float32) - lr_t * g.to(torch.float32)).to(p.dtype))
            return params, state
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"])):
            if _trainable(p):
                m.mul_(momentum).add_(g.to(m.dtype))
                p.copy_((p.to(torch.float32) - lr_t * m.to(torch.float32)).to(p.dtype))
        return params, state

    return Optimizer(init, update)


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, clip: Optional[float] = None):
    """AdamW; weight decay applies to leaves with two or more dimensions."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        if clip is not None:
            grads, _ = clip_by_global_norm(grads, clip)
        t = float(step) + 1.0
        lr_t = lr_fn(step)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]), tree_leaves(state["v"])):
            if not _trainable(p):
                continue
            g32 = g.to(torch.float32)
            m.mul_(b1).add_(g32, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
            p32 = p.to(torch.float32)
            upd = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay and p.dim() >= 2:
                upd = upd + weight_decay * p32
            p.copy_((p32 - lr_t * upd).to(p.dtype))
        return params, state

    return Optimizer(init, update)
