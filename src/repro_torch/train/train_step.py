"""Training step factory (port of the local, ``accum=1`` path of
``repro/train/train_step.py``).

A step takes ``(state, batch, key)``: the batch as numpy or tensors, and the
step's integer seed, from which every sketched site derives its own
generator (step → layer → role). Gradients come from one backward through
the sketched sites' autograd Function; the optimizer updates in place.
Gradient accumulation, compact gradients, telemetry probes, plan carry and
resilience are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.api.execution import ExecutionConfig
from repro_torch.configs.base import ArchConfig
from repro_torch.core import SketchPolicy
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.optim import Optimizer, global_grad_norm
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["TrainState", "init_state", "make_train_step", "batch_to_device"]


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int = 0


def _trainable(params) -> None:
    for p in tree_leaves(params):
        if p.is_floating_point() and not p.requires_grad:
            p.requires_grad_(True)


def init_state(seed: int, cfg: ArchConfig, opt: Optimizer, *, params=None,
               device="cuda") -> TrainState:
    """Fresh train state: random parameters from ``seed`` (or the given
    ``params``), the optimizer's initial state, step 0."""
    if params is None:
        params = lm.init_params(seed, cfg, device=device)
    _trainable(params)
    return TrainState(params=params, opt_state=opt.init(params), step=0)


def batch_to_device(batch, device) -> dict:
    """Tensors on ``device``; token ids and labels as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def make_train_step(cfg: ArchConfig, opt: Optimizer, policy: Optional[SketchPolicy] = None,
                    *, execution: Optional[ExecutionConfig] = None, device="cuda"):
    """Returns ``step_fn(state, batch, key) -> (state, metrics)``; ``metrics``
    holds tensors (``loss``, ``grad_norm``) that the caller may fetch."""
    ex = execution or ExecutionConfig()
    dev = resolve_device(device)
    lm.check_supported(cfg)

    def step_fn(state: TrainState, batch, key: int):
        batch = batch_to_device(batch, dev)
        _trainable(state.params)
        leaves = tree_leaves(state.params)
        ctx = ex.make_ctx(policy=policy, key=key, n_layers=cfg.n_layers)
        loss, _ = lm.lm_loss(state.params, batch, ctx, cfg, key)
        flat = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(flat), state.params)
        gn = global_grad_norm(grads)
        params, opt_state = opt.update(grads, state.opt_state, state.params, state.step)
        new_state = TrainState(params=params, opt_state=opt_state, step=state.step + 1)
        return new_state, {"loss": loss.detach(), "grad_norm": gn}

    return step_fn
