"""Training step factory (port of the local, ``accum=1`` path of
``repro/train/train_step.py``).

A step takes ``(state, batch, key)``: the batch as numpy or tensors, and the
step's integer seed, from which every sketched site derives its own
generator (step → layer → role). Gradients come from one backward through
the sketched sites' autograd Function; the optimizer updates in place.

Compact gradients (``ExecutionConfig(compact_grads=True)``): before the loss,
every compact site gets a gradient slot (``core/compact_grad.py``), whose
backward fills it with the kept dW rows and their indices instead of a dense
dW. The step differentiates every leaf but the slotted weights and folds the
slots back into the gradient tree as ``CompactGrad`` leaves, which the
gradient norm, the clipping and the optimizer take as they are. Slots are
made per step and never reach ``opt.init`` or the optimizer's moments.

Plan carry (``onepass``, ``stale``): the carry leaves are parameters, so the
backward returns their refreshed scores among the gradients. The step takes
them out (zeroing those gradients) before the gradient norm, the clipping and
the optimizer, and writes them over the carry after the update
(``core/plan_state.py``). A site can hold both a gradient slot and a carry
leaf. Gradient accumulation, telemetry probes and resilience are not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.api.execution import ExecutionConfig
from repro_torch.configs.base import ArchConfig
from repro_torch.core import SketchPolicy
from repro_torch.core import compact_grad as cgrad
from repro_torch.core import plan_state as pstate
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
               device="cuda", policy: Optional[SketchPolicy] = None) -> TrainState:
    """Fresh train state: random parameters from ``seed`` (or the given
    ``params``), the optimizer's initial state, step 0. With a plan-carry
    ``policy`` every carry-capable site gets its carry leaf (the uniform
    prior); without it a carry policy still runs, but every step samples
    from the uniform prior."""
    if params is None:
        params = lm.init_params(seed, cfg, device=device)
    if pstate.policy_uses_carry(policy):
        params = pstate.with_plan_state(params, policy, n_layers=cfg.n_layers)
    _trainable(params)
    return TrainState(params=params, opt_state=opt.init(params), step=0)


def batch_to_device(batch, device) -> dict:
    """Tensors on ``device``; token ids and labels (``y`` for the MLP) as
    int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if k in ("tokens", "labels", "y"):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def make_train_step(cfg: ArchConfig, opt: Optimizer, policy: Optional[SketchPolicy] = None,
                    *, execution: Optional[ExecutionConfig] = None, device="cuda"):
    """Returns ``step_fn(state, batch, key) -> (state, metrics)``; ``metrics``
    holds tensors that the caller may fetch: the loss's metrics (``acc`` for
    the MLP) and ``grad_norm``."""
    ex = execution or ExecutionConfig()
    dev = resolve_device(device)
    lm.check_supported(cfg)
    carry_on = pstate.policy_uses_carry(policy)

    def step_fn(state: TrainState, batch, key: int):
        batch = batch_to_device(batch, dev)
        _trainable(state.params)
        params_in = state.params
        if ex.compact_grads:
            # fresh slots for this step: host objects, nothing on the card
            params_in = cgrad.with_grad_slots(state.params, policy, n_layers=cfg.n_layers)
        ctx = ex.make_ctx(policy=policy, key=key, n_layers=cfg.n_layers)
        loss, metrics = lm.lm_loss(params_in, batch, ctx, cfg, key)
        # a slotted weight's gradient leaves through its slot: it is not
        # differentiated (its Function returns None for it)
        targets = cgrad.grad_targets(params_in)
        leaves = [t for t in tree_leaves(targets) if isinstance(t, torch.Tensor)]
        flat = iter(torch.autograd.grad(loss, leaves))
        grads = cgrad.fold_slot_grads(
            tree_map(lambda t: next(flat) if isinstance(t, torch.Tensor) else t, targets))
        fresh = {}
        if carry_on:
            # the carry leaves' gradients ARE the refreshed scores: take them
            # out before the norm, the clipping and the moments see them
            grads, fresh = pstate.collect_plan_state(grads)
        gn = global_grad_norm(grads)
        params, opt_state = opt.update(grads, state.opt_state, state.params, state.step)
        # after the update: the optimizer saw zero gradients on the carry
        params = pstate.write_plan_state(params, fresh)
        new_state = TrainState(params=params, opt_state=opt_state, step=state.step + 1)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return new_state, dict(metrics, loss=loss.detach(), grad_norm=gn)

    return step_fn
