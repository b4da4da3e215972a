"""The sketched-site spine: one ``torch.autograd.Function`` per linear site.

Port of the local plan of ``repro/core/site.py`` (``_fwd``, ``_bwd``,
``_local_bwd``, ``_pack``). The forward is a plain matmul; the backward
flattens the output gradient to ``G2d [N, n]``, dispatches through the
estimator registry, and scatters compact rows into the dense weight gradient
(and compact ``db`` into the dense bias gradient). The site's generator is
consumed only in the backward, so a forward alone draws no random numbers.

Plan carry, as in JAX: a plan-carry site (``onepass``, ``stale``) takes its
carry leaf (``sslot``, the previous step's column scores) as one more input.
The backward samples the plan from it and returns the REFRESHED scores as
that input's gradient, so ``torch.autograd.grad`` hands them to the train
step beside the weight gradients. The forward never writes the carry; the
train step takes the refreshed scores out of the gradients and writes them
over the carry after the optimizer update (``core/plan_state.py``).

Compact-gradient slots, telemetry probes and the tensor-parallel plans of the
JAX spine are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import estimators
from repro_torch.core.sketching import SketchConfig

__all__ = ["sketched_site"]


def _matmul(x, w, b):
    y = torch.matmul(x, w.t())
    return y + b if b is not None else y


class SketchedLinearFn(torch.autograd.Function):
    """``y = x @ w.T (+ b)`` with the estimator backward of ``cfg``; the
    gradient of ``sslot`` (when given) is the refreshed plan carry."""

    @staticmethod
    def forward(ctx, x, w, b, sslot, cfg, gen):
        ctx.save_for_backward(x, w, sslot)
        ctx.cfg = cfg
        ctx.gen = gen
        ctx.has_b = b is not None
        return _matmul(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w, sslot = ctx.saved_tensors
        cfg = ctx.cfg
        n = w.shape[0]
        G2d = g.reshape(-1, n)
        X2d = x.reshape(-1, x.shape[-1])
        est = estimators.get_estimator(cfg.backend)
        if getattr(est, "plan_carry", False):
            # the plan comes from the carried scores (None: uniform prior);
            # the refreshed scores come back in out.state
            out = est.apply_with_state(cfg, G2d, X2d, w, ctx.gen, sslot, has_b=ctx.has_b)
        else:
            out = est.apply(cfg, G2d, X2d, w, ctx.gen, has_b=ctx.has_b)
        state_ct = None
        if sslot is not None:
            # zeros when the estimator emitted no refresh, as in JAX
            state_ct = (out.state.to(sslot.dtype) if out.state is not None
                        else torch.zeros_like(sslot))
        dX = out.dx.reshape(x.shape)
        if not out.is_compact:
            db = out.db if ctx.has_b else None
            return dX, out.dw.to(w.dtype), db, state_ct, None, None
        db = None
        if ctx.has_b:
            db = torch.zeros(n, dtype=g.dtype, device=g.device).index_add_(
                0, out.cols, out.db_c.to(g.dtype))
        # kept rows are distinct, so the scatter-add writes each row once
        dW = torch.zeros_like(w).index_add_(0, out.cols, out.rows.to(w.dtype))
        return dX, dW, db, state_ct, None, None


def sketched_site(cfg: Optional[SketchConfig], x, w, b=None,
                  gen: Optional[torch.Generator] = None,
                  sslot: Optional[torch.Tensor] = None):
    """Run one site. No config, a no-op config or no generator give the exact
    linear under plain autograd. ``sslot``: the site's plan-carry leaf."""
    if cfg is None or cfg.is_noop or gen is None:
        return _matmul(x, w, b)
    return SketchedLinearFn.apply(x, w, b, sslot, cfg, gen)
