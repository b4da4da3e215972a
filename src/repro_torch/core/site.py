"""The sketched-site spine: one ``torch.autograd.Function`` per linear site.

Port of the local plan of ``repro/core/site.py`` (``_fwd``, ``_bwd``,
``_local_bwd``, ``_pack``). The forward is a plain matmul; the backward
flattens the output gradient to ``G2d [N, n]``, dispatches through the
estimator registry, and scatters compact rows into the dense weight gradient
(and compact ``db`` into the dense bias gradient). The site's generator is
consumed only in the backward, so a forward alone draws no random numbers.

Compact-gradient slots, telemetry probes, plan carry and the tensor-parallel
plans of the JAX spine are not ported yet.
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
    """``y = x @ w.T (+ b)`` with the estimator backward of ``cfg``."""

    @staticmethod
    def forward(ctx, x, w, b, cfg, gen):
        ctx.save_for_backward(x, w)
        ctx.cfg = cfg
        ctx.gen = gen
        ctx.has_b = b is not None
        return _matmul(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cfg = ctx.cfg
        n = w.shape[0]
        G2d = g.reshape(-1, n)
        X2d = x.reshape(-1, x.shape[-1])
        est = estimators.get_estimator(cfg.backend)
        out = est.apply(cfg, G2d, X2d, w, ctx.gen, has_b=ctx.has_b)
        dX = out.dx.reshape(x.shape)
        if not out.is_compact:
            db = out.db if ctx.has_b else None
            return dX, out.dw.to(w.dtype), db, None, None
        db = None
        if ctx.has_b:
            db = torch.zeros(n, dtype=g.dtype, device=g.device).index_add_(
                0, out.cols, out.db_c.to(g.dtype))
        # kept rows are distinct, so the scatter-add writes each row once
        dW = torch.zeros_like(w).index_add_(0, out.cols, out.rows.to(w.dtype))
        return dX, dW, db, None, None


def sketched_site(cfg: Optional[SketchConfig], x, w, b=None,
                  gen: Optional[torch.Generator] = None):
    """Run one site. No config, a no-op config or no generator give the exact
    linear under plain autograd."""
    if cfg is None or cfg.is_noop or gen is None:
        return _matmul(x, w, b)
    return SketchedLinearFn.apply(x, w, b, cfg, gen)
