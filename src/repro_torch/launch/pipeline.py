"""Pipeline-parallel stage boundaries with a sketched backward.

Port of ``repro/launch/pipeline.py``. The paper's motivation (i): between
pipeline stages the activations (forward) and their gradients (backward)
dominate the traffic; compressing the gradient while keeping it unbiased
cuts the bandwidth without biasing SGD::

    x = stage_boundary(x, key=seed, cfg=SketchConfig(...))   # between stages

Forward: the identity (activations cross exactly). Backward: the cotangent
crossing back over the boundary is replaced by its unbiased column sketch
``Ĝ = G·R`` with ``E[R] = I``; on a real link the kept columns and their
indices are what move (:func:`boundary_wire_bytes`). One device: the
stage-to-stage transfer itself comes with a multi-stage mesh.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import rng
from repro_torch.core.sketching import (SketchConfig, column_plan, effective_cfg,
                                        static_block_rank, static_rank)

__all__ = ["stage_boundary", "boundary_wire_bytes"]


class _Boundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, seed):
        ctx.cfg, ctx.seed = cfg, seed
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        G2d = g.reshape(-1, g.shape[-1])
        lcfg = effective_cfg(ctx.cfg, G2d.shape[-1])
        plan = column_plan(lcfg, G2d, None, rng.generator(ctx.seed, g.device),
                           want_compact=False)
        # on hardware only the kept columns and their indices cross the link;
        # the dense reconstruction here is the receiving stage's scatter
        return (G2d * plan.gate[None, :].to(g.dtype)).reshape(g.shape), None, None


def stage_boundary(x, *, key: Optional[int] = None, cfg: Optional[SketchConfig] = None):
    """Insert between pipeline stages: the identity forward, the sketched
    cotangent backward. ``key``: the boundary's integer seed."""
    if cfg is None or cfg.is_noop or key is None:
        return x
    if cfg.method not in ("l1", "l2", "var", "per_column", "ds"):
        raise ValueError("stage boundaries support column-family sketches")
    return _Boundary.apply(x, cfg, int(key))


def boundary_wire_bytes(cfg: SketchConfig, shape, dtype=torch.bfloat16) -> dict:
    """Backward wire accounting for one boundary crossing (per microbatch):
    the dense gradient's bytes against the kept columns' values plus their
    int32 indices."""
    n = shape[-1]
    rows = 1
    for d in shape[:-1]:
        rows *= d
    lcfg = effective_cfg(cfg, n)
    r = static_block_rank(lcfg, n) * lcfg.block if lcfg.block > 1 else static_rank(lcfg, n)
    itemsize = torch.empty((), dtype=dtype).element_size()
    dense = rows * n * itemsize
    compact = rows * r * itemsize + r * 4
    return {"dense_bytes": dense, "compact_bytes": compact, "ratio": compact / dense}
