"""Tensor-parallel sketched linears: thin instantiations of the site spine.

Port of ``repro/core/sharded_sketch.py``. The TP-native compact sketching
design (shard-local column plans, the standard TP dX all-reduce, and the
compact dW block reduced over the data axes: the compressed DP gradient
collective that the paper's batch-shared sketch allows) lives in the one
site spine, ``core/site.py``, as the ``tp_column`` / ``tp_row`` /
``tp_exact`` :class:`~repro_torch.core.site.ExecutionPlan` kinds. This
module keeps JAX's entry points as spec constructors, and the applicability
predicates :func:`~repro_torch.core.site.resolve_site` consults.

Registry routing: inside the TP backward the sketch plan comes from the
registered estimator's ``plan`` hook; any estimator with
``tp_shardable=True`` runs on these plans with its own sampling, and its
``validate`` is consulted here as on the single-device path.

Bias and telemetry ride the same streams: ``db`` comes from the kept-column
gather of every TP plan, and the probe is computed in the backward body and
summed over the model axis. Inputs are this rank's tensors: ``x`` its rows
(the row plan: d_in's model chunk), ``w`` its stored shard, ``b`` whole.
"""
from __future__ import annotations

from repro_torch.core import site
from repro_torch.core.site import tp_estimator as _tp_estimator
from repro_torch.core.sketching import SketchConfig

__all__ = ["tp_sketched_linear", "tp_row_sketched_linear", "tp_exact_linear",
           "tp_applicable", "tp_row_applicable"]


def _plan(ctx, kind):
    return site.ExecutionPlan(kind=kind, mesh=ctx.mesh, data_axes=tuple(ctx.data_axes),
                              model_axis=ctx.model_axes[0])


def _dims(ctx, w):
    from repro_torch.launch.sharding import global_shape

    return global_shape(w, ctx.mesh)


def tp_applicable(ctx, cfg, d_out: int) -> bool:
    """Column-parallel sites (attn q/k/v, mlp in/gate): d_out sharded over
    model under ``ctx.tp_sketch``."""
    if ctx.mesh is None or not getattr(ctx, "tp_sketch", False) or cfg is None:
        return False
    if _tp_estimator(cfg) is None:
        return False
    return site._tp_column_ok(cfg, d_out, ctx.mesh, tuple(ctx.model_axes))


def tp_row_applicable(ctx, cfg, d_in: int) -> bool:
    """Row-parallel sites (attn o, mlp out): d_in sharded over model, d_out
    the residual width."""
    if ctx.mesh is None or not getattr(ctx, "tp_sketch", False) or cfg is None:
        return False
    if _tp_estimator(cfg) is None:
        return False
    return site._tp_row_ok(d_in, ctx.mesh, tuple(ctx.model_axes))


def tp_sketched_linear(x, w, ctx, cfg: SketchConfig, seed: int, slot=None, *, b=None,
                       pslot=None):
    """x: [B, S, d_in] (this rank's rows); w: this rank's shard of [n, d_in],
    n sharded over model. Returns this rank's [B, S, n / n_mp]. ``seed``:
    the site's integer seed (folded with the model rank in the backward).
    With a ``slot`` the backward puts every model shard's compact rows and
    their global indices there; with a ``pslot`` the probe, summed over
    model, is its gradient."""
    n, d_in = _dims(ctx, w)
    spec = site.SiteSpec(role="tp_column", cfg=cfg, plan=_plan(ctx, "tp_column"),
                         has_bias=b is not None, d_out=n, d_in=d_in,
                         compact_rows=None if slot is None else slot.r)
    return site.tp_site(spec, x, w, b, seed, gslot=slot, pslot=pslot)


def tp_row_sketched_linear(x, w, ctx, cfg: SketchConfig, seed: int, slot=None, *, b=None,
                           pslot=None):
    """x: [B, S, d_in / n_mp] (d_in sharded over model); w: this rank's
    shard of [n, d_in]. Returns [B, S, n], summed over model. The plan is
    the same on every model shard, so dX stays local."""
    n, d_in = _dims(ctx, w)
    spec = site.SiteSpec(role="tp_row", cfg=cfg, plan=_plan(ctx, "tp_row"),
                         has_bias=b is not None, d_out=n, d_in=d_in,
                         compact_rows=None if slot is None else slot.r)
    return site.tp_site(spec, x, w, b, seed, gslot=slot, pslot=pslot)


def tp_exact_linear(x, w, ctx, seed=None, *, b=None):
    """Megatron column-parallel linear with an EXACT backward (the
    vocabulary head, which the paper keeps exact). Returns this rank's
    model chunk of the output."""
    n, d_in = _dims(ctx, w)
    spec = site.SiteSpec(role="tp_exact", cfg=None, plan=_plan(ctx, "tp_exact"),
                         has_bias=b is not None, d_out=n, d_in=d_in)
    return site.tp_site(spec, x, w, b, seed)
