"""Compact (row-sparse) weight gradients, kept compact from the backward to
the optimizer.

Port of ``repro/core/compact_grad.py`` for the local plan on one device. The
compact backends (``compact``, ``pallas``, ``onepass``, ``stale``) produce a
sketched site's dW as ``r`` kept rows and their row indices. Without this
module the site scatters them into a freshly zeroed dense dW and the
optimizer does dense math on rows the sketch never touched. With
``ExecutionConfig(compact_grads=True)`` the rows stay compact:

* :class:`CompactGrad` — ``(rows, idx, dense)``: ``rows [r, d_in]`` float32
  kept dW rows, ``idx [r]`` their **integer** (int64) row indices into the
  weight (JAX carries them as float32 because a slot's cotangent must be
  float; the port's side channel has no such constraint), ``dense`` an
  optional dense part with the weight's shape (``None`` on the compact
  path).
* **Gradient slots** — :func:`with_grad_slots` puts a :class:`GradSlot`
  under key ``"gslot"`` beside ``"w"`` in every site whose backward emits
  compact rows. A slot is a host object, made per step, that allocates
  nothing on the device. ``nn.common.dense`` hands it to the site; the
  site's backward puts the kept rows and their indices into it and returns
  NO gradient for ``w`` (``None``: no dense dW is allocated or filled).
  ``torch.autograd.grad`` raises for an input whose only use returned
  ``None`` ("appears to not have been used in the graph"), so the train step
  differentiates every leaf but the slotted weights (:func:`grad_targets`).
* :func:`fold_slot_grads` — rewrites the gradient tree to the parameters'
  structure: each slotted site's ``w`` gradient becomes
  ``CompactGrad(rows, idx, dense=None)``.

The port keeps one dict per layer (``params["layers"]``), so every weight is
2-D and the helpers need no stacked (scanned) case.

Contract, as in JAX: ``dense`` and the scattered ``rows`` have disjoint
support; clipping and the optimizers (``optim/optimizers.py``) consume the
compact form directly; only :func:`densify` materialises the dense gradient,
for tests and diagnostics. Gradient accumulation must stay dense
(microbatches keep different rows), so ``ExecutionConfig`` rejects
``compact_grads`` with ``accum != 1``. A weight applied twice in one step
would need two plans' rows in one slot: only sites applied once get slots,
and a slot filled twice raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.sketching import (SketchConfig, effective_cfg, static_block_rank,
                                        static_rank)

__all__ = ["CompactGrad", "GradSlot", "GRAD_SLOT", "is_compact", "row_gather", "row_scatter",
           "densify", "compact_rank", "with_grad_slots", "grad_targets", "fold_slot_grads",
           "localize_compact"]

GRAD_SLOT = "gslot"


@dataclasses.dataclass
class CompactGrad:
    """Row-sparse gradient: ``dense_grad = dense + scatter_add(idx, rows)``.

    rows: ``[r, d_in]`` float32 kept rows; idx: ``[r]`` int64 row indices
    (distinct); dense: ``None`` (the compact path) or a dense part with the
    weight's shape whose support is disjoint from ``idx``.
    """

    rows: torch.Tensor
    idx: torch.Tensor
    dense: Optional[torch.Tensor] = None


def is_compact(x: Any) -> bool:
    return isinstance(x, CompactGrad)


def row_gather(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` (a new tensor): the one place, with :func:`row_scatter`,
    where row indices are applied."""
    return a.index_select(0, idx)


def row_scatter(a: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, *,
                add: bool) -> torch.Tensor:
    """``a[idx] += rows`` (``add``) or ``a[idx] = rows``, in place, in
    ``a``'s dtype; returns ``a``. ``densify`` and the optimizers' row updates
    both go through it."""
    rows = rows.to(a.dtype)
    return a.index_add_(0, idx, rows) if add else a.index_copy_(0, idx, rows)


def densify(cg: CompactGrad, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense gradient (tests and diagnostics only: the step keeps
    gradients compact until the weight update). ``like`` gives the shape
    when ``cg.dense`` is None."""
    if cg.dense is not None:
        base = cg.dense.to(cg.rows.dtype, copy=True)
    else:
        if like is None:
            raise ValueError("a CompactGrad without a dense part needs `like` for its shape")
        base = torch.zeros(like.shape, dtype=cg.rows.dtype, device=cg.rows.device)
    return row_scatter(base, cg.idx, cg.rows, add=True)


def compact_rank(cfg: SketchConfig, n: int) -> int:
    """Number of kept dW rows (columns of G) of a site of width ``n``."""
    lcfg = effective_cfg(cfg, n)
    if lcfg.block > 1:
        return static_block_rank(lcfg, n) * lcfg.block
    return static_rank(lcfg, n)


class GradSlot:
    """One site's gradient slot for one step: the side channel through which
    the site's backward hands over its kept dW rows and their indices.

    ``r`` is the resolved ``SiteSpec.compact_rows`` the slot was made for;
    :meth:`put` checks the backward's rows against it, so slot emission and
    the backward's dispatch cannot drift apart. On the ``tp_column`` plan
    ``r`` is n_mp x the shard's rank: every model shard's rows with global
    indices (:func:`localize_compact` keeps this rank's)."""

    __slots__ = ("r", "rows", "idx")

    def __init__(self, r: int):
        self.r = r
        self.rows: Optional[torch.Tensor] = None
        self.idx: Optional[torch.Tensor] = None

    def put(self, rows: torch.Tensor, idx: torch.Tensor) -> None:
        if self.rows is not None:
            raise RuntimeError("gradient slot filled twice in one step: a weight with a slot "
                               "must be applied once per step")
        if rows.shape[0] != self.r or idx.shape != (self.r,):
            raise RuntimeError(f"the backward emitted {rows.shape[0]} compact rows, the slot "
                               f"was resolved for {self.r}")
        self.rows = rows.to(torch.float32)
        self.idx = idx.to(torch.int64)


def with_grad_slots(params, policy, *, n_layers: int = 1, mesh=None, data_axes=("data",),
                    model_axes=("model",), tp_sketch: bool = False):
    """``params`` with a fresh :class:`GradSlot` under ``"gslot"`` in every
    site whose backward takes a compact path: the tree to run the loss on.

    The sites are those ``core.site.resolve_tree_site`` resolves with
    ``compact_rows`` set — the same resolution ``nn.common.dense`` runs. As in
    JAX, only ``location="all"`` policies get slots (a location policy's
    per-layer config differs from the layer-0 one the builder reads), and the
    result is then a new tree of dicts holding the same tensors; otherwise
    ``params`` comes back unchanged."""
    if policy is None or policy.location != "all":
        return params
    from repro_torch.core.site import resolve_tree_site

    def walk(node, path):
        if isinstance(node, dict):
            out = {k: walk(v, path + (k,)) for k, v in node.items()}
            spec = resolve_tree_site(path, node, policy, n_layers=n_layers, mesh=mesh,
                                     data_axes=data_axes, model_axes=model_axes,
                                     tp_sketch=tp_sketch)
            if spec is not None and spec.compact_rows is not None:
                out[GRAD_SLOT] = GradSlot(spec.compact_rows)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,)) for i, v in enumerate(node))
        return node

    return walk(params, ())


def grad_targets(params):
    """``params`` with each slotted site's ``w`` replaced by None: the tensor
    leaves left are what the step differentiates (a slotted weight's
    gradient leaves through its slot)."""

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(v) for k, v in node.items()}
            if GRAD_SLOT in node:
                out["w"] = None
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def localize_compact(grads, params):
    """Under a mesh: each CompactGrad's rows (global row indices, in the
    weight shard's d_in layout) cut to the rows this rank's shard holds,
    re-indexed from the shard's first row, so the optimizer updates its own
    rows. A tp_column slot holds every model shard's rows (n_mp x rank,
    all-gathered); the row plan's and the local plan's hold all d_out rows.
    Unmarked weights, and shards holding every row, pass unchanged."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.sharding import dim_axes, mesh_of, spec_of

    def walk(g, p):
        if isinstance(g, dict):
            return {k: walk(v, p[k]) for k, v in g.items()}
        if isinstance(g, (list, tuple)):
            return type(g)(walk(a, b) for a, b in zip(g, p))
        spec = spec_of(p) if isinstance(p, torch.Tensor) else None
        if not is_compact(g) or spec is None or not dim_axes(spec[0]):
            return g
        mesh = mesh_of(p)
        n_loc = p.shape[0]
        lo = meshlib.axis_index(mesh, dim_axes(spec[0])) * n_loc
        keep = (g.idx >= lo) & (g.idx < lo + n_loc)
        return CompactGrad(rows=g.rows[keep], idx=g.idx[keep] - lo, dense=g.dense)

    return walk(grads, params)


def fold_slot_grads(grads):
    """The gradient tree of a slot-augmented ``params`` (slots in place, a
    slotted ``w``'s gradient None) back in the parameters' structure: each
    slotted site's ``w`` gradient becomes ``CompactGrad(rows, idx,
    dense=None)``. Raises for a slot its backward did not fill (a site that
    ran without a sketch)."""

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(v) for k, v in node.items() if k != GRAD_SLOT}
            slot = node.get(GRAD_SLOT)
            if slot is not None:
                if slot.rows is None:
                    raise RuntimeError("a gradient slot was not filled: its site ran without "
                                       "the sketched backward")
                out["w"] = CompactGrad(rows=slot.rows, idx=slot.idx, dense=node["w"])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(grads)
