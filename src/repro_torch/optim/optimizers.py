"""SGD(+momentum) and AdamW as init/update pairs, on dense and compact
gradients.

Port of ``repro/optim/optimizers.py``. The optimizer state is a tree shaped
like the parameters. Unlike the pure JAX version, ``update`` writes the new
parameters and moments in place (no second copy of the model and moments)
and returns the same objects.

Compact gradients: any gradient leaf may be a
:class:`~repro_torch.core.compact_grad.CompactGrad`, ``dense +
scatter(idx, rows)`` with disjoint support (``dense`` is None on the compact
path). Clipping and the updates consume that form directly:

* SGD — a row update of the kept rows only;
* SGD + momentum — the momentum decays everywhere, the rows are added;
* AdamW (default) — the moments decay everywhere, the rows enter the kept
  rows' moments with the dense update's own operations, so the result is
  the dense update on the densified gradient;
* AdamW ``lazy=True`` — LazyAdam: rows the sketch did not keep skip the
  moment decay, the weight decay and the update (cheaper, not identical to
  dense AdamW). It ignores a CompactGrad's dense part, as in JAX.

Under a mesh every leaf is this rank's shard and its gradient the shard's
(the train step keeps a CompactGrad's rows of the shard,
``core.compact_grad.localize_compact``): the updates are elementwise or by
row, so they run on the shards as they are; the gradient norm of clipping
sums the sharded leaves over their axes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.compact_grad import CompactGrad, is_compact, row_gather, row_scatter
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "sgd", "adamw", "clip_by_global_norm", "global_grad_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable  # params -> state
    update: Callable  # (grads, state, params, step) -> (params, state)


def _trainable(p) -> bool:
    return isinstance(p, torch.Tensor) and p.is_floating_point()


def _sq_norm(g) -> torch.Tensor:
    if is_compact(g):
        # disjoint support: ||dense + scatter(rows)||² = ||dense||² + ||rows||²
        t = g.rows.to(torch.float32).square().sum()
        if g.dense is not None:
            t = t + g.dense.to(torch.float32).square().sum()
        return t
    return g.to(torch.float32).square().sum()


def global_grad_norm(grads, params=None) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, in float32, as a tensor (no host sync);
    a CompactGrad counts as its densified form.

    Under a mesh, ``params`` (the shards, ``launch.sharding.spec_of``) says
    which leaves are sharded: their local sums of squares are summed over
    the axes that shard them (one all-reduce per set of axes); a replicated
    leaf is counted once. Without marks the sum is the single-device one,
    term for term."""
    sq = [_sq_norm(g) for g in tree_leaves(grads)]
    if params is not None:
        sq = _sum_sharded(sq, tree_leaves(params))
    return torch.sqrt(sum(sq))


def _sum_sharded(sq, leaves):
    from repro_torch.launch.mesh import psum
    from repro_torch.launch.sharding import mesh_of, spec_axes, spec_of

    groups = {}
    for i, p in enumerate(leaves):
        spec = spec_of(p) if isinstance(p, torch.Tensor) else None
        if spec is None:
            continue
        mesh = mesh_of(p)
        axes = mesh.axes(spec_axes(spec))
        if mesh.axis_size(axes) > 1:
            groups.setdefault((id(mesh), axes), (mesh, []))[1].append(i)
    sq = list(sq)
    for (_, axes), (mesh, idx) in groups.items():
        tot = psum(torch.stack([sq[i] for i in idx]), axes, mesh)
        for j, i in enumerate(idx):
            sq[i] = tot[j]
    return sq


def _scale_grad(g, scale):
    if is_compact(g):
        return CompactGrad(rows=g.rows.to(torch.float32) * scale, idx=g.idx,
                           dense=None if g.dense is None else
                           (g.dense.to(torch.float32) * scale).to(g.dense.dtype))
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float, params=None):
    """Scale every leaf by ``min(1, max_norm / ‖g‖)``; returns (grads, norm).
    ``params``: the shards under a mesh (:func:`global_grad_norm`)."""
    gn = global_grad_norm(grads, params)
    scale = torch.clamp(max_norm / gn.clamp_min(1e-12), max=1.0)
    return tree_map(lambda g: _scale_grad(g, scale), grads), gn


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
            grads, _ = clip_by_global_norm(grads, clip, params)
        lr_t = lr_fn(step)
        if momentum == 0.0:
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                if not _trainable(p):
                    continue
                if is_compact(g):
                    if g.dense is not None:
                        p.copy_((p.to(torch.float32) - lr_t * g.dense.to(torch.float32))
                                .to(p.dtype))
                    # the kept rows only, in float32 as the dense update
                    p_r = row_gather(p, g.idx).to(torch.float32) - lr_t * g.rows
                    row_scatter(p, g.idx, p_r, add=False)
                else:
                    p.copy_((p.to(torch.float32) - lr_t * g.to(torch.float32)).to(p.dtype))
            return params, state
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"])):
            if not _trainable(p):
                continue
            m.mul_(momentum)
            if is_compact(g):
                if g.dense is not None:
                    m.add_(g.dense.to(m.dtype))
                row_scatter(m, g.idx, g.rows, add=True)
            else:
                m.add_(g.to(m.dtype))
            p.copy_((p.to(torch.float32) - lr_t * m.to(torch.float32)).to(p.dtype))
        return params, state

    return Optimizer(init, update)


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, clip: Optional[float] = None, lazy: bool = False):
    """AdamW; weight decay applies to leaves with two or more dimensions.
    ``lazy=True`` applies LazyAdam semantics to CompactGrad leaves: the rows
    the sketch did not keep keep their moments and parameters unchanged.
    Dense leaves (and the default ``lazy=False``) take standard AdamW."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def moments(m, v, g32):
        # one definition of the moment update, for whole leaves and kept rows
        m.mul_(b1).add_(g32, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)

    def step_of(p32, m, v, c1, c2):
        upd = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay and p32.dim() >= 2:
            upd = upd + weight_decay * p32
        return upd

    @torch.no_grad()
    def update(grads, state, params, step):
        if clip is not None:
            grads, _ = clip_by_global_norm(grads, clip, params)
        t = float(step) + 1.0
        lr_t = lr_fn(step)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]), tree_leaves(state["v"])):
            if not _trainable(p):
                continue
            if is_compact(g) and lazy:
                # kept rows only: gather, the standard AdamW math, scatter back
                rows = g.rows.to(torch.float32)
                m_r, v_r = row_gather(m, g.idx), row_gather(v, g.idx)
                moments(m_r, v_r, rows)
                p_r = row_gather(p, g.idx).to(torch.float32)
                row_scatter(p, g.idx, p_r - lr_t * step_of(p_r, m_r, v_r, c1, c2), add=False)
                row_scatter(m, g.idx, m_r, add=False)
                row_scatter(v, g.idx, v_r, add=False)
                continue
            if is_compact(g):
                # the decay everywhere (with the dense part, if any), then the
                # kept rows' gradient terms by the dense update's own
                # operations: the dense update on the densified gradient
                if g.dense is None:
                    m.mul_(b1)
                    v.mul_(b2)
                else:
                    moments(m, v, g.dense.to(torch.float32))
                m_r, v_r = row_gather(m, g.idx), row_gather(v, g.idx)
                rows = g.rows.to(torch.float32)
                m_r.add_(rows, alpha=1.0 - b1)
                v_r.addcmul_(rows, rows, value=1.0 - b2)
                row_scatter(m, g.idx, m_r, add=False)
                row_scatter(v, g.idx, v_r, add=False)
            else:
                moments(m, v, g.to(torch.float32))
            p32 = p.to(torch.float32)
            p.copy_((p32 - lr_t * step_of(p32, m, v, c1, c2)).to(p.dtype))
        return params, state

    return Optimizer(init, update)
