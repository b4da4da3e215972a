"""Unbiased randomized VJP sketches (paper §3–4).

Port of ``repro/core/sketching.py``: :class:`SketchConfig` plus functions that
turn an output-gradient matrix ``G`` ([N, d_out]) into a column plan or an
unbiased surrogate ``Ĝ`` with ``E[Ĝ | G] = G``. The ``mask`` backend
materialises ``Ĝ``; the ``compact`` and ``pallas`` backends use the plan's
kept indices and ``1/p`` scales directly (``core/sketched_linear.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import solver
from repro_torch.core.scores import SCORE_METHODS, column_scores

__all__ = [
    "SketchConfig",
    "ColumnPlan",
    "COLUMN_METHODS",
    "ALL_METHODS",
    "static_rank",
    "static_block_rank",
    "effective_cfg",
    "column_plan",
    "column_gate",
    "sketch_dense",
]

COLUMN_METHODS = ("per_column",) + SCORE_METHODS
ALL_METHODS = ("none", "per_element", "per_sample", "rcs") + COLUMN_METHODS


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Static configuration of one sketched VJP site.

    Attributes:
      method: one of :data:`ALL_METHODS`.
      budget: fraction ``p ∈ (0, 1]`` of coordinates kept.
      exact_r: correlated exact-r sampling (Lemma 3.1) vs independent gates.
      backend: ``mask`` | ``compact`` | ``pallas``, or any estimator registered
        with ``repro_torch.core.estimators.register_estimator``. ``pallas``
        keeps the JAX package's name: on the card it runs the hand-written
        Hopper kernels that replace the Pallas ones.
      round_to: round the static keep-count ``r`` up to a multiple.
      block: column-block granularity; 0/1 = per-column, >1 samples whole
        contiguous column blocks (the kernels' layout).
      ridge: relative ridge for the RCS inverse square root.
    """

    method: str = "l1"
    budget: float = 0.1
    exact_r: bool = True
    backend: str = "mask"
    round_to: int = 1
    block: int = 0
    ridge: float = 1e-5

    def __post_init__(self):
        if self.method not in ALL_METHODS:
            raise ValueError(f"unknown sketch method {self.method!r}")
        if not (0.0 < self.budget <= 1.0):
            raise ValueError(f"budget must be in (0, 1], got {self.budget}")
        if self.backend in ("mask", "compact", "pallas"):
            if self.backend in ("compact", "pallas") and self.method not in COLUMN_METHODS:
                raise ValueError(
                    f"backend {self.backend!r} requires a column-family method, got {self.method!r}")
            if self.backend in ("compact", "pallas") and not self.exact_r:
                raise ValueError("compact/pallas backends need exact_r=True (static shapes)")
        else:
            from repro_torch.core import estimators as _est

            try:
                est = _est.get_estimator(self.backend)
            except KeyError as e:
                raise ValueError(str(e)) from None
            est.validate(self)

    @property
    def is_noop(self) -> bool:
        return self.method == "none" or self.budget >= 1.0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def static_rank(cfg: SketchConfig, n: int) -> int:
    """Static keep-count r for a node with n output coordinates."""
    r = max(1, int(round(cfg.budget * n)))
    return min(n, _round_up(r, max(1, cfg.round_to)))


def static_block_rank(cfg: SketchConfig, n: int) -> int:
    """Static number of kept column blocks (block-granular sketches)."""
    if not (cfg.block > 1 and n % cfg.block == 0):
        raise ValueError(f"width {n} is not a multiple of block {cfg.block}")
    nb = n // cfg.block
    return max(1, min(nb, int(round(cfg.budget * nb))))


def effective_cfg(cfg: SketchConfig, n: int) -> SketchConfig:
    """Block-granular configs fall back to per-column granularity on sites
    whose width does not divide the block — same estimator, still unbiased."""
    if cfg.block > 1 and (n < cfg.block or n % cfg.block != 0):
        return dataclasses.replace(cfg, block=0)
    return cfg


@dataclasses.dataclass
class ColumnPlan:
    """A sampled column sketch: compact (indices + scales) and/or dense gate.

    Block-granular plans index column *blocks*; ``gate`` and ``probs`` are
    expanded back to per-column size.
    """

    indices: Optional[torch.Tensor]  # [r] int64, ascending (exact-r only)
    scales: Optional[torch.Tensor]  # [r] f32: 1/p at kept columns
    gate: Optional[torch.Tensor]  # [n] f32: z_i/p_i
    probs: torch.Tensor  # [n] f32 marginals


def _proxy_scores(cfg: SketchConfig, G2d: torch.Tensor, W: Optional[torch.Tensor]) -> torch.Tensor:
    """Column proxy scores. On the ``pallas`` backend the ℓ1/ℓ2 families go
    through the score kernel (``kernels.ops.col_l1_scores``: one pass over G,
    fp32 accumulation); everything else uses :func:`column_scores`."""
    base = cfg.method[:-3] if cfg.method.endswith("_sq") else cfg.method
    if cfg.backend == "pallas" and base in ("l1", "l2"):
        from repro_torch.kernels import ops as kops

        if base == "l1":
            s = kops.col_l1_scores(G2d, mode="l1")
        else:
            s = torch.sqrt(kops.col_l1_scores(G2d, mode="l2"))
        return s.square() if cfg.method.endswith("_sq") else s
    return column_scores(cfg.method, G2d, W)


def _column_probs(cfg: SketchConfig, G2d, W, r: int) -> torch.Tensor:
    n = G2d.shape[-1]
    if cfg.method == "per_column":
        return torch.full((n,), r / n, dtype=torch.float32, device=G2d.device)
    s = _proxy_scores(cfg, G2d, W)
    return solver.optimal_probabilities(s.square(), r)  # p ∝ s ⇔ w = s²


def _ones_plan(n: int, n_idx: int, device) -> ColumnPlan:
    ones = torch.ones(n, dtype=torch.float32, device=device)
    return ColumnPlan(indices=torch.arange(n_idx, device=device),
                      scales=torch.ones(n_idx, dtype=torch.float32, device=device),
                      gate=ones, probs=ones)


def column_plan(cfg: SketchConfig, G2d: torch.Tensor, W: Optional[torch.Tensor],
                gen: torch.Generator, *, want_compact: bool) -> ColumnPlan:
    """Sample a column sketch for gradient matrix ``G2d`` ([N, n]) from the
    site's generator ``gen``."""
    n = G2d.shape[-1]
    cfg = effective_cfg(cfg, n)
    if cfg.block > 1:
        return _block_plan(cfg, G2d, W, gen, want_compact=want_compact)
    r = static_rank(cfg, n)
    p = _column_probs(cfg, G2d, W, r)
    if r >= n:
        return _ones_plan(n, n, G2d.device)
    if cfg.exact_r:
        idx = solver.sample_exact_r(gen, p, r)
        inv_p_sel = 1.0 / p[idx].clamp_min(1e-20)
        if want_compact:
            return ColumnPlan(indices=idx, scales=inv_p_sel, gate=None, probs=p)
        gate = torch.zeros(n, dtype=torch.float32, device=G2d.device)
        gate[idx] = inv_p_sel
        return ColumnPlan(indices=idx, scales=inv_p_sel, gate=gate, probs=p)
    z = solver.sample_independent(gen, p)
    return ColumnPlan(indices=None, scales=None, gate=z / p.clamp_min(1e-20), probs=p)


def _block_plan(cfg: SketchConfig, G2d, W, gen, *, want_compact: bool) -> ColumnPlan:
    """Block-granular sketch: pool proxy weights per block, sample blocks.
    Every column of a kept block is rescaled by ``1/p_block``."""
    n = G2d.shape[-1]
    bs = cfg.block
    nb = n // bs
    rb = static_block_rank(cfg, n)
    if cfg.method == "per_column":
        p = torch.full((nb,), rb / nb, dtype=torch.float32, device=G2d.device)
    else:
        s = _proxy_scores(cfg, G2d, W)
        # pool proxy *weights* (w = s²) per block; probabilities ∝ sqrt(pool)
        w_blk = s.square().reshape(nb, bs).sum(-1)
        p = solver.optimal_probabilities(w_blk, rb)
    if rb >= nb:
        return _ones_plan(n, nb, G2d.device)
    idx = solver.sample_exact_r(gen, p, rb)
    inv_p_sel = 1.0 / p[idx].clamp_min(1e-20)
    probs_cols = p.repeat_interleave(bs)
    if want_compact:
        return ColumnPlan(indices=idx, scales=inv_p_sel, gate=None, probs=probs_cols)
    gate_blk = torch.zeros(nb, dtype=torch.float32, device=G2d.device)
    gate_blk[idx] = inv_p_sel
    return ColumnPlan(indices=idx, scales=inv_p_sel,
                      gate=gate_blk.repeat_interleave(bs), probs=probs_cols)


def column_gate(cfg: SketchConfig, G2d, W, gen) -> torch.Tensor:
    """Dense ``[n]`` gate (z/p) for mask-backend column methods."""
    return column_plan(cfg, G2d, W, gen, want_compact=False).gate


def sketch_dense(cfg: SketchConfig, G2d: torch.Tensor, W: Optional[torch.Tensor],
                 gen: torch.Generator) -> torch.Tensor:
    """The full-size unbiased surrogate ``Ĝ`` (``E[Ĝ|G] = G``).

    ``per_element`` masks W and X, not G, and is handled by the mask
    estimator. ``rcs`` (the rank-constrained sketch) is not ported yet.
    """
    if cfg.is_noop:
        return G2d
    N = G2d.shape[0]
    if cfg.method == "per_sample":
        # Alg. 4: Bernoulli gate per (flattened) sample row.
        z = torch.bernoulli(torch.full((N,), cfg.budget, device=G2d.device), generator=gen)
        return G2d * (z / cfg.budget).to(G2d.dtype)[:, None]
    if cfg.method == "rcs":
        raise NotImplementedError("the rcs sketch (apply_rcs) is not ported to repro_torch yet")
    gate = column_gate(cfg, G2d, W, gen)
    return G2d * gate[None, :].to(G2d.dtype)
