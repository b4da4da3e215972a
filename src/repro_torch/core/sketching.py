"""Unbiased randomized VJP sketches (paper §3–4).

Port of ``repro/core/sketching.py``: :class:`SketchConfig` plus functions that
turn an output-gradient matrix ``G`` ([N, d_out]) into a column plan or an
unbiased surrogate ``Ĝ`` with ``E[Ĝ | G] = G``. The ``mask`` backend
materialises ``Ĝ``; the ``compact`` and ``pallas`` backends use the plan's
kept indices and ``1/p`` scales directly (``core/sketched_linear.py``). The
plan-carry backends (``onepass``, ``stale``) sample from scores carried over
from the previous step (:func:`column_plan_from_scores`), with no read of G.
The ``rcs`` method (Prop. 3.3) sketches spectral directions instead of
columns: :func:`rcs_plan` builds its directions and probabilities and
:func:`apply_rcs_directions` applies a sampled set of them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import rng
from repro_torch.core import solver
from repro_torch.core.scores import SCORE_METHODS, column_scores, summed_column_scores

__all__ = [
    "SketchConfig",
    "ColumnPlan",
    "COLUMN_METHODS",
    "ALL_METHODS",
    "static_rank",
    "static_block_rank",
    "effective_cfg",
    "column_plan",
    "column_plan_from_scores",
    "column_gate",
    "sketch_dense",
    "RcsPlan",
    "rcs_plan",
    "rcs_plan_from",
    "rcs_mesh_plan",
    "row_gate",
    "apply_rcs_directions",
    "apply_rcs",
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
      backend: ``mask`` | ``compact`` | ``pallas`` | ``onepass`` | ``stale``,
        or any estimator registered with
        ``repro_torch.core.estimators.register_estimator``. ``pallas`` keeps
        the JAX package's name: on the card it runs the hand-written Hopper
        kernels that replace the Pallas ones.
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


def _proxy_scores(cfg: SketchConfig, G2d: torch.Tensor, W: Optional[torch.Tensor],
                  score_psum_axes=None) -> torch.Tensor:
    """Column proxy scores. On the ``pallas`` backend the ℓ1/ℓ2 families go
    through the score kernel (``kernels.ops.col_l1_scores``: one pass over G,
    fp32 accumulation); everything else uses :func:`column_scores`.

    ``score_psum_axes`` (a :class:`~repro_torch.launch.mesh.Axes`, or None):
    the data axes the batch is sharded over. The column reductions are
    summed over them before the score is formed (the l2 mode's square root
    after the sum), so every replica scores the whole batch and draws the
    SAME plan from the shared seed: the paper's batch-shared sketch, which
    the compressed gradient collective needs. A site split over model (its
    ``cols`` or ``rows``) gets the whole width's scores: each column's score
    is its own, so this rank's are all-gathered; ``gsv`` mixes columns (its
    GᵀG spans the width), so on a column split G's columns are gathered
    first and every rank scores the whole width."""
    base = cfg.method[:-3] if cfg.method.endswith("_sq") else cfg.method
    axes = score_psum_axes
    psum = (lambda t: t) if axes is None else axes.psum
    if axes is not None and axes.n_cols > 1 and base == "gsv":
        return summed_column_scores(cfg.method, axes.gather_cols(G2d), W, psum)
    if cfg.backend == "pallas" and base in ("l1", "l2"):
        from repro_torch.kernels import ops as kops

        red = psum(kops.col_l1_scores(G2d, mode=base))
        s = red if base == "l1" else torch.sqrt(red)
        s = s.square() if cfg.method.endswith("_sq") else s
    elif axes is None:
        return column_scores(cfg.method, G2d, W)
    else:
        s = summed_column_scores(cfg.method, G2d, W, psum,
                                 axes.row_sum if axes.rows else None)
    return s if axes is None else axes.widen(s)


def _width(G2d: torch.Tensor, score_psum_axes) -> int:
    """The plan's width: G's columns, times the model ranks they are split
    over (:func:`_proxy_scores`)."""
    return G2d.shape[-1] * (1 if score_psum_axes is None else score_psum_axes.n_cols)


def _column_probs(cfg: SketchConfig, G2d, W, r: int, score_psum_axes=None) -> torch.Tensor:
    n = _width(G2d, score_psum_axes)
    if cfg.method == "per_column":
        return torch.full((n,), r / n, dtype=torch.float32, device=G2d.device)
    s = _proxy_scores(cfg, G2d, W, score_psum_axes)
    return solver.optimal_probabilities(s.square(), r)  # p ∝ s ⇔ w = s²


def _ones_plan(n: int, n_idx: int, device) -> ColumnPlan:
    ones = torch.ones(n, dtype=torch.float32, device=device)
    return ColumnPlan(indices=torch.arange(n_idx, device=device),
                      scales=torch.ones(n_idx, dtype=torch.float32, device=device),
                      gate=ones, probs=ones)


def column_plan(cfg: SketchConfig, G2d: torch.Tensor, W: Optional[torch.Tensor],
                gen: torch.Generator, *, want_compact: bool,
                score_psum_axes=None) -> ColumnPlan:
    """Sample a column sketch for gradient matrix ``G2d`` ([N, n]) from the
    site's generator ``gen``; ``score_psum_axes``: the data axes whose
    ranks pool their scores (:func:`_proxy_scores`), and where a site is
    split over model, the axes of the split: the plan then spans the whole
    width."""
    n = _width(G2d, score_psum_axes)
    cfg = effective_cfg(cfg, n)
    if cfg.block > 1:
        return _block_plan(cfg, G2d, W, gen, want_compact=want_compact,
                           score_psum_axes=score_psum_axes)
    r = static_rank(cfg, n)
    p = _column_probs(cfg, G2d, W, r, score_psum_axes)
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


def _block_plan(cfg: SketchConfig, G2d, W, gen, *, want_compact: bool,
                score_psum_axes=None) -> ColumnPlan:
    """Block-granular sketch: pool proxy weights per block, sample blocks.
    Every column of a kept block is rescaled by ``1/p_block``."""
    n = _width(G2d, score_psum_axes)
    bs = cfg.block
    nb = n // bs
    rb = static_block_rank(cfg, n)
    if cfg.method == "per_column":
        p = torch.full((nb,), rb / nb, dtype=torch.float32, device=G2d.device)
    else:
        s = _proxy_scores(cfg, G2d, W, score_psum_axes)
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


def _weights_from_scores(scores: torch.Tensor) -> torch.Tensor:
    """Convex-program weights from precomputed proxy scores: ``w = s²``, with
    an all-zero guard (uniform), so the sampler's marginals stay well defined
    for any carried state. ``optimal_probabilities`` adds its own relative
    floor, keeping every ``p_i`` strictly positive: that is what keeps a plan
    sampled from STALE scores conditionally unbiased (staleness can inflate
    the variance, never zero out a coordinate's probability)."""
    w = scores.to(torch.float32).square()
    return torch.where(w.sum() > 0, w, torch.ones_like(w))


def column_plan_from_scores(cfg: SketchConfig, scores: torch.Tensor, gen: torch.Generator,
                            *, want_compact: bool = True) -> ColumnPlan:
    """Sample a column sketch from PRECOMPUTED per-column proxy scores, with
    no read of G: the planning half of the one-pass backward paths, fed the
    previous step's scores by the plan-carry estimators.

    ``scores`` ([n] f32, non-negative) follow :func:`column_scores` semantics
    for ``cfg.method``. Requires ``exact_r`` (static compact shapes). The
    sample is drawn from the site's generator ``gen``.
    """
    n = scores.shape[-1]
    dev = scores.device
    cfg = effective_cfg(cfg, n)
    if not cfg.exact_r:
        raise ValueError("column_plan_from_scores requires exact_r=True")
    if cfg.block > 1:
        bs = cfg.block
        nb = n // bs
        rb = static_block_rank(cfg, n)
        w_blk = _weights_from_scores(scores).reshape(nb, bs).sum(-1)
        w_blk = torch.where(w_blk.sum() > 0, w_blk, torch.ones_like(w_blk))
        if rb >= nb:
            return _ones_plan(n, nb, dev)
        p = solver.optimal_probabilities(w_blk, rb)
        idx = solver.sample_exact_r(gen, p, rb)
        inv_p_sel = 1.0 / p[idx].clamp_min(1e-20)
        probs_cols = p.repeat_interleave(bs)
        if want_compact:
            return ColumnPlan(indices=idx, scales=inv_p_sel, gate=None, probs=probs_cols)
        gate_blk = torch.zeros(nb, dtype=torch.float32, device=dev)
        gate_blk[idx] = inv_p_sel
        return ColumnPlan(indices=idx, scales=inv_p_sel,
                          gate=gate_blk.repeat_interleave(bs), probs=probs_cols)
    r = static_rank(cfg, n)
    if r >= n:
        return _ones_plan(n, n, dev)
    p = solver.optimal_probabilities(_weights_from_scores(scores), r)
    idx = solver.sample_exact_r(gen, p, r)
    inv_p_sel = 1.0 / p[idx].clamp_min(1e-20)
    if want_compact:
        return ColumnPlan(indices=idx, scales=inv_p_sel, gate=None, probs=p)
    gate = torch.zeros(n, dtype=torch.float32, device=dev)
    gate[idx] = inv_p_sel
    return ColumnPlan(indices=idx, scales=inv_p_sel, gate=gate, probs=p)


def column_gate(cfg: SketchConfig, G2d, W, gen, score_psum_axes=None) -> torch.Tensor:
    """Dense ``[n]`` gate (z/p) for mask-backend column methods."""
    return column_plan(cfg, G2d, W, gen, want_compact=False,
                       score_psum_axes=score_psum_axes).gate


# ---------------------------------------------------------------------------
# RCS — Rank-Constrained Sketch (Prop. 3.3), factored low-rank application.
# ---------------------------------------------------------------------------


def _sym_sqrt_invsqrt(gamma: torch.Tensor, ridge: float):
    """``Γ^{1/2}`` and ``Γ^{-1/2}`` of a symmetric PSD ``gamma``, eigenvalues
    floored at ``ridge`` times their mean."""
    evals, evecs = torch.linalg.eigh(gamma)
    floor = ridge * evals.mean().clamp_min(1e-30)
    s = torch.sqrt(torch.maximum(evals, floor))
    return (evecs * s) @ evecs.T, (evecs / s) @ evecs.T


@dataclasses.dataclass
class RcsPlan:
    """The sampling problem of one rcs sketch: the eigenvectors ``U`` ([n,
    n], columns are the directions), their probabilities ``probs`` ([n],
    summing to ``r``) and ``Γ^{±1/2}`` of G's column covariance."""

    U: torch.Tensor
    probs: torch.Tensor
    half: torch.Tensor
    inv_half: torch.Tensor
    r: int


def rcs_plan_from(cfg: SketchConfig, gamma: torch.Tensor, wwt: torch.Tensor) -> RcsPlan:
    """:func:`rcs_plan` from G's column covariance ``gamma`` (``Γ = GᵀG /
    N``, [n, n]) and ``wwt`` (``W Wᵀ``, [n, n]) of the whole batch and
    width: the half of the plan that a mesh's ranks compute alike from
    all-reduced inputs (:func:`rcs_mesh_plan`)."""
    half, inv_half = _sym_sqrt_invsqrt(gamma, cfg.ridge)
    # JᵀJ = W Wᵀ in the row convention
    evals, U = torch.linalg.eigh(half @ wwt @ half)  # ascending
    r = static_rank(cfg, gamma.shape[0])
    probs = solver.optimal_probabilities(evals.clamp_min(0.0), r)
    return RcsPlan(U=U, probs=probs, half=half, inv_half=inv_half, r=r)


def rcs_plan(cfg: SketchConfig, G2d: torch.Tensor, W: torch.Tensor) -> RcsPlan:
    """Directions and probabilities of the minimal-distortion rank-r sketch
    (Prop. 3.3): the eigenvectors of ``A = Γ^{1/2} W Wᵀ Γ^{1/2}`` with ``Γ =
    GᵀG / N``, sampled with the optimal probabilities for their eigenvalues.
    ``eigh`` is a library call here as in JAX (``jnp.linalg.eigh``)."""
    N = G2d.shape[0]
    Gf, Wf = G2d.to(torch.float32), W.to(torch.float32)
    return rcs_plan_from(cfg, (Gf.T @ Gf) / N, Wf @ Wf.T)


def rcs_mesh_plan(cfg: SketchConfig, G2d: torch.Tensor, W: torch.Tensor, axes):
    """The whole batch's and width's :class:`RcsPlan` on a mesh rank, and
    the whole width's columns of this rank's rows of G (float32). ``axes``
    (:class:`~repro_torch.launch.mesh.Axes`): ``Γ``'s Gram and row count
    summed over the data axes; on a column split G's columns and W's rows
    all-gathered over model, on a row split ``W Wᵀ`` summed over model from
    each rank's chunk of d_in. Every rank eigendecomposes the same
    all-reduced bits, so all keep the same directions."""
    from repro_torch.launch.mesh import all_gather

    Gw = axes.gather_cols(G2d).to(torch.float32)
    rows = axes.psum(torch.full((), float(G2d.shape[0]), dtype=torch.float32,
                                device=G2d.device))
    Wf = W.to(torch.float32)
    if axes.cols:
        Wf = all_gather(Wf, axes.cols, axes.mesh, axis=0)
    wwt = Wf @ Wf.T
    if axes.rows:
        wwt = axes.row_sum(wwt)
    return rcs_plan_from(cfg, axes.psum(Gw.T @ Gw) / rows, wwt), Gw


def apply_rcs_directions(G2d: torch.Tensor, plan: RcsPlan, idx: torch.Tensor, *,
                         lo: int = 0, n_loc: Optional[int] = None) -> torch.Tensor:
    """``Ĝ = ((G Γ^{-1/2}) U_sel ⊙ 1/p_sel) (U_selᵀ Γ^{1/2})`` for the sampled
    directions ``idx`` ([r] int): O(N n r + n² r), never the n × n
    operator. ``lo``/``n_loc``: only Ĝ's columns ``[lo, lo + n_loc)`` (a
    column shard's; ``G2d`` still the whole width's). An eigenvector's sign
    cancels between the two factors."""
    d_sel = 1.0 / plan.probs[idx].clamp_min(1e-20)  # z/p on the kept directions
    U_sel = plan.U[:, idx]
    half = plan.half if n_loc is None else plan.half[:, lo:lo + n_loc]
    Ghat = ((G2d.to(torch.float32) @ (plan.inv_half @ U_sel)) * d_sel[None, :]) \
        @ (U_sel.T @ half)
    return Ghat.to(G2d.dtype)


def apply_rcs(cfg: SketchConfig, G2d: torch.Tensor, W: torch.Tensor,
              gen: torch.Generator, score_psum_axes=None) -> torch.Tensor:
    """``Ĝ = G R*ᵀ`` with ``R*`` from Prop. 3.3, directions drawn from ``gen``
    (exact-r). Under a mesh (``score_psum_axes``) the plan is the whole
    batch's and width's (:func:`rcs_mesh_plan`), the directions drawn from
    the unfolded seed on every rank, and Ĝ this rank's rows and columns."""
    if score_psum_axes is None:
        plan, Gw, lo, n_loc = rcs_plan(cfg, G2d, W), G2d, 0, None
    else:
        plan, Gw = rcs_mesh_plan(cfg, G2d, W, score_psum_axes)
        n_loc = G2d.shape[1]
        lo = score_psum_axes.col_offset(n_loc)
    if plan.r >= Gw.shape[1]:
        return G2d
    idx = solver.sample_exact_r(gen, plan.probs, plan.r)
    return apply_rcs_directions(Gw, plan, idx, lo=lo, n_loc=n_loc).to(G2d.dtype)


# the fold rule's tags (``rng.fold_generator``): which of a site's random
# tensors a folded seed draws
TAG_MASK_W, TAG_MASK_X, TAG_ROW_GATE = 1, 2, 3


def row_gate(cfg: SketchConfig, N: int, gen: torch.Generator, device, folds=()) -> torch.Tensor:
    """Alg. 4's ``[N]`` gate ``z / p``, one Bernoulli draw per (flattened)
    sample row. ``folds``: this rank's index over the data axes the rows
    are sharded over (the fold rule; none on one device, where the gate is
    ``gen``'s draw)."""
    z = torch.bernoulli(torch.full((N,), cfg.budget, device=device),
                        generator=rng.fold_generator(gen, TAG_ROW_GATE, folds))
    return z / cfg.budget


def sketch_dense(cfg: SketchConfig, G2d: torch.Tensor, W: Optional[torch.Tensor],
                 gen: torch.Generator, score_psum_axes=None) -> torch.Tensor:
    """The full-size unbiased surrogate ``Ĝ`` (``E[Ĝ|G] = G``).

    ``per_element`` masks W and X, not G, and is handled by the mask
    estimator. Under a mesh (``score_psum_axes``) ``per_sample``'s gate
    follows the fold rule: drawn per data shard of the rows, shared by the
    model ranks (G's rows are the same on each); ``rcs`` takes the whole
    batch's and width's plan (:func:`apply_rcs`).
    """
    if cfg.is_noop:
        return G2d
    if cfg.method == "per_sample":
        folds = () if score_psum_axes is None else score_psum_axes.data_fold()
        gate = row_gate(cfg, G2d.shape[0], gen, G2d.device, folds)
        return G2d * gate.to(G2d.dtype)[:, None]
    if cfg.method == "rcs":
        if W is None:
            raise ValueError("RCS requires the layer weight W")
        return apply_rcs(cfg, G2d, W, gen, score_psum_axes)
    gate = column_gate(cfg, G2d, W, gen, score_psum_axes)
    if score_psum_axes is not None:
        gate = score_psum_axes.narrow(gate)  # this rank's columns of a split site
    return G2d * gate[None, :].to(G2d.dtype)
