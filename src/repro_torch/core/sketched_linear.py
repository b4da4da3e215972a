"""Linear layer with an unbiased sketched backward pass (paper App. C).

Port of ``repro/core/sketched_linear.py``. Forward: ``y = x @ W.T (+ b)`` with
``W: [d_out, d_in]``. The backward replaces the exact VJP by the configured
estimator from the registry (``core/estimators.py``):

* ``mask``    — Alg. 3 / 4 / 5 / 6 verbatim (dense masked matmuls);
* ``compact`` — the r kept columns, reduced-shape matmuls (plain PyTorch);
* ``pallas``  — compact semantics; block-granular configs run the
                hand-written fused backward kernel (dX, compact dW and compact
                db from G's kept blocks) and the score kernel;
* ``onepass`` — plan carry: the plan is sampled from the previous step's
                scores; block-granular configs run the streaming kernel, whose
                one launch gives the gradients and every column's fresh score;
* ``stale``   — plan carry with a partial refresh: the fused kernel with its
                kept-block scores; the other columns keep their carried score.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import rng
from repro_torch.core import estimators
from repro_torch.core.estimators import EstimatorVJP
from repro_torch.core.scores import kernel_reduction_mode, scores_from_kernel_reduction
from repro_torch.core.sketching import (COLUMN_METHODS, TAG_MASK_W, TAG_MASK_X, SketchConfig,
                                        _width, column_plan, column_plan_from_scores,
                                        effective_cfg, sketch_dense, static_block_rank,
                                        static_rank)

__all__ = ["sketched_linear", "linear", "block_cols", "split_backward", "per_element"]


def with_probe(out: EstimatorVJP, plan) -> EstimatorVJP:
    """``out`` with its probe, from its compact rows and ``plan``'s keep
    marginals at the kept columns."""
    from repro_torch.telemetry.probes import probe_from_rows

    out.probe_p = plan.probs[out.cols]
    out.probe = probe_from_rows(out.rows, out.probe_p)
    return out


def block_cols(idx: torch.Tensor, block: int) -> torch.Tensor:
    """Per-column indices ``[rb*block]`` of the kept column blocks ``idx``."""
    return (idx[:, None] * block
            + torch.arange(block, dtype=idx.dtype, device=idx.device)[None, :]).reshape(-1)


def _same(t):
    return t


def per_element(cfg, G2d, X2d, w, gen, *, has_b, w_folds=(), x_folds=()) -> EstimatorVJP:
    """Alg. 3: independent Bernoulli(p) element masks on W (for dX) and X
    (for dW), each rescaled by 1/p; the bias gradient stays exact. Under a
    mesh the masks follow the fold rule (``rng.fold_generator``):
    ``w_folds`` are this rank's indices along the axes that shard ``w`` (a
    model split's rank; a weight gathered whole has none, its mask shared by
    every rank), ``x_folds`` those that shard ``X2d`` (the data rank of its
    rows, and the model rank of a row split's d_in chunk). With neither,
    both masks come from ``gen`` in turn: the single device's draws."""
    p = cfg.budget
    mw = torch.bernoulli(torch.full_like(w, p),
                         generator=rng.fold_generator(gen, TAG_MASK_W, w_folds))
    mx = torch.bernoulli(torch.full_like(X2d, p),
                         generator=rng.fold_generator(gen, TAG_MASK_X, x_folds))
    return EstimatorVJP(dx=(G2d @ (w * mw)) / p, dw=(G2d.T @ (X2d * mx)) / p,
                        db=G2d.sum(0) if has_b else None)


class _MaskEstimator(estimators.Estimator):
    """Paper-faithful dense backend: full-size Ĝ, dense downstream matmuls."""

    name = "mask"
    supports_compact_grad = False

    def apply(self, cfg, G2d, X2d, w, gen, *, has_b, score_psum_axes=None):
        if cfg.method == "per_element":
            axes, kw = score_psum_axes, {}
            if axes is not None:  # this rank's place on the mesh
                kw = {"w_folds": axes.model_fold(),
                      "x_folds": axes.data_fold() + (axes.model_fold() if axes.rows else ())}
            return per_element(cfg, G2d, X2d, w, gen, has_b=has_b, **kw)
        Ghat = sketch_dense(cfg, G2d, w, gen, score_psum_axes)
        return EstimatorVJP(dx=Ghat @ w, dw=Ghat.T @ X2d,
                            db=Ghat.sum(0) if has_b else None)

    def apply_with_probe(self, cfg, G2d, X2d, w, gen, *, has_b, score_psum_axes=None):
        """Column-family methods expose the plan's marginals, so the probe is
        a reduction over the sketched dW: the same gate from the same draws,
        the gradients of ``apply``. Other methods emit no probe."""
        if cfg.method not in COLUMN_METHODS or cfg.is_noop:
            return self.apply(cfg, G2d, X2d, w, gen, has_b=has_b,
                              score_psum_axes=score_psum_axes)
        from repro_torch.telemetry.probes import probe_from_rows

        plan = column_plan(cfg, G2d, w, gen, want_compact=False,
                           score_psum_axes=score_psum_axes)
        gate, probs = plan.gate, plan.probs
        if score_psum_axes is not None:  # this rank's columns of a split site
            gate, probs = score_psum_axes.narrow(gate), score_psum_axes.narrow(probs)
        Ghat = G2d * gate[None, :].to(G2d.dtype)
        dw = Ghat.T @ X2d
        return EstimatorVJP(dx=Ghat @ w, dw=dw, db=Ghat.sum(0) if has_b else None,
                            probe=probe_from_rows(dw, probs), probe_p=probs)


class _CompactEstimator(estimators.Estimator):
    """Exact-r compact backend: gather kept columns, reduced-shape matmuls
    (the fused plain version on block-granular configs).

    On a site split over model (``score_psum_axes`` with ``cols``, a column
    shard of G) the plan is the whole width's and the backward the rank's
    part of it (:func:`split_backward`); the block granularity and the rank
    follow the whole width (:func:`~repro_torch.core.sketching._width`)."""

    name = "compact"
    supports_compact_grad = True
    tp_shardable = True  # plan() is valid on a model shard of G
    # what the kernel's extra output refreshes: None, "all" the columns of
    # G (onepass), "kept" the kept columns (stale)
    refresh: Optional[str] = None

    def validate(self, cfg) -> None:
        if cfg.method not in COLUMN_METHODS:
            raise ValueError(
                f"backend {cfg.backend!r} requires a column-family method, "
                f"got {cfg.method!r}")
        if not cfg.exact_r:
            raise ValueError(
                f"{cfg.backend} backend needs exact_r=True (static shapes)")

    def compact_rank(self, cfg, n: int) -> int:
        lcfg = effective_cfg(cfg, n)
        if lcfg.block > 1:
            return static_block_rank(lcfg, n) * lcfg.block
        return static_rank(lcfg, n)

    def plan(self, cfg, G2d, w, gen, *, want_compact=True, score_psum_axes=None):
        return column_plan(cfg, G2d, w, gen, want_compact=want_compact,
                           score_psum_axes=score_psum_axes)

    def _apply_planned(self, cfg, G2d, X2d, w, gen, score_psum_axes=None):
        n = _width(G2d, score_psum_axes)
        cfg = effective_cfg(cfg, n)
        plan = column_plan(cfg, G2d, w, gen, want_compact=True,
                           score_psum_axes=score_psum_axes)
        lo = _col_offset(G2d, score_psum_axes)
        return self.apply_plan(cfg, G2d, X2d, w, plan.indices, plan.scales, lo=lo, n=n), plan

    def apply(self, cfg, G2d, X2d, w, gen, *, has_b, score_psum_axes=None):
        return self._apply_planned(cfg, G2d, X2d, w, gen, score_psum_axes)[0]

    def apply_with_probe(self, cfg, G2d, X2d, w, gen, *, has_b, score_psum_axes=None):
        """The compact rows (the fused kernel's dWc on block-granular
        configs) and the plan's marginals at the kept columns are all the
        probe needs: one ``[r]`` reduction after the same backward."""
        return with_probe(*self._apply_planned(cfg, G2d, X2d, w, gen, score_psum_axes))

    def apply_plan(self, cfg, G2d, X2d, w, indices, scales, *, lo: int = 0,
                   n: Optional[int] = None) -> EstimatorVJP:
        """The backward for a given plan (kept indices and ``1/p`` scales;
        block ids when ``cfg`` is block-granular on the width ``n``). ``G2d``
        holds the columns ``[lo, lo + G2d.shape[-1])`` of the whole width
        ``n`` (default: all of them); a part of it takes
        :func:`split_backward`."""
        n = G2d.shape[-1] if n is None else n
        cfg = effective_cfg(cfg, n)
        if lo != 0 or n != G2d.shape[-1]:
            return split_backward(self, cfg, G2d, X2d, w, indices, scales, lo=lo, n=n)[0]
        dX2d, rows, db_c, _ = self._kernel(cfg, G2d, indices, scales, w, X2d)
        return EstimatorVJP(dx=dX2d, rows=rows, cols=_cols(indices, cfg.block), db_c=db_c)

    def _kernel(self, cfg, G2d, idx, scales, w, X2d):
        """One launch of the plan ``(idx, scales)`` on ``G2d``: ``(dX, rows
        [k, d_in], db_c [k], extra)``, ``k`` the kept columns; ``extra`` is
        what :attr:`refresh` names (None here)."""
        if cfg.block > 1:
            # fused backward: dX, compact dW rows and compact db from G's
            # kept column blocks
            dX2d, dWc, db_blk = self._fused(cfg, G2d, idx, scales, w, X2d)
            return dX2d, dWc.reshape(-1, w.shape[1]), db_blk.reshape(-1), None
        out = self._per_column(G2d, idx, scales, w, X2d)
        return out.dx, out.rows, out.db_c, None

    def _fused(self, cfg, G2d, idx, scales, w, X2d):
        from repro_torch.kernels import ref as kref

        return kref.block_gather_matmul_fused_ref(G2d, idx, scales, w, X2d,
                                                  block=cfg.block)

    def _per_column(self, G2d, idx, scales, w, X2d):
        from repro_torch.kernels.ref import col_sum

        # one gather of G shared by dX, dW and db
        Gc = G2d[:, idx] * scales[None, :].to(G2d.dtype)
        Wc = w[idx]
        return EstimatorVJP(dx=Gc @ Wc, rows=Gc.T @ X2d, cols=idx, db_c=col_sum(Gc))


def _cols(indices: torch.Tensor, block: int) -> torch.Tensor:
    """The per-column indices of a plan's kept indices (block ids when
    ``block > 1``)."""
    return block_cols(indices, block) if block > 1 else indices


def _col_offset(G2d: torch.Tensor, score_psum_axes) -> int:
    """The whole width's index of ``G2d``'s first column (0 unless the site
    is split over model by its columns)."""
    return 0 if score_psum_axes is None else score_psum_axes.col_offset(G2d.shape[-1])


def split_backward(est, cfg, G2d, X2d, w, indices, scales, *, lo: int, n: int):
    """The rank's part of a compact backward whose plan spans a whole width
    ``n`` of which this rank holds the columns ``[lo, lo + n_loc)``: ``G2d
    [N, n_loc]`` and ``w [n_loc, d_in]`` (its shard), ``X2d [N, d_in]``;
    ``indices``/``scales`` the whole width's plan (ascending block ids where
    ``cfg`` is block-granular on ``n``, column ids otherwise).

    Static shapes: the shard's kept blocks are one run of the plan's sorted
    indices, found by ``searchsorted``, and are at most ``m = min(r,
    n_win)`` of them, ``n_win`` the blocks the shard touches. The kernel
    (``est._kernel``) runs ``m`` slots on a block-aligned window of the
    shard (the shard's columns at ``lo mod block``, zeros beside them, so a
    block that straddles two shards is each rank's part of it); an unfilled
    slot has scale 0 at a valid block and adds exact zeros.

    Returns ``(out, red)``. ``out.dx`` is this rank's partial dX (the sum
    over the ranks that split the width is the whole); ``out.rows`` and
    ``out.db_c`` are in the whole plan's layout ``[r * block]``, with zero
    rows where another shard's columns lie, and ``out.cols`` the plan's
    global column indices (the single device's). ``red``: this rank's
    ``[n_loc]`` raw column reductions, every column (``refresh == "all"``)
    or the kept ones and zeros elsewhere (``"kept"``), else None."""
    N, n_loc = G2d.shape
    bs = max(cfg.block, 1)
    first = lo // bs
    nw = -(-(lo + n_loc) // bs) - first
    off = lo - first * bs
    r = indices.shape[0]
    m = min(r, nw)
    dev = G2d.device
    # made on the device: no copy from the host, so a CUDA graph can hold it
    span = first + nw * torch.arange(2, dtype=indices.dtype, device=dev)
    i0, i1 = torch.searchsorted(indices, span).unbind(0)
    pos = i0 + torch.arange(m, dtype=indices.dtype, device=dev)
    valid = pos < i1
    at = indices[pos.clamp(max=r - 1)]
    blocks = torch.where(valid, at - first, torch.zeros_like(at))
    sc = torch.where(valid, scales[pos.clamp(max=r - 1)].to(torch.float32),
                     torch.zeros((), dtype=torch.float32, device=dev))
    Gw, Ww = G2d, w
    if off or nw * bs != n_loc:
        Gw = G2d.new_zeros(N, nw * bs)
        Gw[:, off:off + n_loc] = G2d
        Ww = w.new_zeros(nw * bs, w.shape[1])
        Ww[off:off + n_loc] = w
    dx, rows, db_c, extra = est._kernel(cfg, Gw, blocks, sc, Ww, X2d)
    # each slot's rows at its plan position; an unfilled slot's on a dump
    # block past the plan, cut off
    dest = _cols(torch.where(valid, pos, torch.full_like(pos, r)), bs)
    rows = rows.new_zeros((r + 1) * bs, rows.shape[1]).index_copy_(0, dest, rows)[:r * bs]
    db_c = db_c.new_zeros((r + 1) * bs).index_copy_(0, dest, db_c)[:r * bs]
    red = None
    if est.refresh == "all":
        red = extra[off:off + n_loc]
    elif est.refresh == "kept":
        wdest = _cols(torch.where(valid, blocks, torch.full_like(blocks, nw)), bs)
        red = extra.new_zeros((nw + 1) * bs).index_copy_(0, wdest, extra)[off:off + n_loc]
    return EstimatorVJP(dx=dx, rows=rows, cols=_cols(indices, bs), db_c=db_c), red


def _kept_mask(indices: torch.Tensor, block: int, n: int) -> torch.Tensor:
    """``[n]`` bool: the columns a plan keeps."""
    nb = n // max(block, 1)
    keep = torch.zeros(nb, dtype=torch.bool, device=indices.device).index_fill_(0, indices, True)
    return keep.repeat_interleave(block) if block > 1 else keep


class _PallasEstimator(_CompactEstimator):
    """Compact semantics realised by the kernels: on a CUDA tensor the
    hand-written Hopper kernels run; on a CPU tensor their plain versions."""

    name = "pallas"

    def _fused(self, cfg, G2d, idx, scales, w, X2d):
        from repro_torch.kernels import ops as kops

        return kops.block_gather_matmul_fused(G2d, idx, scales, w, X2d,
                                              block=cfg.block)

    def _per_column(self, G2d, idx, scales, w, X2d):
        # arbitrary column gathers have no kernel in either package
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.ref import col_sum

        dX2d = kops.gather_cols_matmul(G2d, idx, scales, w)
        rows = kops.gather_cols_matmul_dw(G2d, idx, scales, X2d)
        db_c = col_sum(G2d[:, idx] * scales[None, :].to(G2d.dtype))
        return EstimatorVJP(dx=dX2d, rows=rows, cols=idx, db_c=db_c)


class _PlanCarryEstimator(_PallasEstimator):
    """Shared machinery of the one-pass estimators: the step-t sketch is
    sampled from CARRIED column scores (the previous step's, or the uniform
    prior on the first step), with no score pass over G, and the backward's
    one sweep over G gives the gradient AND the score refresh.

    Unbiasedness does not depend on the carry being fresh: given the carried
    scores, every column keeps a strictly positive probability (the solver's
    relative floor and the all-zero guard of ``column_plan_from_scores``) and
    kept columns are rescaled by 1/p, so ``E[dW | carry] = GᵀX`` exactly;
    staleness moves only the variance.

    On a site split over model the carry is the whole width's: every rank
    samples the same plan from it, runs its part (:func:`split_backward`),
    and the fresh reductions of its columns, summed over data, are
    all-gathered over model into the whole width's refreshed scores.
    """

    plan_carry = True
    tp_shardable = False  # the carry is local-plan only

    def validate(self, cfg) -> None:
        super().validate(cfg)
        if kernel_reduction_mode(cfg.method) is None:
            raise ValueError(
                f"backend {cfg.backend!r} needs an l1/l2-family score method "
                f"(its fresh scores come from the backward kernel's column "
                f"reduction), got {cfg.method!r}")

    def carry_size(self, cfg, n: int) -> int:
        return n

    def apply(self, cfg, G2d, X2d, w, gen, *, has_b, score_psum_axes=None):
        return self.apply_with_state(cfg, G2d, X2d, w, gen, None, has_b=has_b,
                                     score_psum_axes=score_psum_axes)

    def apply_with_probe(self, cfg, G2d, X2d, w, gen, *, has_b, score_psum_axes=None):
        return self.apply_with_state(cfg, G2d, X2d, w, gen, None, has_b=has_b,
                                     want_probe=True, score_psum_axes=score_psum_axes)

    def apply_with_state(self, cfg, G2d, X2d, w, gen, state, *, has_b, want_probe=False,
                         score_psum_axes=None):
        """``score_psum_axes``: the kernel's column reductions of this rank's
        rows are summed over those data axes before they become the fresh
        scores (the carry is replicated: every replica samples alike), and
        on a column split widened to the whole width."""
        axes = score_psum_axes
        n = _width(G2d, axes)
        cfg = effective_cfg(cfg, n)
        if state is None:
            state = torch.ones(n, dtype=torch.float32, device=G2d.device)  # uniform prior
        plan = column_plan_from_scores(cfg, state, gen, want_compact=True)
        lo = _col_offset(G2d, axes)
        if lo != 0 or n != G2d.shape[-1]:
            out, red = split_backward(self, cfg, G2d, X2d, w, plan.indices, plan.scales,
                                      lo=lo, n=n)
            out.state = self._refresh_split(cfg, plan, state, axes.widen(axes.psum(red)))
        else:
            out = self._one_pass(cfg, G2d, plan, w, X2d, state,
                                 _same if axes is None else axes.psum)
        # the probe reads the one sweep's rows: no second kernel launch
        return with_probe(out, plan) if want_probe else out

    def _one_pass(self, cfg, G2d, plan, w, X2d, state, psum=_same) -> EstimatorVJP:
        """The one sweep over the whole width: the gradients and the
        refreshed carry, from the kernel's reductions summed by ``psum``."""
        dX2d, rows, db_c, extra = self._kernel(cfg, G2d, plan.indices, plan.scales, w, X2d)
        cols = _cols(plan.indices, cfg.block)
        return EstimatorVJP(dx=dX2d, rows=rows, cols=cols, db_c=db_c,
                            state=self._refresh(cfg, cols, state, psum(extra)))

    def _refresh(self, cfg, cols, state, red) -> torch.Tensor:
        """The refreshed carry from the sweep's (data-summed) reductions."""
        raise NotImplementedError

    def _refresh_split(self, cfg, plan, state, red) -> torch.Tensor:
        """The refreshed carry from the whole width's ``[n]`` reductions of a
        split sweep (:func:`split_backward`'s ``red``, summed and widened)."""
        raise NotImplementedError


class _OnePassEstimator(_PlanCarryEstimator):
    """Streaming selection: ALL of G goes through the backward kernel once;
    the kept blocks (the plan sampled from the carried scores) give dX,
    compact dW and db, and EVERY column's fresh score comes from the same
    launch: a full score refresh per step."""

    name = "onepass"
    refresh = "all"

    def _kernel(self, cfg, G2d, idx, scales, w, X2d):
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import ref as kref

        mode = kernel_reduction_mode(cfg.method)
        if cfg.block > 1:
            dX2d, dWc, db_blk, red = kops.block_stream_matmul_fused(
                G2d, idx, scales, w, X2d, block=cfg.block, score_mode=mode)
            return dX2d, dWc.reshape(-1, w.shape[1]), db_blk.reshape(-1), red
        # arbitrary column gathers have no kernel in either package
        return kref.gather_cols_onepass_ref(G2d, idx, scales, w, X2d, score_mode=mode)

    def _refresh(self, cfg, cols, state, red):
        return scores_from_kernel_reduction(cfg.method, red)

    _refresh_split = _refresh  # every column's reduction either way


class _StalePlanEstimator(_PlanCarryEstimator):
    """Stale plan: the kept-only fused backward (the ``pallas`` backend's G
    traffic: dropped blocks are never read), with the kept columns' raw
    scores reduced in the same launch. The refresh is PARTIAL: unkept columns
    keep their carried score until they are sampled."""

    name = "stale"
    refresh = "kept"

    def _kernel(self, cfg, G2d, idx, scales, w, X2d):
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import ref as kref

        mode = kernel_reduction_mode(cfg.method)
        if cfg.block > 1:
            dX2d, dWc, db_blk, kept = kops.block_gather_matmul_fused(
                G2d, idx, scales, w, X2d, block=cfg.block, with_scores=True,
                score_mode=mode)
            return dX2d, dWc.reshape(-1, w.shape[1]), db_blk.reshape(-1), kept.reshape(-1)
        return kref.gather_cols_fused_scores_ref(G2d, idx, scales, w, X2d, score_mode=mode)

    def _refresh(self, cfg, cols, state, kept):
        # out of place: the carry passed in stays as it was
        fresh = state.detach().to(torch.float32, copy=True)
        fresh[cols] = scores_from_kernel_reduction(cfg.method, kept)
        return fresh

    def _refresh_split(self, cfg, plan, state, red):
        keep = _kept_mask(plan.indices, cfg.block, state.shape[-1])
        return torch.where(keep, scores_from_kernel_reduction(cfg.method, red),
                           state.detach().to(torch.float32))


estimators.register_estimator(_MaskEstimator())
estimators.register_estimator(_CompactEstimator())
estimators.register_estimator(_PallasEstimator())
estimators.register_estimator(_OnePassEstimator())
estimators.register_estimator(_StalePlanEstimator())


def sketched_linear(x, w, b=None, *, key: Optional[torch.Generator] = None,
                    cfg: Optional[SketchConfig] = None,
                    plan_state: Optional[torch.Tensor] = None, grad_slot=None,
                    probe_slot: Optional[torch.Tensor] = None):
    """``x @ w.T (+ b)`` whose backward is the ``cfg`` estimator.

    ``key`` is the site's ``torch.Generator``; ``cfg=None``, a no-op config or
    no generator give the exact linear (plain autograd). ``plan_state`` is the
    site's plan-carry leaf (previous step's column scores) for the ``onepass``
    and ``stale`` backends: the backward returns the refreshed scores as its
    gradient. ``grad_slot`` is the site's gradient slot under compact
    gradients: the backward puts the kept dW rows there and gives ``w`` no
    gradient (``core/site.py``, ``core/compact_grad.py``). ``probe_slot`` is
    the site's telemetry probe slot: the backward returns the probe vector as
    its gradient (``telemetry/probes.py``).
    """
    from repro_torch.core import site

    return site.sketched_site(cfg, x, w, b, key, plan_state, grad_slot, probe_slot)


# Alias used across the nn substrate.
linear = sketched_linear
