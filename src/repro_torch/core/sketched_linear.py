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

from repro_torch.core import estimators
from repro_torch.core.estimators import EstimatorVJP
from repro_torch.core.scores import kernel_reduction_mode, scores_from_kernel_reduction
from repro_torch.core.sketching import (COLUMN_METHODS, SketchConfig, column_plan,
                                        column_plan_from_scores, effective_cfg,
                                        sketch_dense, static_block_rank, static_rank)

__all__ = ["sketched_linear", "linear", "block_cols"]


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


def _no_shared_plan(cfg, score_psum_axes) -> None:
    """Raise for a method whose draws follow the local batch's shape
    (per-element masks, per-sample gates, rcs) on a data axis of several
    ranks: its plan cannot be the one of the whole batch."""
    if (score_psum_axes is not None and score_psum_axes.size > 1
            and cfg.method not in COLUMN_METHODS and not cfg.is_noop):
        raise NotImplementedError(
            f"method {cfg.method!r} on a data-sharded mesh is not ported (ROADMAP.md, "
            "Queue 1 item 2b): only the column-family methods share one plan "
            "across data replicas")


class _MaskEstimator(estimators.Estimator):
    """Paper-faithful dense backend: full-size Ĝ, dense downstream matmuls."""

    name = "mask"
    supports_compact_grad = False

    def apply(self, cfg, G2d, X2d, w, gen, *, has_b, score_psum_axes=None):
        _no_shared_plan(cfg, score_psum_axes)
        if cfg.method == "per_element":
            # Alg. 3: independent element masks on W (for dX) and X (for dW);
            # the bias gradient stays exact.
            p = cfg.budget
            mw = torch.bernoulli(torch.full_like(w, p), generator=gen)
            mx = torch.bernoulli(torch.full_like(X2d, p), generator=gen)
            return EstimatorVJP(dx=(G2d @ (w * mw)) / p,
                                dw=(G2d.T @ (X2d * mx)) / p,
                                db=G2d.sum(0) if has_b else None)
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
        Ghat = G2d * plan.gate[None, :].to(G2d.dtype)
        dw = Ghat.T @ X2d
        return EstimatorVJP(dx=Ghat @ w, dw=dw, db=Ghat.sum(0) if has_b else None,
                            probe=probe_from_rows(dw, plan.probs), probe_p=plan.probs)


class _CompactEstimator(estimators.Estimator):
    """Exact-r compact backend: gather kept columns, reduced-shape matmuls
    (the fused plain version on block-granular configs)."""

    name = "compact"
    supports_compact_grad = True
    tp_shardable = True  # plan() is valid on a model shard of G

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
        cfg = effective_cfg(cfg, G2d.shape[-1])
        plan = column_plan(cfg, G2d, w, gen, want_compact=True,
                           score_psum_axes=score_psum_axes)
        return self.apply_plan(cfg, G2d, X2d, w, plan.indices, plan.scales), plan

    def apply(self, cfg, G2d, X2d, w, gen, *, has_b, score_psum_axes=None):
        return self._apply_planned(cfg, G2d, X2d, w, gen, score_psum_axes)[0]

    def apply_with_probe(self, cfg, G2d, X2d, w, gen, *, has_b, score_psum_axes=None):
        """The compact rows (the fused kernel's dWc on block-granular
        configs) and the plan's marginals at the kept columns are all the
        probe needs: one ``[r]`` reduction after the same backward."""
        return with_probe(*self._apply_planned(cfg, G2d, X2d, w, gen, score_psum_axes))

    def apply_plan(self, cfg, G2d, X2d, w, indices, scales) -> EstimatorVJP:
        """The backward for a given plan (kept indices and ``1/p`` scales;
        block ids when ``cfg`` is block-granular on this width)."""
        cfg = effective_cfg(cfg, G2d.shape[-1])
        if cfg.block > 1:
            # fused backward: dX, compact dW rows and compact db from G's
            # kept column blocks
            dX2d, dWc, db_blk = self._fused(cfg, G2d, indices, scales, w, X2d)
            return EstimatorVJP(dx=dX2d, rows=dWc.reshape(-1, w.shape[1]),
                                cols=block_cols(indices, cfg.block),
                                db_c=db_blk.reshape(-1))
        return self._per_column(G2d, indices, scales, w, X2d)

    def _fused(self, cfg, G2d, idx, scales, w, X2d):
        from repro_torch.kernels import ref as kref

        return kref.block_gather_matmul_fused_ref(G2d, idx, scales, w, X2d,
                                                  block=cfg.block)

    def _per_column(self, G2d, idx, scales, w, X2d):
        # one gather of G shared by dX, dW and db
        Gc = G2d[:, idx] * scales[None, :].to(G2d.dtype)
        Wc = w[idx]
        return EstimatorVJP(dx=Gc @ Wc, rows=Gc.T @ X2d, cols=idx,
                            db_c=Gc.sum(0))


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

        dX2d = kops.gather_cols_matmul(G2d, idx, scales, w)
        rows = kops.gather_cols_matmul_dw(G2d, idx, scales, X2d)
        db_c = (G2d[:, idx] * scales[None, :].to(G2d.dtype)).sum(0)
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
        scores (the carry is replicated: every replica samples alike)."""
        n = G2d.shape[-1]
        cfg = effective_cfg(cfg, n)
        if state is None:
            state = torch.ones(n, dtype=torch.float32, device=G2d.device)  # uniform prior
        plan = column_plan_from_scores(cfg, state, gen, want_compact=True)
        psum = _same if score_psum_axes is None else score_psum_axes.psum
        out = self._one_pass(cfg, G2d, plan, w, X2d, state, psum)
        # the probe reads the one sweep's rows: no second kernel launch
        return with_probe(out, plan) if want_probe else out

    def _one_pass(self, cfg, G2d, plan, w, X2d, state, psum=_same) -> EstimatorVJP:
        raise NotImplementedError


class _OnePassEstimator(_PlanCarryEstimator):
    """Streaming selection: ALL of G goes through the backward kernel once;
    the kept blocks (the plan sampled from the carried scores) give dX,
    compact dW and db, and EVERY column's fresh score comes from the same
    launch: a full score refresh per step."""

    name = "onepass"

    def _one_pass(self, cfg, G2d, plan, w, X2d, state, psum=_same):
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import ref as kref

        mode = kernel_reduction_mode(cfg.method)
        idx, scales = plan.indices, plan.scales
        if cfg.block > 1:
            dX2d, dWc, db_blk, red = kops.block_stream_matmul_fused(
                G2d, idx, scales, w, X2d, block=cfg.block, score_mode=mode)
            rows, cols, db_c = (dWc.reshape(-1, w.shape[1]), block_cols(idx, cfg.block),
                                db_blk.reshape(-1))
        else:
            # arbitrary column gathers have no kernel in either package
            dX2d, rows, db_c, red = kref.gather_cols_onepass_ref(G2d, idx, scales, w, X2d,
                                                                 score_mode=mode)
            cols = idx
        return EstimatorVJP(dx=dX2d, rows=rows, cols=cols, db_c=db_c,
                            state=scores_from_kernel_reduction(cfg.method, psum(red)))


class _StalePlanEstimator(_PlanCarryEstimator):
    """Stale plan: the kept-only fused backward (the ``pallas`` backend's G
    traffic: dropped blocks are never read), with the kept columns' raw
    scores reduced in the same launch. The refresh is PARTIAL: unkept columns
    keep their carried score until they are sampled."""

    name = "stale"

    def _one_pass(self, cfg, G2d, plan, w, X2d, state, psum=_same):
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import ref as kref

        mode = kernel_reduction_mode(cfg.method)
        idx, scales = plan.indices, plan.scales
        if cfg.block > 1:
            dX2d, dWc, db_blk, kept = kops.block_gather_matmul_fused(
                G2d, idx, scales, w, X2d, block=cfg.block, with_scores=True,
                score_mode=mode)
            rows, cols, db_c = (dWc.reshape(-1, w.shape[1]), block_cols(idx, cfg.block),
                                db_blk.reshape(-1))
            kept = kept.reshape(-1)
        else:
            dX2d, rows, db_c, kept = kref.gather_cols_fused_scores_ref(
                G2d, idx, scales, w, X2d, score_mode=mode)
            cols = idx
        # out of place: the carry passed in stays as it was
        fresh = state.detach().to(torch.float32, copy=True)
        fresh[cols] = scores_from_kernel_reduction(cfg.method, psum(kept))
        return EstimatorVJP(dx=dX2d, rows=rows, cols=cols, db_c=db_c, state=fresh)


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
