"""Linear layer with an unbiased sketched backward pass (paper App. C).

Port of ``repro/core/sketched_linear.py``. Forward: ``y = x @ W.T (+ b)`` with
``W: [d_out, d_in]``. The backward replaces the exact VJP by the configured
estimator from the registry (``core/estimators.py``):

* ``mask``    — Alg. 3 / 4 / 5 / 6 verbatim (dense masked matmuls);
* ``compact`` — the r kept columns, reduced-shape matmuls (plain PyTorch);
* ``pallas``  — compact semantics; block-granular configs run the
                hand-written fused backward kernel (dX, compact dW and compact
                db from G's kept blocks) and the score kernel.

The ``onepass`` and ``stale`` plan-carry estimators are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import estimators
from repro_torch.core.estimators import EstimatorVJP
from repro_torch.core.sketching import (COLUMN_METHODS, SketchConfig, column_plan,
                                        effective_cfg, sketch_dense,
                                        static_block_rank, static_rank)

__all__ = ["sketched_linear", "linear", "block_cols"]


def block_cols(idx: torch.Tensor, block: int) -> torch.Tensor:
    """Per-column indices ``[rb*block]`` of the kept column blocks ``idx``."""
    return (idx[:, None] * block
            + torch.arange(block, dtype=idx.dtype, device=idx.device)[None, :]).reshape(-1)


class _MaskEstimator(estimators.Estimator):
    """Paper-faithful dense backend: full-size Ĝ, dense downstream matmuls."""

    name = "mask"
    supports_compact_grad = False

    def apply(self, cfg, G2d, X2d, w, gen, *, has_b):
        if cfg.method == "per_element":
            # Alg. 3: independent element masks on W (for dX) and X (for dW);
            # the bias gradient stays exact.
            p = cfg.budget
            mw = torch.bernoulli(torch.full_like(w, p), generator=gen)
            mx = torch.bernoulli(torch.full_like(X2d, p), generator=gen)
            return EstimatorVJP(dx=(G2d @ (w * mw)) / p,
                                dw=(G2d.T @ (X2d * mx)) / p,
                                db=G2d.sum(0) if has_b else None)
        Ghat = sketch_dense(cfg, G2d, w, gen)
        return EstimatorVJP(dx=Ghat @ w, dw=Ghat.T @ X2d,
                            db=Ghat.sum(0) if has_b else None)


class _CompactEstimator(estimators.Estimator):
    """Exact-r compact backend: gather kept columns, reduced-shape matmuls
    (the fused plain version on block-granular configs)."""

    name = "compact"
    supports_compact_grad = True

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

    def apply(self, cfg, G2d, X2d, w, gen, *, has_b):
        cfg = effective_cfg(cfg, G2d.shape[-1])
        plan = column_plan(cfg, G2d, w, gen, want_compact=True)
        return self.apply_plan(cfg, G2d, X2d, w, plan.indices, plan.scales)

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


estimators.register_estimator(_MaskEstimator())
estimators.register_estimator(_CompactEstimator())
estimators.register_estimator(_PallasEstimator())


def sketched_linear(x, w, b=None, *, key: Optional[torch.Generator] = None,
                    cfg: Optional[SketchConfig] = None):
    """``x @ w.T (+ b)`` whose backward is the ``cfg`` estimator.

    ``key`` is the site's ``torch.Generator``; ``cfg=None``, a no-op config or
    no generator give the exact linear (plain autograd).
    """
    from repro_torch.core import site

    return site.sketched_site(cfg, x, w, b, key)


# Alias used across the nn substrate.
linear = sketched_linear
