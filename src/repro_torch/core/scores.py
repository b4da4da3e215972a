"""Importance scores (weight proxies) for data-dependent sketches (paper §4.2).

Port of ``repro/core/scores.py``. Every score maps the batch gradient matrix
``G`` ([N, d_out], rows are flattened samples) to a non-negative proxy ``s``
of shape ``[d_out]``; sampling probabilities are ``p ∝ s``. The ``_sq``
variants use ``s²``. Scores accumulate in fp32 regardless of input dtype.
"""
from __future__ import annotations

import torch

__all__ = ["column_scores", "SCORE_METHODS", "kernel_reduction_mode",
           "scores_from_kernel_reduction"]


def _f32(x):
    return x.to(torch.float32)


def _l1(G, W):
    # Alg. 6: s_j = ||G[:, j]||_1 (the paper's default proxy).
    return _f32(G).abs().sum(0)


def _l2(G, W):
    return torch.sqrt(_f32(G).square().sum(0))


def _var(G, W):
    return torch.var(_f32(G), dim=0, unbiased=False)


def _ds(G, W):
    # Lemma 3.4 "Diagonal Sketches": a_i = (Γ_B)_ii ||W[i, :]||², s = sqrt(a).
    if W is None:
        raise ValueError("DS score requires the layer weight W.")
    gamma_diag = _f32(G).square().mean(0)
    w_row_sq = _f32(W).square().sum(-1)
    return torch.sqrt(gamma_diag * w_row_sq)


def _gsv(G, W):
    # "G-SV": spectrally weighted right-singular leverage s_i = Σ_k σ_k v_{k,i}².
    Gf = _f32(G)
    evals, evecs = torch.linalg.eigh(Gf.T @ Gf)
    sing = torch.sqrt(evals.clamp_min(0.0))
    return evecs.square() @ sing


_BASE = {
    "l1": _l1,
    "l2": _l2,
    "var": _var,
    "ds": _ds,
    "gsv": _gsv,
}

SCORE_METHODS = tuple(_BASE.keys()) + tuple(f"{k}_sq" for k in _BASE)


def column_scores(method: str, G: torch.Tensor, W: torch.Tensor | None = None) -> torch.Tensor:
    """Proxy scores ``s`` ([d_out]); ``method`` may carry the ``_sq`` suffix."""
    squared = method.endswith("_sq")
    base = method[:-3] if squared else method
    if base not in _BASE:
        raise ValueError(f"unknown score method {method!r}; choose from {SCORE_METHODS}")
    s = _BASE[base](G, W)
    return s.square() if squared else s


def kernel_reduction_mode(method: str) -> str | None:
    """The column reduction underlying ``method``: ``"l1"`` (Σ|G|), ``"l2"``
    (ΣG²), or None when one column reduction cannot give the score."""
    base = method[:-3] if method.endswith("_sq") else method
    return base if base in ("l1", "l2") else None


def scores_from_kernel_reduction(method: str, red: torch.Tensor) -> torch.Tensor:
    """Map a raw column reduction (Σ|G| for "l1", ΣG² for "l2") to
    :func:`column_scores` semantics for ``method``, ``_sq`` variants included."""
    base = kernel_reduction_mode(method)
    if base is None:
        raise ValueError(f"method {method!r} has no kernel column reduction")
    s = red if base == "l1" else torch.sqrt(red)
    return s.square() if method.endswith("_sq") else s
