"""Optimal sampling probabilities and correlated exact-r sampling.

Port of ``repro/core/solver.py``: the paper's Algorithm 1 (water-filling
solution of ``min_p Σ w_i/p_i  s.t.  Σ p_i <= r, p_i ∈ (0, 1]``) and
Algorithm 2 (systematic sampling of correlated Bernoulli variables with fixed
sum r). Everything stays on the tensor's device with no host synchronisation;
``r`` is a Python int.
"""
from __future__ import annotations

import torch

__all__ = [
    "optimal_probabilities",
    "sample_exact_r",
    "sample_independent",
    "expected_distortion",
]

_F32_TINY = torch.finfo(torch.float32).tiny


def optimal_probabilities(weights: torch.Tensor, r: int, *, eps: float = 1e-12) -> torch.Tensor:
    """Water-filling solution of the paper's convex program (Eq. 23 / Alg. 1).

    ``weights``: non-negative importance weights ``[n]``. Returns ``p`` of
    shape ``[n]`` with ``p_i ∈ (0, 1]`` and ``sum(p) == r`` up to float error.
    ``eps`` is a relative floor that keeps every ``p_i`` strictly positive; an
    all-zero weight vector gives the uniform distribution.
    """
    n = weights.shape[-1]
    if r >= n:
        return torch.ones_like(weights)
    w = weights.to(torch.float32).clamp_min(0.0)
    mean_w = w.mean()
    # Relative floor keeps p_i > 0; if all weights vanish, fall back to uniform.
    w = torch.where(mean_w > 0, w + eps * mean_w, 1.0)

    t = torch.sqrt(w)
    t_sorted = torch.sort(t, descending=True).values
    # suffix[k] = sum_{i >= k} t_sorted[i]
    suffix = torch.flip(torch.cumsum(torch.flip(t_sorted, (0,)), 0), (0,))
    k = torch.arange(n, dtype=torch.float32, device=w.device)
    denom = float(r) - k  # remaining budget if k entries saturate at 1
    valid_budget = denom > 0
    sqrt_lam_k = torch.where(valid_budget, suffix / denom.clamp_min(1.0), float("inf"))
    # k is feasible iff t_(k-1) >= sqrt(lam_k) >= t_(k).
    t_prev = torch.nn.functional.pad(t_sorted[:-1], (1, 0), value=float("inf"))
    feasible = valid_budget & (t_prev >= sqrt_lam_k) & (t_sorted <= sqrt_lam_k)
    # The smallest feasible k is the water-filling threshold (argmax returns
    # the first maximum). gather, not indexing: a 0-dim index tensor would
    # be read back to the host.
    k_star = torch.argmax(feasible.to(torch.uint8), dim=0, keepdim=True)
    sqrt_lam = torch.where(feasible.any(), sqrt_lam_k.gather(0, k_star)[0], t_sorted[r - 1])
    p = torch.clamp(t / sqrt_lam.clamp_min(eps), max=1.0)
    # Exact renormalisation to sum(p) == r by 8 rounds of fixed-point
    # water-fill: rescale the unsaturated part, clip, repeat. A one-shot
    # rescale would leave sum(p) < r and warp the sampler's marginals.
    for _ in range(8):
        sat = p >= 1.0 - 1e-7
        rest = torch.where(sat, 0.0, p).sum()
        scale = torch.where(rest > 0, (r - sat.sum()) / rest.clamp_min(eps), 1.0)
        p = torch.where(sat, 1.0, torch.clamp(p * scale, max=1.0))
    return p


def sample_exact_r(gen: torch.Generator, p: torch.Tensor, r: int) -> torch.Tensor:
    """Correlated Bernoulli sampling with sum == r (paper Alg. 2).

    Systematic sampling: marginals are exactly ``p_i`` and exactly ``r``
    distinct indices come back (requires ``p_i <= 1`` and ``sum p = r``).
    ``u`` is drawn from the site's generator ``gen``. Returns ascending int64
    indices of shape ``[r]``.
    """
    n = p.shape[-1]
    cum = torch.cumsum(p.to(torch.float32), 0)
    cum[-1] = float(r)  # numerical safety (Alg. 2 line 3)
    u = torch.rand((), generator=gen, device=p.device).clamp_min(_F32_TINY)
    targets = u + torch.arange(r, dtype=torch.float32, device=p.device)
    idx = torch.searchsorted(cum, targets, side="left")
    return idx.clamp(0, n - 1)


def sample_independent(gen: torch.Generator, p: torch.Tensor) -> torch.Tensor:
    """Independent Bernoulli gates ``z_i ~ B(p_i)`` as a float 0/1 mask."""
    return torch.bernoulli(p.to(torch.float32), generator=gen)


def expected_distortion(weights: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """E-distortion ``Σ_i w_i (1/p_i - 1)`` of a mask-and-rescale sketch."""
    safe_p = p.clamp_min(1e-20)
    return torch.where(weights > 0, weights * (1.0 / safe_p - 1.0),
                       torch.zeros_like(weights)).sum()
