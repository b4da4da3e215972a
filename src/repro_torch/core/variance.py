"""Variance diagnostics for sketched backprop (Prop. 2.2).

Port of ``repro/core/variance.py``: Monte-Carlo estimates of the
gradient-surrogate variance, and of its decomposition into the *local* term
(distortion injected at node i) and the *propagated* term (upstream variance
pushed through the exact Jacobian). Keys are integer seeds; a gradient tree
is flattened in :func:`~repro_torch.tree.tree_leaves` order (JAX uses
``ravel_pytree``: a sum over all coordinates does not depend on the order).
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from repro_torch import rng
from repro_torch.tree import tree_leaves

__all__ = ["mc_gradient_variance", "chain_variance_decomposition"]


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tree_leaves(tree)])


def mc_gradient_variance(grad_fn: Callable, exact_grad, keys: Iterable[int]) -> dict:
    """E||ĝ - g||² and ||E[ĝ] - g||² (bias check) over Monte-Carlo keys.

    ``grad_fn(key) -> tree`` returns the sketched gradient for one integer
    seed; ``exact_grad`` is the deterministic reference tree. The sums are
    float32 tensors on the gradients' device.
    """
    flat_exact = _flat(exact_grad)
    samples = torch.stack([_flat(grad_fn(k)) for k in keys])
    mean = samples.mean(0)
    return {
        "variance": (samples - flat_exact[None, :]).square().sum(1).mean(),
        "bias_sq": (mean - flat_exact).square().sum(),
        "exact_norm_sq": flat_exact.square().sum(),
        "n_samples": samples.shape[0],
    }


def chain_variance_decomposition(Ws, G_out, sketch_vjp: Callable, keys: Iterable[int]) -> dict:
    """Empirical validation of Prop. 2.2 on a chain of linear nodes.

    Backward chain (row convention): the gradient entering the chain is
    ``G_out``; node k applies ``g_k = g_{k+1} @ W_k``, whose sketched version
    is ``sketch_vjp(k, seed, W_k, g) -> ĝ`` with ``E[ĝ | g] = g @ W_k`` and
    ``seed = fold_in(key, k)``. At every node

        E||ĝ_k − g_k||² = E||Ĵ_k ĝ_{k+1} − J_k ĝ_{k+1}||²   (local)
                        + E||J_k (ĝ_{k+1} − g_{k+1})||²      (propagated)

    since the cross term cancels by conditional unbiasedness. Returns the
    Monte-Carlo means of the three, one float per node, as lists.
    """
    L = len(Ws)
    exact = [None] * (L + 1)
    exact[L] = G_out
    for k in range(L - 1, -1, -1):
        exact[k] = exact[k + 1] @ Ws[k]
    tot, loc, pro = [], [], []
    for key in keys:
        ghat = G_out
        t, lo, pr = [0.0] * L, [0.0] * L, [0.0] * L
        for k in range(L - 1, -1, -1):
            exact_push = ghat @ Ws[k]  # J_k ĝ_{k+1}
            ghat = sketch_vjp(k, rng.fold_in(key, k), Ws[k], ghat)  # ĝ_k = Ĵ_k ĝ_{k+1}
            t[k] = (ghat - exact[k]).square().sum()
            lo[k] = (ghat - exact_push).square().sum()
            pr[k] = (exact_push - exact[k]).square().sum()
        tot.append(torch.stack(t))
        loc.append(torch.stack(lo))
        pro.append(torch.stack(pr))

    def mean(v):
        return [float(x) for x in torch.stack(v).mean(0)]

    return {"total": mean(tot), "local": mean(loc), "propagated": mean(pro)}
