"""Variance accounting: Prop. 2.2 decomposition + Eq. (6) trade-off table;
port of ``benchmarks/bench_variance.py``.

    python -m benchmarks.torch.bench_variance [--quick] [--device cuda]

(1) Monte-Carlo gradient variance per method/budget on the paper MLP — the V
    entering σ²+V — with the squared bias of the Monte-Carlo mean beside it;
(2) the cost model ρ(V): sketched-backward FLOPs vs exact, giving the
    paper's net-win condition ρ(V)(σ²+V) ≤ ρ(0)σ².
Results go to ``results/torch/variance_eq6.json``.
"""
import argparse

import torch

from benchmarks.torch.common import card, make_policy, mlp_data, mlp_grads, save_result
from repro_torch import rng
from repro_torch.api import Runtime
from repro_torch.core import variance as varlib
from repro_torch.models.mlp import mlp_init
from repro_torch.tree import tree_map

MC_KEY = 3  # the draws' seeds are rng.fold_in(MC_KEY, i), where JAX splits key(3)


def exact_grads(params, batch, device):
    return mlp_grads(params, batch, Runtime(device=device).ctx())[2]


def mc_stats(params, batch, policy, exact, n_mc, device, record=None):
    """``mc_gradient_variance`` of the MLP's sketched gradient under
    ``policy`` over ``n_mc`` draws (``record``, a list, gets each draw's
    gradient tree)."""
    rt = Runtime(policy=policy, device=device)

    def gfn(k):
        g = tree_map(torch.Tensor.detach, mlp_grads(params, batch, rt.ctx(k))[2])
        if record is not None:
            record.append(g)
        return g

    return varlib.mc_gradient_variance(gfn, exact, [rng.fold_in(MC_KEY, i) for i in range(n_mc)])


METHODS_QUICK = ("per_column", "l1", "ds")
METHODS_FULL = ("per_element", "per_column", "per_sample", "l1", "l2", "var", "ds", "gsv", "rcs")
BUDGETS_QUICK = (0.1, 0.5)
BUDGETS_FULL = (0.05, 0.1, 0.2, 0.5)
N_MC_QUICK, N_MC_FULL = 100, 400


def grid(quick=True):
    """The (method, budget, ``make_policy`` keywords) whose draws ``run``
    takes."""
    return [(m, p, {}) for m in (METHODS_QUICK if quick else METHODS_FULL)
            for p in (BUDGETS_QUICK if quick else BUDGETS_FULL)]


def problem(device):
    """The draws' problem on ``device``: (``mlp_init(0)`` weights, the first
    128 training samples, their exact gradient)."""
    dev = Runtime(device=device).device
    (xtr, ytr), _ = mlp_data()
    batch = {"x": torch.as_tensor(xtr[:128], device=dev),
             "y": torch.as_tensor(ytr[:128], device=dev).long()}
    params = tree_map(lambda t: t.requires_grad_(), mlp_init(0, device=dev))
    return params, batch, exact_grads(params, batch, dev)


def run(quick=True, device="cuda"):
    n_mc = N_MC_QUICK if quick else N_MC_FULL
    params, batch, exact = problem(device)
    dev = batch["x"].device
    out = dict(card(dev), quick=quick, n_mc=n_mc)
    for m, p, kw in grid(quick):
        out.setdefault(m, {})
        stats = mc_stats(params, batch, make_policy(m, p, **kw), exact, n_mc, dev)
        # per-iteration backward cost factor for the MLP under this method
        rho = _rho(m, p)
        V = float(stats["variance"])
        out[m][str(p)] = {
            "V": V, "bias_sq": float(stats["bias_sq"]),
            "exact_norm_sq": float(stats["exact_norm_sq"]), "rho": rho,
        }
        print(f"  {m:11s} p={p:.2f} V={V:9.4f} rho={rho:.3f} "
              f"bias²={float(stats['bias_sq']):.5f}")
    save_result("variance_eq6", out)
    return out


def _rho(method, p):
    """Backward-matmul cost factor vs exact (dX+dW both scale with kept cols
    for column methods; per_element keeps dense shapes -> no dense-FLOP win)."""
    if method in ("per_element",):
        return 1.0  # element sparsity: no dense-matmul reduction
    if method == "per_sample":
        return p  # row-sparse: both dX and dW shrink with kept rows
    return p  # column methods: compact path shrinks dX and dW matmuls by p


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(quick=args.quick, device=args.device)
