"""Fig. 1a: correlated exact-r Bernoulli sampling vs independent gates; port
of ``benchmarks/bench_fig1a_correlation.py``.

    python -m benchmarks.torch.fig1a_correlation [--quick] [--device cuda]

Paper finding: enforcing the fixed-rank (correlated) constraint slightly
improves low-budget accuracy. Method: ℓ1 sketch, both samplers, budget sweep
(the independent gates are ``core.solver.sample_independent``). Results go to
``results/torch/fig1a_correlation.json``.
"""
import argparse

from benchmarks.torch.common import (BUDGETS, card, make_policy, mlp_data, save_result,
                                     train_mlp_best_lr)


BUDGETS_QUICK = (0.05, 0.1, 0.2)
SAMPLERS = (("correlated", True), ("independent", False))  # (name, exact_r)


def grid(quick=True):
    """The (method, budget, ``make_policy`` keywords) that ``run`` trains."""
    return [("l1", p, dict(exact_r=e)) for _, e in SAMPLERS
            for p in (BUDGETS_QUICK if quick else BUDGETS)]


def run(quick=True, device="cuda"):
    budgets = BUDGETS_QUICK if quick else BUDGETS
    data = mlp_data()
    out = dict(card(device), quick=quick)
    for name, exact_r in SAMPLERS:
        out[name] = {}
        for p in budgets:
            pol = make_policy("l1", p, exact_r=exact_r)
            r = train_mlp_best_lr(pol, data=data, device=device)
            out[name][str(p)] = r
            print(f"  {name:12s} p={p:.2f} test_acc={r['test_acc']:.4f}")
    save_result("fig1a_correlation", out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(quick=args.quick, device=args.device)
