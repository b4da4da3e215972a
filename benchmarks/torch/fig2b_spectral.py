"""Fig. 2b: spectral (RCS, G-SV) vs coordinate-based strategies; port of
``benchmarks/bench_fig2b_spectral.py``.

    python -m benchmarks.torch.fig2b_spectral [--quick] [--device cuda]

Paper finding: spectral methods lead at equal budget (they pay O(n³)/O(Nn²)
per step for it); G-SV beats its square-root counterpart. Both run on the
``mask`` backend; their SVD and eigendecompositions are ``torch.linalg``
calls on the run's device. Results go to ``results/torch/fig2b_spectral.json``.
"""
import argparse

from benchmarks.torch.common import BUDGETS, card, save_result, sweep


METHODS_QUICK = ("l1", "gsv", "rcs")
METHODS_FULL = ("l1", "gsv", "gsv_sq", "rcs", "ds")
BUDGETS_QUICK = (0.1, 0.2)


def grid(quick=True):
    """The (method, budget, ``make_policy`` keywords) that ``run`` trains,
    ``sweep``'s exact baseline first."""
    return [("exact", 1.0, {})] + [(m, p, {}) for m in (METHODS_QUICK if quick else METHODS_FULL)
                                   for p in (BUDGETS_QUICK if quick else BUDGETS)]


def run(quick=True, device="cuda"):
    budgets = BUDGETS_QUICK if quick else BUDGETS
    methods = METHODS_QUICK if quick else METHODS_FULL
    out = dict(card(device), quick=quick)
    out.update(sweep(list(methods), budgets, train_kw={"device": device}))
    save_result("fig2b_spectral", out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(quick=args.quick, device=args.device)
