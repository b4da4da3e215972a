"""Fig. 2a: weight-proxy comparison (ℓ1 / ℓ2 / Var and squared variants);
port of ``benchmarks/bench_fig2a_proxies.py``.

    python -m benchmarks.torch.fig2a_proxies [--quick] [--device cuda]

Paper finding: all proxies land close; ℓ1 sits on the upper envelope and is
adopted as the default. Results go to ``results/torch/fig2a_proxies.json``.
"""
import argparse

from benchmarks.torch.common import BUDGETS, card, save_result, sweep


METHODS_QUICK = ("l1", "l2", "var")
METHODS_FULL = METHODS_QUICK + ("l1_sq", "l2_sq", "var_sq")
BUDGETS_QUICK = (0.05, 0.1, 0.2)


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
    save_result("fig2a_proxies", out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(quick=args.quick, device=args.device)
