"""Fig. 4 / App. B.1: sketch location study (first vs last vs all layers);
port of ``benchmarks/bench_fig4_location.py``.

    python -m benchmarks.torch.fig4_location [--quick] [--device cuda]

Paper finding: approximating only the last layer degrades accuracy more than
only the first — motivation for straggler-selective application (B.1).
Results go to ``results/torch/fig4_location.json``.
"""
import argparse

from benchmarks.torch.common import card, make_policy, mlp_data, save_result, train_mlp_best_lr


LOCATIONS = ("all", "first", "last")
BUDGETS_QUICK = (0.05, 0.2)
BUDGETS_FULL = (0.05, 0.1, 0.2, 0.5)


def grid(quick=True):
    """The (method, budget, ``make_policy`` keywords) that ``run`` trains."""
    return [("l1", p, dict(location=loc)) for loc in LOCATIONS
            for p in (BUDGETS_QUICK if quick else BUDGETS_FULL)]


def run(quick=True, device="cuda"):
    budgets = BUDGETS_QUICK if quick else BUDGETS_FULL
    data = mlp_data()
    out = dict(card(device), quick=quick)
    for loc in LOCATIONS:
        out[loc] = {}
        for p in budgets:
            pol = make_policy("l1", p, location=loc)
            r = train_mlp_best_lr(pol, data=data, device=device)
            out[loc][str(p)] = r
            print(f"  loc={loc:5s} p={p:.2f} test_acc={r['test_acc']:.4f}")
    save_result("fig4_location", out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(quick=args.quick, device=args.device)
