"""Fig. 1b: uniform masking baselines vs data-dependent sketching; port of
``benchmarks/bench_fig1b_mask_vs_sketch.py``.

    python -m benchmarks.torch.fig1b_mask_vs_sketch [--quick] [--device cuda] [--seed 0]

Paper finding: data-dependent sketches (ℓ1 / DS) consistently beat the three
agnostic masks (per-element / per-column / per-sample) at equal budget.
``--seed`` draws the data from another seed (``sweep``'s rule, as in JAX);
seed 0 writes ``results/torch/fig1b_mask_vs_sketch.json``, seed s
``fig1b_mask_vs_sketch.seed<s>.json``.
"""
import argparse

from benchmarks.torch.common import BUDGETS, card, save_result, sweep


METHODS = ("per_element", "per_column", "per_sample", "l1", "ds")
BUDGETS_QUICK = (0.05, 0.1, 0.2)


def grid(quick=True):
    """The (method, budget, ``make_policy`` keywords) that ``run`` trains,
    ``sweep``'s exact baseline first."""
    return [("exact", 1.0, {})] + [(m, p, {}) for m in METHODS
                                   for p in (BUDGETS_QUICK if quick else BUDGETS)]


def run(quick=True, device="cuda", seed=0):
    budgets = BUDGETS_QUICK if quick else BUDGETS
    out = dict(card(device), quick=quick, seed=seed)
    out.update(sweep(list(METHODS), budgets, train_kw={"seed": seed, "device": device}))
    save_result("fig1b_mask_vs_sketch" + (f".seed{seed}" if seed else ""), out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    run(quick=args.quick, device=args.device, seed=args.seed)
