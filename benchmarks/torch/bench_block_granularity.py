"""Per-column vs 128-block-granular sketching; port of
``benchmarks/bench_block_granularity.py``.

    python -m benchmarks.torch.bench_block_granularity [--quick] [--device cuda]

The block variant is the kernels' layout; this benchmark measures the
accuracy cost of the coarser granularity at equal budget, on the ``mask``
backend (no kernel runs). A wider MLP (784-512-512-10) makes 128-blocks
meaningful; the head stays exact. Results go to
``results/torch/block_granularity.json``.
"""
import argparse

from benchmarks.torch.common import card, make_policy, save_result, train_mlp_best_lr
from repro_torch.data.synthetic import classification


SIZES = (784, 512, 512, 10)
GRANULARITIES = (("per_column", 0), ("block128", 128))  # (name, block)
BUDGETS_QUICK = (0.1, 0.25)
BUDGETS_FULL = (0.05, 0.1, 0.2, 0.5)


def grid(quick=True):
    """The (method, budget, ``make_policy`` keywords) that ``run`` trains
    on the ``SIZES`` MLP."""
    return [("l1", p, dict(block=b, include_head=False)) for _, b in GRANULARITIES
            for p in (BUDGETS_QUICK if quick else BUDGETS_FULL)]


def run(quick=True, device="cuda"):
    budgets = BUDGETS_QUICK if quick else BUDGETS_FULL
    xtr, ytr = classification(4096, 784, 10, seed=0)
    xte, yte = classification(1024, 784, 10, seed=1)
    data = ((xtr, ytr), (xte, yte))
    out = dict(card(device), quick=quick)
    for name, block in GRANULARITIES:
        out[name] = {}
        for p in budgets:
            pol = make_policy("l1", p, block=block, include_head=False)
            r = train_mlp_best_lr(pol, data=data, sizes=SIZES, device=device)
            out[name][str(p)] = r
            print(f"  {name:10s} p={p:.2f} test_acc={r['test_acc']:.4f}")
    save_result("block_granularity", out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(quick=args.quick, device=args.device)
