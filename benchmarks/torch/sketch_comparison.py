"""Compare every sketch method at one budget (mini paper Figs. 1b/2a/2b);
port of ``examples/sketch_comparison.py``.

    python -m benchmarks.torch.sketch_comparison [--budget 0.2] [--epochs 10] [--device cuda]
"""
import argparse

from benchmarks.torch.common import make_policy, mlp_data, train_mlp_best_lr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=float, default=0.2)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    data = mlp_data()
    methods = ["exact", "per_element", "per_column", "per_sample",
               "l1", "l2", "var", "ds", "gsv", "rcs"]
    print(f"budget p = {args.budget}")
    rows = []
    for m in methods:
        r = train_mlp_best_lr(make_policy(m, args.budget), data=data, epochs=args.epochs,
                              device=args.device)
        rows.append((m, r["test_acc"], r["lr"]))
        print(f"  {m:12s} test_acc={r['test_acc']:.4f} (lr={r['lr']})")
    best = max(rows[1:], key=lambda t: t[1])
    print(f"\nbest sketch at p={args.budget}: {best[0]} ({best[1]:.4f}); "
          f"exact reference {rows[0][1]:.4f}")
    return rows


if __name__ == "__main__":
    main()
