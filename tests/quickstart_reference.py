"""The JAX package's quickstart (``examples/quickstart.py``) over several
seeds: the reference for the accuracy gap of the port's
``benchmarks/torch/quickstart.py``. It runs the example's own ``train`` (the
exact run, then l1 @ 0.2 on every layer) for each seed and prints one JSON
line with each seed's final test accuracies and the gap's mean and standard
deviation. Not a test: pytest does not collect it.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/quickstart_reference.py --seeds 0 1 2
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from examples.quickstart import train  # noqa: E402
from repro.api import Runtime, SketchConfig, SketchPolicy  # noqa: E402
from repro.data.synthetic import classification  # noqa: E402
from repro.models.mlp import mlp_loss  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args()
    xtr, ytr = classification(4096, 784, 10, seed=0)
    xte, yte = classification(1024, 784, 10, seed=1)
    runtimes = {"exact": Runtime(),
                "sketched": Runtime(policy=SketchPolicy(
                    base=SketchConfig(method="l1", budget=0.2), exclude_roles=()))}
    runs = []
    for seed in args.seeds:
        run = {"seed": seed}
        for name, rt in runtimes.items():
            print(f"== seed {seed}: {name} ==")
            params = train(rt, xtr, ytr, xte, yte, epochs=args.epochs, seed=seed)
            run[name] = float(mlp_loss(params, {"x": xte, "y": yte}, rt.ctx(budget=None))[1])
        run["gap"] = run["exact"] - run["sketched"]
        runs.append(run)
    gaps = [r["gap"] for r in runs]
    print(json.dumps({"reference": "examples/quickstart.py (JAX, CPU)", "runs": runs,
                      "gap_mean": float(np.mean(gaps)),
                      "gap_std": float(np.std(gaps, ddof=1)) if len(gaps) > 1 else None}))


if __name__ == "__main__":
    main()
