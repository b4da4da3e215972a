"""Quickstart (port of ``examples/quickstart.py``): train the paper's §5 MLP
with unbiased sketched backprop.

    python -m benchmarks.torch.quickstart [--budget 0.2] [--epochs 10] \
        [--seeds 0 1 2] [--device cuda]

The paper's §5 setting on a synthetic MNIST-like task: 4,096 training and
1,024 test samples of ``data/synthetic.classification`` (784 features, 10
classes), the 784-64-64-10 MLP, batch 128, SGD at a constant lr 0.2 with
global-norm clipping at 1.0, cross-entropy, 10 epochs. Each seed trains
twice from the same initial weights: with exact backprop, and sketched (l1
at the budget on every layer, the 10-way head included:
``exclude_roles=()``). Both go through ``Runtime.train`` on an ``mlp_arch``
config; test accuracy is evaluated after every epoch with exact backprop's
context, ``runtime.ctx(budget=None)``. The sketch takes the ``pallas``
backend: on the card the score kernel runs at every site, and every width is
below one 128-column block, so the sketch is per column. The results go to ``results/torch/quickstart.json``, and the
last line printed is their JSON.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from benchmarks.torch.common import save_result
from repro_torch.api import Runtime, SketchConfig, SketchPolicy
from repro_torch.data.synthetic import classification
from repro_torch.models.mlp import mlp_arch, mlp_loss
from repro_torch.optim import constant, sgd
from repro_torch.train.trainer import TrainerConfig


def quickstart_data():
    return classification(4096, 784, 10, seed=0), classification(1024, 784, 10, seed=1)


def sketched_policy(budget: float) -> SketchPolicy:
    return SketchPolicy(base=SketchConfig(method="l1", budget=budget, backend="pallas"),
                        exclude_roles=())


def train(runtime: Runtime, data, *, lr=0.2, epochs=10, batch=128, seed=0) -> dict:
    """Train the MLP under ``runtime``; returns the test accuracy after each
    epoch, the last step's loss and the training time."""
    (xtr, ytr), (xte, yte) = data
    cfg = mlp_arch()
    opt = sgd(constant(lr), clip=1.0)
    test = {"x": torch.as_tensor(xte, device=runtime.device),
            "y": torch.as_tensor(yte, device=runtime.device).long()}
    n = xtr.shape[0]
    spe = n // batch
    state, accs, loss, train_s = None, [], None, 0.0
    for ep in range(epochs):
        perm = np.random.default_rng((seed, ep)).permutation(n)
        batches = [{"x": xtr[idx], "y": ytr[idx]}
                   for idx in (perm[i * batch:(i + 1) * batch] for i in range(spe))]
        t0 = time.perf_counter()
        state, hist = runtime.train(
            cfg, opt, batches, TrainerConfig(steps=(ep + 1) * spe, log_every=spe, seed=seed),
            state=state, on_metrics=lambda m: None)
        train_s += time.perf_counter() - t0
        loss = hist[-1]["loss"]
        # evaluate exactly, whatever the training-time estimator
        with torch.no_grad():
            accs.append(float(mlp_loss(state.params, test, runtime.ctx(budget=None))[1]))
        print(f"  epoch {ep:2d} loss {loss:.4f} test_acc {accs[-1]:.4f}")
    return {"test_acc": accs[-1], "test_acc_per_epoch": accs, "final_loss": loss,
            "train_s": train_s, "steps": epochs * spe}


def run(seed=0, *, budget=0.2, epochs=10, device="cuda") -> dict:
    """The exact and the sketched run of one seed."""
    data = quickstart_data()
    print(f"== seed {seed}: exact backprop ==")
    exact = train(Runtime(device=device), data, epochs=epochs, seed=seed)
    print(f"== seed {seed}: sketched backprop: l1 @ budget {budget} "
          f"(backward cost ≈ {budget:.0%} of exact) ==")
    sketched = train(Runtime(policy=sketched_policy(budget), device=device), data,
                     epochs=epochs, seed=seed)
    return {"seed": seed, "exact": exact, "sketched": sketched,
            "gap": exact["test_acc"] - sketched["test_acc"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=float, default=0.2)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    runs = [run(s, budget=args.budget, epochs=args.epochs,
                device=args.device) for s in args.seeds]
    dev = Runtime(device=args.device).device
    gaps = [r["gap"] for r in runs]
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "method": "l1", "budget": args.budget, "epochs": args.epochs,
           "runs": runs, "gap_mean": float(np.mean(gaps)),
           "gap_std": float(np.std(gaps, ddof=1)) if len(gaps) > 1 else None}
    save_result("quickstart", out)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
