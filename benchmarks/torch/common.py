"""Shared harness of the port's benchmarks (port of ``benchmarks/common.py``):
train the paper's §5 MLP on synthetic data under a sketch policy and report
accuracy against budget (the paper's x and y axes), and write the results
under ``results/torch/``.

Everything runs on the card unless the caller passes ``device="cpu"``;
without a card the default raises (``repro_torch.device.resolve_device``).
The MLP's sites sketch on the policy's backend, by default ``mask``, as in
JAX: no hand-written kernel runs on these paths.
"""
from __future__ import annotations

import json
import os
import subprocess

import numpy as np
import torch

from repro_torch import rng
from repro_torch.api import Runtime, SketchConfig, SketchPolicy
from repro_torch.data.synthetic import classification
from repro_torch.device import resolve_device
from repro_torch.models.mlp import mlp_init, mlp_loss
from repro_torch.tree import tree_leaves, tree_map

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "results", "torch")

BUDGETS = (0.05, 0.1, 0.2, 0.5)


def save_result(name: str, payload: dict) -> str:
    """Write ``payload`` to ``results/torch/<name>.json``; returns the path."""
    os.makedirs(RESULTS, exist_ok=True)
    path = os.path.join(RESULTS, name + ".json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return path


def card(device) -> dict:
    """The device a result was measured on: its name and, on a card,
    ``nvidia-smi``'s name and power limit (raises without a card unless
    ``device`` is the CPU)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"device": "cpu", "smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(dev), "smi": smi}


def mlp_data(n_train=4096, n_test=1024, seed=0):
    xtr, ytr = classification(n_train, 784, 10, seed=seed, noise=1.0)
    xte, yte = classification(n_test, 784, 10, seed=seed + 1, noise=1.0)
    return (xtr, ytr), (xte, yte)


def make_policy(method: str, budget: float, *, exact_r=True, block=0,
                location="all", include_head=True) -> SketchPolicy | None:
    """``method`` at ``budget`` (``"exact"``: None); the paper's §5 MLP
    experiments sketch every layer, the 10-way head included, unless
    ``include_head=False``."""
    if method == "exact":
        return None
    cfg = SketchConfig(method=method, budget=budget, exact_r=exact_r, block=block)
    excl = () if include_head else ("lm_head",)
    return SketchPolicy(base=cfg, exclude_roles=excl, location=location)


def mlp_grads(params, batch, ctx):
    """(loss, accuracy, gradient tree shaped like ``params``); the leaves of
    ``params`` must require grad."""
    loss, acc = mlp_loss(params, batch, ctx)
    it = iter(torch.autograd.grad(loss, tree_leaves(params)))
    return loss, acc, tree_map(lambda _: next(it), params)


def clipped_sgd(params, grads, lr, clip):
    """``params - lr * min(1, clip / ||grads||) * grads`` (global norm), new
    leaves that require grad; no host read."""
    with torch.no_grad():
        gn = torch.sqrt(sum(g.square().sum() for g in tree_leaves(grads)))
        scale = lr * torch.clamp(clip / torch.clamp(gn, min=1e-12), max=1.0)
        return tree_map(lambda w, g: (w - scale * g).requires_grad_(), params, grads)


def train_mlp(policy, *, lr=0.2, epochs=10, batch=128, seed=0, clip=1.0,
              data=None, sizes=(784, 64, 64, 10), params=None, device="cuda"):
    """Paper §5 setting: SGD, no momentum or schedule, clip 1.0, CE loss.

    ``params`` (optional) are the initial weights, copied; by default
    ``mlp_init(seed, sizes)``. The step seed of step ``t`` is
    ``rng.fold_in(seed + 100, t)``, where JAX folds ``key(seed + 100)``."""
    dev = resolve_device(device)
    (xtr, ytr), (xte, yte) = data if data is not None else mlp_data(seed=seed)
    xtr, xte = (torch.as_tensor(x, device=dev) for x in (xtr, xte))
    ytr, yte = (torch.as_tensor(y, device=dev).long() for y in (ytr, yte))
    if params is None:
        params = mlp_init(seed, sizes, device=dev)
    params = tree_map(lambda t: t.detach().to(dev).clone().requires_grad_(), params)
    runtime = Runtime(policy=policy, device=dev)

    def evaluate(x, y):
        with torch.no_grad():
            return float(mlp_loss(params, {"x": x, "y": y}, runtime.ctx(budget=None))[1])

    n = xtr.shape[0]
    steps_per_epoch = n // batch
    for ep in range(epochs):
        perm = torch.as_tensor(np.random.default_rng((seed, ep)).permutation(n), device=dev)
        for i in range(steps_per_epoch):
            idx = perm[i * batch:(i + 1) * batch]
            key = rng.fold_in(seed + 100, ep * steps_per_epoch + i)
            _, _, g = mlp_grads(params, {"x": xtr[idx], "y": ytr[idx]}, runtime.ctx(key))
            params = clipped_sgd(params, g, lr, clip)
    return {
        "train_acc": evaluate(xtr[:2048], ytr[:2048]),
        "test_acc": evaluate(xte, yte),
    }


def train_mlp_best_lr(policy, *, lrs=(0.4, 0.2, 0.1), **kw):
    """Mini LR cross-validation (paper cross-validates per method/budget)."""
    best = None
    for lr in lrs:
        r = train_mlp(policy, lr=lr, **kw)
        if best is None or r["test_acc"] > best["test_acc"]:
            best = dict(r, lr=lr)
    return best


def sweep(methods, budgets=BUDGETS, *, policy_kw=None, train_kw=None, baseline=True):
    """Run (method × budget) MLP sweeps; returns nested dict. As in JAX,
    ``train_kw["seed"]`` seeds the data only (the training runs keep their
    default seed 0); ``train_kw["device"]`` picks the device."""
    policy_kw = policy_kw or {}
    train_kw = dict(train_kw or {})
    data = mlp_data(seed=train_kw.pop("seed", 0))
    out = {}
    if baseline:
        out["exact"] = {"1.0": train_mlp_best_lr(None, data=data, **train_kw)}
        print(f"  exact       p=1.00  test_acc={out['exact']['1.0']['test_acc']:.4f}")
    for m in methods:
        out[m] = {}
        for p in budgets:
            pol = make_policy(m, p, **policy_kw)
            r = train_mlp_best_lr(pol, data=data, **train_kw)
            out[m][str(p)] = r
            print(f"  {m:11s} p={p:.2f}  test_acc={r['test_acc']:.4f} (lr={r['lr']})")
    return out
