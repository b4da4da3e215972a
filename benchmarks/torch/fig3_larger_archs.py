"""Fig. 3: sketching on larger architectures (BagNet-style and ViT); port of
``benchmarks/bench_fig3_larger_archs.py``.

    python -m benchmarks.torch.fig3_larger_archs [--quick] [--device cuda]

Paper finding: limited degradation even at small budgets; Diagonal Sketching
(DS) is consistently strong; data-dependent > uniform masking. Each
architecture trains with exact backprop and then under each method and
budget (the classifier exact), from the same initial weights, on synthetic
32×32×3 class blobs (``data/synthetic.classification``, noise 0.8);
accuracies are evaluated exactly (``runtime.ctx(budget=None)``). ``--quick``
is the JAX benchmark's quick mode (2,048/512 samples, 2 epochs, ViT d 128
depth 4, BagNet width 32); without it, App. B.2's widths (ViT d 192, depth 9,
heads 12, d_ff 1024; BagNet width 64). Results go to
``results/torch/fig3_larger_archs.json``.
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from benchmarks.torch.common import make_policy, save_result
from repro_torch import rng
from repro_torch.api import Runtime
from repro_torch.data.synthetic import classification
from repro_torch.models.vision import bagnet_apply, bagnet_init, cls_loss, vit_apply, vit_init
from repro_torch.optim import adamw, cosine_warmup, sgd
from repro_torch.tree import tree_leaves, tree_map


def _train(apply_fn, init, policy, data, *, epochs, batch, opt, device, seed=0):
    (xtr, ytr), (xte, yte) = data
    runtime = Runtime(policy=policy, device=device)
    params = init()
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    state = opt.init(params)

    def ev(x, y):
        with torch.no_grad():
            return float(cls_loss(apply_fn, params, {"x": x, "y": y},
                                  runtime.ctx(budget=None))[1])

    n = xtr.shape[0]
    spe = n // batch
    i = 0
    for ep in range(epochs):
        perm = torch.as_tensor(np.random.default_rng((seed, ep)).permutation(n),
                               device=runtime.device)
        for t in range(spe):
            idx = perm[t * batch:(t + 1) * batch]
            b = {"x": xtr[idx], "y": ytr[idx]}
            loss, _ = cls_loss(apply_fn, params, b, runtime.ctx(rng.fold_in(seed + 7,
                                                                           ep * spe + t)))
            it = iter(torch.autograd.grad(loss, leaves))
            params, state = opt.update(tree_map(lambda _: next(it), params), state, params, i)
            i += 1
    return {"train_acc": ev(xtr[:1024], ytr[:1024]), "test_acc": ev(xte, yte)}


def run(quick=True, device="cuda"):
    n_tr, n_te = (2048, 512) if quick else (16384, 2048)
    epochs = 2 if quick else 10
    budgets = (0.1, 0.5) if quick else (0.05, 0.1, 0.2, 0.5)
    methods = ["per_column", "l1", "ds"] if quick else [
        "per_element", "per_column", "per_sample", "l1", "ds", "gsv"]
    dev = Runtime(device=device).device

    def tensors(xy):
        return (torch.as_tensor(xy[0], device=dev), torch.as_tensor(xy[1], device=dev).long())

    data = (tensors(classification(n_tr, (32, 32, 3), 10, seed=0, noise=0.8, flatten=False)),
            tensors(classification(n_te, (32, 32, 3), 10, seed=1, noise=0.8, flatten=False)))
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "quick": quick}
    for arch in ("vit", "bagnet"):
        if arch == "vit":
            heads = 8 if quick else 12
            init = functools.partial(vit_init, 0, d=128 if quick else 192,
                                     depth=4 if quick else 9, heads=heads,
                                     d_ff=512 if quick else 1024, device=dev)
            apply_fn = functools.partial(vit_apply, heads=heads)
            opt = adamw(cosine_warmup(3e-4, 20, 400), weight_decay=0.05, clip=1.0)
        else:
            init = functools.partial(bagnet_init, 0, width=32 if quick else 64, device=dev)
            apply_fn = bagnet_apply
            opt = sgd(cosine_warmup(0.03, 10, 400), momentum=0.9, clip=1.0)
        kw = dict(epochs=epochs, batch=64, opt=opt, device=dev)
        t0 = time.perf_counter()
        res = {"exact": {"1.0": _train(apply_fn, init, None, data, **kw)}}
        print(f"[{arch}] exact: {res['exact']['1.0']} ({time.perf_counter() - t0:.1f} s)")
        for m in methods:
            res[m] = {}
            for p in budgets:
                t0 = time.perf_counter()
                r = _train(apply_fn, init, make_policy(m, p, include_head=False), data, **kw)
                res[m][str(p)] = r
                print(f"[{arch}] {m:11s} p={p:.2f} test_acc={r['test_acc']:.4f} "
                      f"({time.perf_counter() - t0:.1f} s)")
        out[arch] = res
    save_result("fig3_larger_archs", out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(quick=args.quick, device=args.device)
