"""The JAX package's §5 figure experiments at their quick grids on the CPU:
the reference for the port's ``benchmarks/torch/`` figure scripts. Each
figure reruns the body of JAX's ``benchmarks/bench_<figure>.py`` ``run``,
on the grid the port's script lists (its constants and ``grid()``),
through JAX's own ``benchmarks.common.sweep`` / ``train_mlp_best_lr`` (and,
for the variance and adaptive figures, ``mc_gradient_variance``, ``_rho``,
``train_mlp_scheduled`` and ``probe_overhead_quickstart``), never ``run``
itself, which writes under ``results/bench/``. It writes one JSON file per
figure under ``--out`` (default ``results/torch/jax_cpu/``). ``v_witness``
holds the port's V against JAX's at fig. 1a's lowest budget over many
draws, on the CPU test's problem. Not a test: pytest does not collect it.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/figures_reference.py [--only fig1b ...]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from benchmarks import bench_adaptive, bench_variance  # noqa: E402
from benchmarks.common import make_policy, mlp_data, sweep, train_mlp_best_lr  # noqa: E402
from benchmarks.torch import bench_block_granularity as tblock  # noqa: E402
from benchmarks.torch import common as tcommon  # noqa: E402
from benchmarks.torch import bench_variance as tvariance  # noqa: E402
from benchmarks.torch import fig1a_correlation as tfig1a  # noqa: E402
from benchmarks.torch import fig1b_mask_vs_sketch as tfig1b  # noqa: E402
from benchmarks.torch import fig2a_proxies as tfig2a  # noqa: E402
from benchmarks.torch import fig2b_spectral as tfig2b  # noqa: E402
from benchmarks.torch import fig4_location as tfig4  # noqa: E402
from repro.api import BudgetSchedule, Runtime, SketchConfig, SketchPolicy  # noqa: E402
from repro.core import variance as varlib  # noqa: E402
from repro.data.synthetic import classification  # noqa: E402
from repro.models.mlp import mlp_init, mlp_loss  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models.mlp import mlp_arch  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def fig1a():
    data = mlp_data()
    out = {}
    for name, exact_r in tfig1a.SAMPLERS:
        out[name] = {str(p): train_mlp_best_lr(make_policy("l1", p, exact_r=exact_r), data=data)
                     for p in tfig1a.BUDGETS_QUICK}
    return out


def fig1b(seed=0):
    return sweep(list(tfig1b.METHODS), tfig1b.BUDGETS_QUICK, train_kw={"seed": seed})


def fig2a():
    return sweep(list(tfig2a.METHODS_QUICK), tfig2a.BUDGETS_QUICK)


def fig2b():
    return sweep(list(tfig2b.METHODS_QUICK), tfig2b.BUDGETS_QUICK)


def fig4():
    data = mlp_data()
    return {loc: {str(p): train_mlp_best_lr(make_policy("l1", p, location=loc), data=data)
                  for p in tfig4.BUDGETS_QUICK} for loc in tfig4.LOCATIONS}


def block():
    data = (classification(4096, 784, 10, seed=0), classification(1024, 784, 10, seed=1))
    return {name: {str(p): train_mlp_best_lr(make_policy("l1", p, block=b, include_head=False),
                                             data=data, sizes=tblock.SIZES)
                   for p in tblock.BUDGETS_QUICK} for name, b in tblock.GRANULARITIES}


def variance():
    (xtr, ytr), _ = mlp_data()
    batch = {"x": xtr[:128], "y": ytr[:128]}
    params = mlp_init(jax.random.key(0))
    exact = jax.grad(lambda p: mlp_loss(p, batch, Runtime().ctx())[0])(params)
    n_mc = tvariance.N_MC_QUICK
    out = {"n_mc": n_mc}
    for m, p, kw in tvariance.grid(quick=True):
        rt = Runtime(policy=make_policy(m, p, **kw))
        gfn = jax.jit(lambda k, rt=rt: jax.grad(
            lambda q: mlp_loss(q, batch, rt.ctx(k))[0])(params))
        stats = varlib.mc_gradient_variance(gfn, exact, jax.random.split(jax.random.key(3), n_mc))
        out.setdefault(m, {})[str(p)] = {
            "V": float(stats["variance"]), "bias_sq": float(stats["bias_sq"]),
            "exact_norm_sq": float(stats["exact_norm_sq"]), "rho": bench_variance._rho(m, p)}
    return out


def adaptive():
    # JAX's run() builds this policy inline (the port's bench_adaptive.POLICY)
    policy = SketchPolicy(base=SketchConfig(method="l1", budget=0.6), exclude_roles=())
    data = mlp_data()
    variants = {"fixed": BudgetSchedule.constant(1.0),
                "warmup_exact": BudgetSchedule.warmup_exact(80, 1.0),
                "adaptive": BudgetSchedule.adaptive(0.8, budgets=(1.0, 0.5, 0.25), window=4)}
    out = {name: bench_adaptive.train_mlp_scheduled(policy, s, steps=320, data=data)
           for name, s in variants.items()}
    for r in out.values():
        r["traces"] = {str(k): v for k, v in r["traces"].items()}
    out["probe_overhead_cpu"] = bench_adaptive.probe_overhead_quickstart()
    return out


def v_witness(n_mc=10_000):
    """l1 at budget 0.05 with either sampler: the mean of ``||ĝ − g||²``
    and its standard error over ``n_mc`` draws, the port's and JAX's, on
    ``tests/test_torch_figures.py``'s problem (MLP 24-16-16-6 from JAX's
    ``mlp_init(key(0))``, 32 samples from numpy seed 11)."""
    sizes, n = (24, 16, 16, 6), 32
    r = np.random.default_rng(11)
    batch = {"x": r.normal(size=(n, sizes[0])).astype(np.float32),
             "y": r.integers(0, sizes[-1], n).astype(np.int32)}
    jp = jax.device_get(mlp_init(jax.random.key(0), sizes))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jflat = ravel_pytree(jax.grad(lambda p: mlp_loss(p, jb, Runtime().ctx())[0])(jp))[0]
    tp = tree_map(lambda t: t.requires_grad_(),
                  interop.params_from_jax(jp, mlp_arch(sizes), device="cpu"))
    tb = {"x": torch.tensor(batch["x"]), "y": torch.tensor(batch["y"]).long()}
    texact = tvariance.exact_grads(tp, tb, "cpu")
    tflat = torch.cat([t.reshape(-1) for t in tree_leaves(texact)])
    out = {"n_mc": n_mc}
    for name, exact_r in tfig1a.SAMPLERS:
        draws = []
        tvariance.mc_stats(tp, tb, tcommon.make_policy("l1", 0.05, exact_r=exact_r), texact, n_mc,
                           "cpu", record=draws)
        t_err = np.array([float((torch.cat([t.reshape(-1) for t in tree_leaves(g)])
                                 - tflat).square().sum()) for g in draws])
        rt = Runtime(policy=make_policy("l1", 0.05, exact_r=exact_r))
        flat = jax.jit(lambda keys, rt=rt: jax.lax.map(lambda k: ravel_pytree(jax.grad(
            lambda q: mlp_loss(q, jb, rt.ctx(k))[0])(jp))[0], keys))
        j_err = np.asarray(jnp.sum(jnp.square(
            flat(jax.random.split(jax.random.key(3), n_mc)) - jflat[None]), axis=1), np.float64)
        out[name] = {pkg: {"V": float(e.mean()), "se": float(e.std() / np.sqrt(n_mc)),
                           "max": float(e.max())} for pkg, e in (("port", t_err), ("jax", j_err))}
        print(f"  {name}: V port {out[name]['port']['V']:.4g} ± {out[name]['port']['se']:.3g}, "
              f"JAX {out[name]['jax']['V']:.4g} ± {out[name]['jax']['se']:.3g}", flush=True)
    return out


FIGURES = {"fig1a_correlation": fig1a, "fig1b_mask_vs_sketch": fig1b,
           "fig1b_mask_vs_sketch.seed1": lambda: fig1b(1),
           "fig1b_mask_vs_sketch.seed2": lambda: fig1b(2), "fig2a_proxies": fig2a,
           "fig2b_spectral": fig2b, "fig4_location": fig4, "block_granularity": block,
           "variance_eq6": variance, "adaptive": adaptive, "v_witness": v_witness}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="+", default=list(FIGURES), choices=list(FIGURES))
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "torch", "jax_cpu"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    for name in args.only:
        t0 = time.perf_counter()
        out = dict(FIGURES[name](), reference=f"JAX {jax.__version__}, CPU, quick grid",
                   seconds=time.perf_counter() - t0)
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(out, f, indent=1, default=float)
        print(f"{name}: {out['seconds']:.1f} s", flush=True)


if __name__ == "__main__":
    main()
