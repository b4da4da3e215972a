"""The port's §5 figure harness (``benchmarks/torch/``) against JAX's
(``benchmarks/``), on the CPU at small sizes, one intra-op thread.

* every policy the eight figures build resolves, site by site on the MLP's
  three layers, to JAX's ``SketchConfig`` (or exact) at every field;
* exact ``train_mlp`` from JAX's initial weights: train and test accuracy
  within one sample of JAX's ``train_mlp`` on the same data;
* unbiasedness and V, per method at budget 0.5 (and l1 with either sampler
  at 0.05, where few inclusion probabilities are clipped) on one batch and
  JAX's weights, ``N_MC`` draws each. Under ``E[ĝ] = g``,
  ``n·||mean − g||² / V`` is a weighted sum of χ²₁ variables with weights
  summing to 1 (the sample mean is close to Gaussian), whose tail beyond
  t ≥ 1.54 is at most χ²₁'s (Székely and Bakirov, 2003): so
  ``bias_sq ≤ CHI2_1_TAIL · V / n`` fails with probability below 1e-4. At
  n = 100 the bound rejects an estimator only where its squared bias
  passes 15% of its V: the exact gradient times 1.05 (no variance, so
  ``bias_sq = V``) is rejected, but a 5% bias in a sketched estimator,
  whose V is many times ``||g||²``, is not. A real fault is: the mask
  sketch without its 1/p rescale (``column_gate`` patched to the 0/1
  draws) gives ``bias_sq`` about 5x the bound at budget 0.5. The port's V
  and JAX's estimate the same mean from independent draws: they must agree
  within ``V_SIGMAS`` standard errors of their difference, each error
  taken as the port's (the standard deviation of its per-draw
  ``||ĝ − g||²`` over √n);
* ``_rho`` and ``_mlp_bwd_flops`` equal JAX's for every method, budget and
  bucket;
* ``bench_adaptive.run(tiny=True)``: one build per bucket of each schedule,
  adaptive backward FLOPs ≤ fixed, the budget history within the buckets;
* every new module imports, and refuses to run without a card unless asked
  for the CPU.
"""
import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_adaptive as jadaptive
from benchmarks import bench_variance as jvariance
from benchmarks import common as jcommon
from benchmarks.torch import bench_adaptive as tadaptive
from benchmarks.torch import bench_block_granularity as tblock
from benchmarks.torch import bench_variance as tvariance
from benchmarks.torch import common as tcommon
from benchmarks.torch import fig1a_correlation as tfig1a
from benchmarks.torch import fig1b_mask_vs_sketch as tfig1b
from benchmarks.torch import fig2a_proxies as tfig2a
from benchmarks.torch import fig2b_spectral as tfig2b
from benchmarks.torch import fig4_location as tfig4
from repro.api import Runtime as JRuntime
from repro.core import variance as jvarlib
from repro.models import mlp as jmlp
from repro_torch import interop
from repro_torch.core.variance import mc_gradient_variance
from repro_torch.models.mlp import mlp_arch
from repro_torch.tree import tree_leaves, tree_map

MODULES = ("common", "fig1a_correlation", "fig1b_mask_vs_sketch", "fig2a_proxies",
           "fig2b_spectral", "fig4_location", "bench_block_granularity", "bench_variance",
           "bench_adaptive", "sketch_comparison")

# every (method, budget, make_policy keywords) of the eight figures, as each
# script's grid() lists them, quick and full; None: the adaptive figure's
# own policy (bench_adaptive.POLICY)
FIGURES = {"fig1a": tfig1a, "fig1b": tfig1b, "fig2a": tfig2a, "fig2b": tfig2b, "fig4": tfig4,
           "block_granularity": tblock, "variance": tvariance}
FIGURE_POLICIES = {name: mod.grid(quick=True) + mod.grid(quick=False)
                   for name, mod in FIGURES.items()}
FIGURE_POLICIES["adaptive"] = [None]
BUDGETS = (0.05, 0.1, 0.2, 0.25, 0.5)

SIZES = (24, 16, 16, 6)
BATCH = 32
N_MC = tvariance.N_MC_QUICK
CHI2_1_TAIL = 15.137  # P(χ²₁ > 15.137) = 1e-4
V_SIGMAS = 4.0
MC_BUDGET = 0.5
MC_METHODS = [("per_column", True), ("l1", True), ("l1", False), ("ds", True),
              ("per_element", True), ("per_sample", True), ("gsv", True), ("rcs", True)]
LOW_BUDGET = 0.05  # fig1a's lowest, where few inclusion probabilities are clipped


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the MLP's ops are tiny, and a full thread pool
    per test process oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adaptive_policies():
    """bench_adaptive's policy in each package: JAX's run() builds l1@0.6 on
    every layer inline; the port's is ``POLICY``."""
    return (jcommon.SketchPolicy(base=jcommon.SketchConfig(method="l1", budget=0.6),
                                 exclude_roles=()), tadaptive.POLICY)


def _fields(cfg):
    return None if cfg is None else dataclasses.asdict(cfg)


@pytest.mark.parametrize("figure", sorted(FIGURE_POLICIES))
def test_make_policy_is_jax_site_by_site(figure):
    n = 0
    for entry in FIGURE_POLICIES[figure]:
        if entry is None:
            jp, tp = _adaptive_policies()
        else:
            m, p, kw = entry
            jp, tp = jcommon.make_policy(m, p, **kw), tcommon.make_policy(m, p, **kw)
        assert (jp is None) == (tp is None)
        if jp is None:
            continue
        assert tuple(tp.exclude_roles) == tuple(jp.exclude_roles)
        assert tp.location == jp.location
        for i in range(3):
            role = "lm_head" if i == 2 else "mlp_in"
            assert _fields(tp.config_for(role, i, 3)) == _fields(jp.config_for(role, i, 3))
            n += 1
    assert n or figure == "fig1b"


def test_make_policy_defaults():
    assert tcommon.make_policy("exact", 0.1) is None
    pol = tcommon.make_policy("l1", 0.1)
    assert pol.config_for("lm_head", 2, 3) is not None  # the head is sketched by default
    assert tcommon.make_policy("l1", 0.1, include_head=False).config_for("lm_head", 2, 3) is None


def _jax_params(sizes):
    return jax.device_get(jmlp.mlp_init(jax.random.key(0), sizes))


def test_exact_train_mlp_matches_jax():
    data = jcommon.mlp_data(n_train=768, n_test=256, seed=3)
    (txtr, _), _ = tcommon.mlp_data(n_train=768, n_test=256, seed=3)
    np.testing.assert_array_equal(txtr, data[0][0])
    sizes = (784, 64, 64, 10)
    want = jcommon.train_mlp(None, lr=0.4, epochs=1, data=data, sizes=sizes)
    params = interop.params_from_jax(_jax_params(sizes), mlp_arch(sizes), device="cpu")
    got = tcommon.train_mlp(None, lr=0.4, epochs=1, data=data, sizes=sizes, params=params,
                            device="cpu")
    assert abs(got["train_acc"] - want["train_acc"]) <= 1 / 768 + 1e-7
    assert abs(got["test_acc"] - want["test_acc"]) <= 1 / 256 + 1e-7
    assert got["train_acc"] > 0.5  # far above chance (10 classes): it trained


@pytest.fixture(scope="module")
def mc_problem():
    r = np.random.default_rng(11)
    batch = {"x": r.normal(size=(BATCH, SIZES[0])).astype(np.float32),
             "y": r.integers(0, SIZES[-1], BATCH).astype(np.int32)}
    jp = _jax_params(SIZES)
    tp = tree_map(lambda t: t.requires_grad_(),
                  interop.params_from_jax(jp, mlp_arch(SIZES), device="cpu"))
    tb = {"x": torch.tensor(batch["x"]), "y": torch.tensor(batch["y"]).long()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jexact = jax.jit(jax.grad(lambda p: jmlp.mlp_loss(p, jb, JRuntime().ctx())[0]))(jp)
    return jp, jb, jexact, tp, tb


def _flat(tree):
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


@pytest.mark.parametrize("method,exact_r", MC_METHODS)
def test_unbiased_and_variance_matches_jax(mc_problem, method, exact_r):
    _check_mc(mc_problem, method, MC_BUDGET, exact_r)


@pytest.mark.parametrize("exact_r", [True, False])
def test_low_budget_l1_unbiased_and_variance_matches_jax(mc_problem, exact_r):
    """Fig. 1a's samplers at its lowest budget."""
    _check_mc(mc_problem, "l1", LOW_BUDGET, exact_r)


def _check_mc(mc_problem, method, budget, exact_r):
    jp, jb, jexact, tp, tb = mc_problem
    policy_kw = dict(exact_r=exact_r)
    exact = tvariance.exact_grads(tp, tb, "cpu")
    draws = []
    stats = tvariance.mc_stats(tp, tb, tcommon.make_policy(method, budget, **policy_kw),
                               exact, N_MC, "cpu", record=draws)
    V, bias_sq = float(stats["variance"]), float(stats["bias_sq"])
    assert V > 0
    bound = CHI2_1_TAIL * V / N_MC
    assert bias_sq <= bound, (method, bias_sq, bound)
    # the same bound rejects an estimator whose squared bias equals its V:
    # the exact gradient x 1.05 (no variance)
    scaled = mc_gradient_variance(lambda k: tree_map(lambda g: 1.05 * g, exact), exact,
                                  range(N_MC))
    assert float(scaled["bias_sq"]) > CHI2_1_TAIL * float(scaled["variance"]) / N_MC

    err = torch.stack([(_flat(g) - _flat(exact)).square().sum() for g in draws])
    se = float(err.std()) / math.sqrt(N_MC)
    rt = JRuntime(policy=jcommon.make_policy(method, budget, **policy_kw))

    @jax.jit
    def jstats(keys):
        gfn = lambda k: jax.grad(lambda q: jmlp.mlp_loss(q, jb, rt.ctx(k))[0])(jp)  # noqa: E731
        return jvarlib.mc_gradient_variance(gfn, jexact, keys)

    jV = float(jstats(jax.random.split(jax.random.key(3), N_MC))["variance"])
    assert abs(V - jV) <= V_SIGMAS * math.sqrt(2) * se, (method, V, jV, se)


@pytest.mark.parametrize("method", ["per_column", "l1"])
def test_bound_rejects_the_mask_without_its_rescale(mc_problem, monkeypatch, method):
    """A planted fault: the mask sketch's gate without its 1/p, so that
    ``E[ĝ]`` keeps only a budget's share of each column. At budget 0.5 the
    bound of the test above must reject it."""
    _, _, _, tp, tb = mc_problem
    sketching = importlib.import_module("repro_torch.core.sketching")
    gate = sketching.column_gate

    def unscaled(*args, **kw):
        g = gate(*args, **kw)
        return (g != 0).to(g.dtype)

    monkeypatch.setattr(sketching, "column_gate", unscaled)
    exact = tvariance.exact_grads(tp, tb, "cpu")
    stats = tvariance.mc_stats(tp, tb, tcommon.make_policy(method, 0.5), exact, N_MC, "cpu")
    V, bias_sq = float(stats["variance"]), float(stats["bias_sq"])
    assert bias_sq > CHI2_1_TAIL * V / N_MC, (method, bias_sq, V)


def test_rho_and_bwd_flops_match_jax():
    methods = ("per_element", "per_column", "per_sample", "l1", "l2", "var", "ds", "gsv",
               "rcs", "l1_sq", "l2_sq", "var_sq", "gsv_sq")
    for m in methods:
        for p in BUDGETS + (0.6,):
            assert tvariance._rho(m, p) == jvariance._rho(m, p)
    jbase, tbase = _adaptive_policies()
    pols = [(jbase, tbase), (None, None)]
    for m in methods:
        for p in BUDGETS + (0.6,):
            for kw in ({}, dict(block=128), dict(include_head=False), dict(location="last")):
                pols.append((jcommon.make_policy(m, p, **kw), tcommon.make_policy(m, p, **kw)))
    n = 0
    for jpol, tpol in pols:
        for b in (None, 1.0, 0.5, 0.25, 0.1):
            for batch in (128, 32):
                assert (tadaptive._mlp_bwd_flops(tpol, b, batch)
                        == jadaptive._mlp_bwd_flops(jpol, b, batch))
                n += 1
    assert n > 1000


def test_adaptive_tiny_builds_each_bucket_once():
    """``traces`` counts builds: one per bucket of the schedule, by
    construction (every bucket is built before the first step, as in JAX)."""
    out = tadaptive.run(tiny=True, device="cpu")
    for name in ("fixed", "warmup_exact", "adaptive"):
        r = out[name]
        assert r["total_bwd_flops"] > 0
        assert math.isfinite(r["test_loss"])
    assert out["fixed"]["traces"] == {1.0: 1}
    assert out["warmup_exact"]["traces"] == {None: 1, 1.0: 1}
    assert out["adaptive"]["traces"] == {1.0: 1, 0.5: 1, 0.25: 1}
    assert out["adaptive"]["total_bwd_flops"] <= out["fixed"]["total_bwd_flops"]
    assert set(out["adaptive"]["budget_hist"]) <= {1.0, 0.5, 0.25}


@pytest.mark.parametrize("mod", MODULES)
def test_module_imports(mod):
    importlib.import_module(f"benchmarks.torch.{mod}")


@pytest.mark.parametrize("mod", [m for m in MODULES if m != "common"])
def test_runs_on_the_card_or_raises(mod):
    """No card here: the default device raises before any training."""
    m = importlib.import_module(f"benchmarks.torch.{mod}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if mod == "sketch_comparison":
            m.main(["--epochs", "1"])
        else:
            m.run(**({"tiny": True} if mod == "bench_adaptive" else {}))
