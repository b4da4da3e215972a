"""repro_torch estimators against the JAX ``_CompactEstimator`` math, given
the same plan, and the sketched site's unbiasedness under Monte Carlo.

The two packages sample plans from different generators, so the parity tests
take JAX's plan (``indices``, ``scales``) and feed it to both sides.
Tolerance: float32 rtol=1e-5 with atol=1e-5 for matmul outputs (an element
that cancels to ~0 keeps its K-term sum's absolute rounding, ~4e-6).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketching as jsk
from repro_torch import rng
from repro_torch.core import estimators
from repro_torch.core.sketching import SketchConfig

# the packages' ``core`` re-export the function of the same name
jsl = importlib.import_module("repro.core.sketched_linear")
sketched_linear = importlib.import_module("repro_torch.core.sketched_linear")

RTOL, MM_ATOL = 1e-5, 1e-5
N, D_IN = 64, 48


def _t(a):
    return torch.tensor(np.asarray(a))


def _problem(n, seed=0):
    r = np.random.default_rng(seed)
    G = (r.normal(size=(N, n)) * r.uniform(0.2, 2.0, size=n)).astype(np.float32)
    W = (r.normal(size=(n, D_IN)) / np.sqrt(D_IN)).astype(np.float32)
    X = r.normal(size=(N, D_IN)).astype(np.float32)
    return G, W, X


def _jax_plan_and_vjp(kw, G, W, X):
    """JAX's plan and its _CompactEstimator outputs (dx, dense dW, dense db)."""
    cfg = jsk.effective_cfg(jsk.SketchConfig(**kw), G.shape[1])
    plan = jsk.column_plan(cfg, jnp.asarray(G), jnp.asarray(W), jax.random.key(3),
                           want_compact=True)
    est = jsl._CompactEstimator()
    if cfg.block > 1:
        dx, dwc, db_blk = est._fused(cfg, jnp.asarray(G), plan.indices, plan.scales,
                                     jnp.asarray(W), jnp.asarray(X))
        cols = (plan.indices[:, None] * cfg.block + jnp.arange(cfg.block)[None, :]).reshape(-1)
        rows, db_c = dwc.reshape(-1, W.shape[1]), db_blk.reshape(-1)
    else:
        out = est._per_column(jnp.asarray(G), plan.indices, plan.scales, jnp.asarray(W),
                              jnp.asarray(X))
        dx, rows, cols, db_c = out.dx, out.rows, out.cols, out.db_c
    dW = jnp.zeros_like(jnp.asarray(W)).at[cols].add(rows)
    db = jnp.zeros((G.shape[1],), jnp.float32).at[cols].add(db_c)
    return plan, tuple(np.asarray(a) for a in (dx, dW, db))


CASES = [("l1", 128, 512, 0.25), ("l1", 128, 384, 0.7), ("l2", 0, 40, 0.3),
         ("l1", 128, 100, 0.5), ("per_column", 128, 256, 0.5)]


@pytest.mark.parametrize("backend", ["pallas", "compact"])
@pytest.mark.parametrize("method,block,n,budget", CASES)
def test_estimator_given_jax_plan_matches_jax(backend, method, block, n, budget):
    G, W, X = _problem(n)
    kw = dict(method=method, budget=budget, backend=backend, block=block)
    plan, (dx, dW, db) = _jax_plan_and_vjp(kw, G, W, X)
    est = estimators.get_estimator(backend)
    out = est.apply_plan(SketchConfig(**kw), _t(G), _t(X), _t(W),
                         _t(plan.indices).long(), _t(plan.scales))
    assert out.is_compact
    assert out.rows.shape[0] == est.compact_rank(SketchConfig(**kw), n)
    np.testing.assert_allclose(out.dx.numpy(), dx, rtol=RTOL, atol=MM_ATOL)
    dW_t = torch.zeros(n, D_IN).index_add_(0, out.cols, out.rows).numpy()
    db_t = torch.zeros(n).index_add_(0, out.cols, out.db_c).numpy()
    np.testing.assert_allclose(dW_t, dW, rtol=RTOL, atol=MM_ATOL)
    np.testing.assert_allclose(db_t, db, rtol=RTOL, atol=MM_ATOL)


class _FixedPlan(sketched_linear._PallasEstimator):
    """Test estimator: the pallas backward on a plan fixed in advance."""

    name = "fixed_plan_test"

    def __init__(self, indices, scales):
        self.indices, self.scales = indices, scales

    def apply(self, cfg, G2d, X2d, w, gen, *, has_b):
        return self.apply_plan(cfg, G2d, X2d, w, self.indices, self.scales)


def test_site_function_scatters_like_jax_spine():
    """Through the autograd Function: dX, the dense dW scatter and db equal
    the JAX spine's ``_local_bwd`` math for the same plan."""
    n = 512
    G, W, X = _problem(n, seed=1)
    b = np.linspace(-1, 1, n).astype(np.float32)
    kw = dict(method="l1", budget=0.5, backend="pallas", block=128)
    plan, (dx, dW, db) = _jax_plan_and_vjp(kw, G, W, X)
    estimators.register_estimator(
        _FixedPlan(_t(plan.indices).long(), _t(plan.scales)), overwrite=True)
    x = _t(X).reshape(4, N // 4, D_IN).requires_grad_(True)
    w = _t(W).requires_grad_(True)
    bias = _t(b).requires_grad_(True)
    cfg = SketchConfig(method="l1", budget=0.5, backend="fixed_plan_test", block=128)
    y = sketched_linear.sketched_linear(x, w, bias, key=rng.generator(0, "cpu"), cfg=cfg)
    np.testing.assert_allclose(y.detach().numpy().reshape(N, n), X @ W.T + b, rtol=RTOL,
                               atol=MM_ATOL)
    gx, gw, gb = torch.autograd.grad(y, (x, w, bias), _t(G).reshape(4, N // 4, n))
    np.testing.assert_allclose(gx.numpy().reshape(N, D_IN), dx, rtol=RTOL, atol=MM_ATOL)
    np.testing.assert_allclose(gw.numpy(), dW, rtol=RTOL, atol=MM_ATOL)
    np.testing.assert_allclose(gb.numpy(), db, rtol=RTOL, atol=MM_ATOL)
    assert "fixed_plan_test" in estimators.registered_backends()


def test_registry_rules():
    with pytest.raises(ValueError, match="already registered"):
        estimators.register_estimator(sketched_linear._MaskEstimator())
    with pytest.raises(KeyError, match="unknown estimator"):
        estimators.get_estimator("nope")
    assert {"mask", "compact", "pallas"} <= set(estimators.registered_backends())


@pytest.mark.parametrize("backend,block", [("pallas", 128), ("mask", 128), ("pallas", 0)])
def test_sketched_site_unbiased_mc(backend, block):
    """E[dW] = Gᵀ X and E[dX] = G W at budget 0.25 (one of four 128-blocks kept
    per draw): t-statistics over 800 draws, thresholds as in
    tests/test_sketching.py; and a single draw is far from exact."""
    n = 512
    G, W, X = _problem(n, seed=2)
    w = _t(W).requires_grad_(True)
    x = _t(X).requires_grad_(True)
    cfg = SketchConfig(method="l1", budget=0.25, backend=backend, block=block)
    draws_w, draws_x = [], []
    for i in range(800):
        y = sketched_linear.sketched_linear(x, w, key=rng.generator(i, "cpu"), cfg=cfg)
        gx, gw = torch.autograd.grad(y, (x, w), _t(G))
        draws_w.append(gw.numpy())
        draws_x.append(gx.numpy())
    for draws, want in ((np.stack(draws_w), G.T @ X), (np.stack(draws_x), G @ W)):
        scale = np.abs(want).max()
        se = draws.std(0) / np.sqrt(len(draws)) + 1e-3 * scale
        t = np.abs(draws.mean(0) - want) / se
        assert np.mean(t) < 2.2 and np.percentile(t, 95) < 5.0
        assert np.abs(draws[0] - want).max() > 0.1 * scale
