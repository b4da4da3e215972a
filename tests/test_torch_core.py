"""repro_torch solver, scores and sketching against the JAX package.

Deterministic functions get the same numpy inputs in both packages and must
agree to float32 tolerance (rtol=1e-5, atol=1e-6 unless a test says why
not). Samplers draw from different generators in the two packages, so they
are checked statistically, porting tests/test_solver.py and
tests/test_sketching.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scores as jscores
from repro.core import sketching as jsk
from repro.core import solver as jsolver
from repro_torch import rng
from repro_torch.core import scores, sketching, solver
from repro_torch.core.sketching import SketchConfig

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------- solver


def _brute_force_probs(w, r):
    """Bisection on sqrt(lambda) for min Σ w/p s.t. Σp=r, p∈(0,1]."""
    t = np.sqrt(np.maximum(w, 1e-30))
    lo, hi = 1e-12, t.max() * len(w)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if np.minimum(1.0, t / mid).sum() > r:
            lo = mid
        else:
            hi = mid
    return np.minimum(1.0, t / hi)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,r,power", [(32, 4, 3), (100, 20, 3), (64, 63, 3), (8, 2, 6),
                                       (8, 6, 6), (6, 1, 1)])
def test_optimal_probabilities_matches_jax(seed, n, r, power):
    w = np.random.default_rng(seed).uniform(size=n).astype(np.float32) ** power
    p = solver.optimal_probabilities(_t(w), r).numpy()
    p_jax = np.asarray(jsolver.optimal_probabilities(jnp.asarray(w), r))
    np.testing.assert_allclose(p, p_jax, rtol=RTOL, atol=ATOL)
    assert abs(p.sum() - r) < 1e-3 and p.max() <= 1.0 + 1e-6 and p.min() > 0
    obj = (w / np.maximum(p, 1e-12)).sum()
    p_ref = _brute_force_probs(w.astype(np.float64), r)
    assert obj <= (w / np.maximum(p_ref, 1e-12)).sum() * (1 + 1e-3)


def test_optimal_probabilities_guards():
    # all-zero weights: the guard gives the uniform distribution
    p = solver.optimal_probabilities(torch.zeros(10), 4)
    np.testing.assert_allclose(p.numpy(), np.full(10, 0.4), rtol=RTOL, atol=ATOL)
    # full budget: every coordinate kept
    assert torch.equal(solver.optimal_probabilities(torch.rand(8), 8), torch.ones(8))
    # relative floor: a zero weight next to large ones keeps p > 0 (as in JAX)
    w = np.array([100.0, 50.0, 0.0, 0.5, 0.1, 0.0], np.float32)
    p = solver.optimal_probabilities(_t(w), 3).numpy()
    assert p.min() > 0
    np.testing.assert_allclose(p, np.asarray(jsolver.optimal_probabilities(jnp.asarray(w), 3)),
                               rtol=RTOL, atol=ATOL)


def test_sample_exact_r_count_distinct_ascending():
    w = np.random.default_rng(0).uniform(size=50).astype(np.float32) ** 2
    p = solver.optimal_probabilities(_t(w), 12)
    for i in range(20):
        idx = solver.sample_exact_r(rng.generator(i, "cpu"), p, 12).numpy()
        assert len(idx) == 12 and len(np.unique(idx)) == 12
        assert np.all(np.diff(idx) > 0)


@pytest.mark.parametrize("n,r,power,seed", [(24, 6, 2, 1), (8, 4, 6, 7)])
def test_sample_exact_r_marginals(n, r, power, seed):
    """MC marginals equal p: within 6 standard errors (as tests/test_solver.py)."""
    n_mc = 4000
    w = np.random.default_rng(seed).uniform(size=n).astype(np.float32) ** power
    p = solver.optimal_probabilities(_t(w), r)
    counts = np.zeros(n)
    for i in range(n_mc):
        counts[solver.sample_exact_r(rng.generator(i, "cpu"), p, r).numpy()] += 1
    p = p.numpy()
    se = np.sqrt(p * (1 - p) / n_mc) + 1e-4
    assert np.all(np.abs(counts / n_mc - p) < 6 * se)


def test_sample_independent_marginals():
    p = torch.tensor([0.05, 0.3, 0.5, 0.9, 1.0])
    z = torch.stack([solver.sample_independent(rng.generator(i, "cpu"), p) for i in range(4000)])
    assert set(np.unique(z.numpy())) <= {0.0, 1.0}
    se = np.sqrt(p.numpy() * (1 - p.numpy()) / 4000) + 1e-4
    assert np.all(np.abs(z.mean(0).numpy() - p.numpy()) < 6 * se)


def test_sample_independent_on_non_finite_scores_keeps_nothing_and_raises_nothing():
    """``uniform < p``, as JAX's Bernoulli: a NaN probability keeps nothing
    (``torch.bernoulli`` raised here and is a device-side assert on CUDA), an
    infinite one is kept, as in JAX. An infinite score column makes every
    water-filling probability NaN in both packages, so the independent
    sketch then keeps no column at all (its gate, 0 / NaN, is NaN in both, so
    the step's non-finite gradient trips the sentinel); a NaN score column
    falls back to the uniform probabilities in both. The float32 0/1 mask
    stays."""
    p = torch.tensor([0.5, float("nan"), 1.0, float("nan"), float("inf"), 0.0])
    for i in range(50):
        z = solver.sample_independent(rng.generator(i, "cpu"), p)
        assert z.dtype == torch.float32
        assert z[[1, 3, 5]].tolist() == [0.0, 0.0, 0.0] and z[[2, 4]].tolist() == [1.0, 1.0]
        jz = jsolver.sample_independent(jax.random.key(i), jnp.asarray(p.numpy()))
        assert np.asarray(jz)[[1, 2, 3, 4, 5]].tolist() == z[[1, 2, 3, 4, 5]].tolist()
    r = np.random.default_rng(0)
    for bad in (float("inf"), float("nan")):
        G = r.normal(size=(16, 12)).astype(np.float32)
        G[:, 3] = bad
        cfg = SketchConfig(method="l1", budget=0.5, exact_r=False)
        w = scores.column_scores("l1", _t(G))
        p = solver.optimal_probabilities(w, 6)
        jp = jsolver.optimal_probabilities(jnp.asarray(w.numpy()), 6)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6)
        for i in range(20):
            plan = sketching.column_plan(cfg, _t(G), None, rng.generator(i, "cpu"),
                                         want_compact=False)
            if bad == float("inf"):  # every probability NaN: nothing kept
                assert bool(torch.isnan(plan.probs).all())
                z = solver.sample_independent(rng.generator(i, "cpu"), plan.probs)
                assert float(z.sum()) == 0.0
            else:  # the uniform fallback
                assert torch.allclose(plan.probs, torch.full((12,), 0.5))


def test_expected_distortion_matches_jax_and_decreases():
    w = np.random.default_rng(2).uniform(size=40).astype(np.float32)
    ds = []
    for r in (4, 10, 20, 39):
        p = solver.optimal_probabilities(_t(w), r)
        d = float(solver.expected_distortion(_t(w), p))
        d_jax = float(jsolver.expected_distortion(jnp.asarray(w), jnp.asarray(p.numpy())))
        assert d == pytest.approx(d_jax, rel=RTOL, abs=ATOL)
        ds.append(d)
    assert all(a >= b - 1e-5 for a, b in zip(ds, ds[1:]))


# ---------------------------------------------------------------- scores


@pytest.mark.parametrize("method", jscores.SCORE_METHODS)
def test_column_scores_match_jax(method):
    r = np.random.default_rng(3)
    G = r.normal(size=(48, 20)).astype(np.float32)
    W = r.normal(size=(20, 12)).astype(np.float32)
    got = scores.column_scores(method, _t(G), _t(W)).numpy()
    want = np.asarray(jscores.column_scores(method, jnp.asarray(G), jnp.asarray(W)))
    # gsv goes through a float32 eigendecomposition, which the two packages
    # compute with different LAPACK paths: 1e-4 relative
    rtol = 1e-4 if method.startswith("gsv") else RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("method", ["l1", "l2", "l1_sq", "l2_sq", "var", "ds"])
def test_kernel_reduction_helpers_match_jax(method):
    assert scores.kernel_reduction_mode(method) == jscores.kernel_reduction_mode(method)
    mode = scores.kernel_reduction_mode(method)
    if mode is None:
        with pytest.raises(ValueError):
            scores.scores_from_kernel_reduction(method, torch.ones(3))
        return
    red = np.random.default_rng(4).uniform(size=16).astype(np.float32)
    got = scores.scores_from_kernel_reduction(method, _t(red)).numpy()
    want = np.asarray(jscores.scores_from_kernel_reduction(method, jnp.asarray(red)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- sketching


def test_static_ranks_and_effective_cfg_match_jax():
    for budget in (0.05, 0.2, 0.25, 0.5, 0.999, 1.0):
        for round_to in (1, 8, 128):
            for n in (1, 7, 64, 100, 768, 2048):
                kw = dict(method="l1", budget=budget, round_to=round_to)
                assert sketching.static_rank(SketchConfig(**kw), n) == \
                    jsk.static_rank(jsk.SketchConfig(**kw), n)
        for n in (128, 512, 768, 2048):
            kw = dict(method="l1", budget=budget, block=128)
            assert sketching.static_block_rank(SketchConfig(**kw), n) == \
                jsk.static_block_rank(jsk.SketchConfig(**kw), n)
    for n in (64, 100, 128, 200, 256):
        kw = dict(method="l1", budget=0.5, block=128)
        assert sketching.effective_cfg(SketchConfig(**kw), n).block == \
            jsk.effective_cfg(jsk.SketchConfig(**kw), n).block


def test_sketch_config_validation_matches_jax():
    for kw in (dict(method="bogus"), dict(budget=0.0), dict(budget=1.5),
               dict(method="per_sample", backend="compact"),
               dict(method="l1", backend="pallas", exact_r=False),
               dict(backend="not_registered")):
        with pytest.raises(ValueError):
            jsk.SketchConfig(**kw)
        with pytest.raises(ValueError):
            SketchConfig(**kw)


@pytest.mark.parametrize("method,backend,block,n", [
    ("l1", "mask", 0, 40), ("l2", "mask", 0, 40), ("ds", "compact", 0, 40),
    ("per_column", "mask", 0, 40), ("l1_sq", "pallas", 0, 40),
    ("l1", "pallas", 128, 512), ("l2", "compact", 128, 384),
    ("per_column", "pallas", 128, 512), ("l1", "pallas", 128, 100)])
def test_column_plan_probs_match_jax(method, backend, block, n):
    """The plan's marginals are deterministic in G and W: both packages agree."""
    r = np.random.default_rng(5)
    G = (r.normal(size=(32, n)) * r.uniform(0.1, 3.0, size=n)).astype(np.float32)
    W = r.normal(size=(n, 16)).astype(np.float32)
    kw = dict(method=method, budget=0.3, backend=backend, block=block)
    plan = sketching.column_plan(SketchConfig(**kw), _t(G), _t(W), rng.generator(0, "cpu"),
                                 want_compact=True)
    jplan = jsk.column_plan(jsk.SketchConfig(**kw), jnp.asarray(G), jnp.asarray(W),
                            jax.random.key(0), want_compact=True)
    np.testing.assert_allclose(plan.probs.numpy(), np.asarray(jplan.probs), rtol=RTOL, atol=ATOL)
    assert plan.indices.shape == jplan.indices.shape
    kept = plan.indices.numpy()
    assert len(np.unique(kept)) == len(kept) and np.all(np.diff(kept) > 0)
    # scales are 1/p at the kept (block or column) ids
    nb_probs = plan.probs.numpy()[::block] if sketching.effective_cfg(
        SketchConfig(**kw), n).block > 1 else plan.probs.numpy()
    np.testing.assert_allclose(plan.scales.numpy(), 1.0 / nb_probs[kept], rtol=RTOL)


def test_block_plan_keeps_every_block_at_full_budget():
    G = torch.randn(16, 512, generator=rng.generator(1, "cpu"))
    plan = sketching.column_plan(SketchConfig(method="l1", budget=0.999, backend="pallas",
                                              block=128), G, None, rng.generator(2, "cpu"),
                                 want_compact=True)
    assert torch.equal(plan.indices, torch.arange(4))
    assert torch.equal(plan.scales, torch.ones(4))


@pytest.mark.parametrize("method,block", [("l1", 0), ("per_column", 0), ("l1", 8),
                                          ("per_sample", 0)])
def test_sketch_dense_unbiased(method, block):
    """E[Ĝ|G] = G under MC: t-statistics as in tests/test_sketching.py."""
    r = np.random.default_rng(6)
    G = _t((r.normal(size=(12, 32)) * r.uniform(0.2, 2.0, size=32)).astype(np.float32))
    cfg = SketchConfig(method=method, budget=0.5, block=block)
    draws = torch.stack([sketching.sketch_dense(cfg, G, None, rng.generator(i, "cpu"))
                         for i in range(800)]).numpy()
    want = G.numpy()
    scale = np.abs(want).max()
    se = draws.std(0) / np.sqrt(len(draws)) + 1e-3 * scale
    t = np.abs(draws.mean(0) - want) / se
    assert np.mean(t) < 2.2 and np.percentile(t, 95) < 5.0
    if method != "per_sample":
        kept = (draws[0] != 0).any(0).sum()
        assert kept == 16  # exact-r keeps half of the 32 columns (or of the 4 blocks)
