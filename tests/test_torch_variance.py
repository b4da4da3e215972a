"""repro_torch's rcs sketch and variance tools against the JAX package.

Deterministic parts get the same numpy inputs in both packages: the rcs
plan's ``Γ^{±1/2}`` (rtol 1e-4, atol 1e-5 of the largest entry: float32
``eigh`` in two LAPACK builds) and direction probabilities (atol 1e-4), and
the sketch applied to JAX's own sampled directions (1e-4 of the largest
entry); the variance tools on identical gradient draws (rtol 1e-5; atol
1e-6 of the largest total where a term is 0 up to rounding). The samplers
are checked statistically, porting the rcs entry of
``tests/test_sketching.py::test_unbiased`` (800 draws, the same
t-statistics), ``tests/test_optimality.py::
test_rcs_lower_distortion_than_per_column`` (400 draws) and the four tests
of ``tests/test_variance.py`` (their draws and thresholds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Runtime as JRuntime
from repro.core import SketchConfig as JSketchConfig
from repro.core import SketchPolicy as JSketchPolicy
from repro.core import sketching as jsk
from repro.core import solver as jsolver
from repro.core import variance as jvariance
from repro.optim import constant as jconstant
from repro_torch import rng
from repro_torch.api import Runtime, SketchConfig, SketchPolicy
from repro_torch.core import sketched_linear, sketching
from repro_torch.core.variance import chain_variance_decomposition, mc_gradient_variance
from repro_torch.optim import constant


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the MC draws are tiny, and with several test
    processes on the machine, each process's full thread pool oversubscribes
    the cores and slows every draw many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rcs_problem(seed, N=32, n=16, m=24):
    """A full-rank problem (m >= n): every eigenvalue of A is far above
    float32 noise, so both packages' eigh agree on its spectrum."""
    r = np.random.default_rng(seed)
    G = (r.normal(size=(N, n)) * (0.9 ** np.arange(n))[None, :]).astype(np.float32)
    W = (r.normal(size=(n, m)) / np.sqrt(m)).astype(np.float32)
    return G, W


# ------------------------------------------------------------------ rcs


@pytest.mark.parametrize("seed", [0, 1])
def test_rcs_sym_sqrt_invsqrt_matches_jax(seed):
    G, _ = _rcs_problem(seed)
    gamma = G.T @ G / G.shape[0]
    half, inv_half = sketching._sym_sqrt_invsqrt(_t(gamma), 1e-5)
    jhalf, jinv = jsk._sym_sqrt_invsqrt(jnp.asarray(gamma), 1e-5)
    for got, want in ((half, jhalf), (inv_half, jinv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose((half @ inv_half).numpy(), np.eye(16), atol=1e-4)


@pytest.mark.parametrize("seed,budget", [(0, 0.25), (1, 0.5), (2, 0.75)])
def test_rcs_applies_jax_sampled_directions_like_jax(seed, budget):
    """The port's plan has JAX's probabilities, and applied to the directions
    JAX sampled (``sample_exact_r`` with apply_rcs's own key) gives JAX's Ĝ."""
    G, W = _rcs_problem(seed)
    cfg = SketchConfig(method="rcs", budget=budget)
    jcfg = JSketchConfig(method="rcs", budget=budget)
    plan = sketching.rcs_plan(cfg, _t(G), _t(W))
    # JAX's probabilities and directions, as apply_rcs computes them
    half, _ = jsk._sym_sqrt_invsqrt(jnp.asarray(G.T @ G / G.shape[0]), jcfg.ridge)
    A = half @ (jnp.asarray(W) @ jnp.asarray(W).T) @ half
    p = jsolver.optimal_probabilities(jnp.maximum(jnp.linalg.eigh(A)[0], 0.0), plan.r)
    np.testing.assert_allclose(plan.probs.numpy(), np.asarray(p), atol=1e-4)
    assert abs(float(plan.probs.sum()) - plan.r) < 1e-3
    key = jax.random.key(seed)
    idx = np.asarray(jsolver.sample_exact_r(key, p, plan.r))
    want = np.asarray(jsk.apply_rcs(jcfg, jnp.asarray(G), jnp.asarray(W), key))
    got = sketching.apply_rcs_directions(_t(G), plan, torch.tensor(idx).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())
    # the generator path draws r distinct directions and gives a G-shaped Ĝ
    ghat = sketching.sketch_dense(cfg, _t(G), _t(W), rng.generator(seed, "cpu"))
    assert ghat.shape == G.shape and torch.isfinite(ghat).all()
    with pytest.raises(ValueError, match="RCS requires"):
        sketching.sketch_dense(cfg, _t(G), None, rng.generator(0, "cpu"))


def test_rcs_unbiased_mc():
    """The rcs entry of tests/test_sketching.py::test_unbiased (budget 0.75):
    E over 800 draws of the sketched VJP's (dX, dW, db) equals exact
    backprop's, by the same t-statistics."""
    r = np.random.default_rng(0)
    x = _t(r.normal(size=(4, 12, 24))).requires_grad_(True)
    w = _t(r.normal(size=(40, 24)) / np.sqrt(24)).requires_grad_(True)
    b = _t(r.normal(size=(40,)) * 0.1).requires_grad_(True)
    cfg = SketchConfig(method="rcs", budget=0.75)

    def grads(gen):
        y = sketched_linear(x, w, b, key=gen, cfg=None if gen is None else cfg)
        return [g.numpy() for g in torch.autograd.grad(torch.sin(y).sum(), (x, w, b))]

    exact = grads(None)
    draws = [grads(rng.generator(i, "cpu")) for i in range(800)]
    for j, want in enumerate(exact):
        d = np.stack([g[j] for g in draws])
        scale = np.abs(want).max() + 1e-9
        std = d.std(0)
        det = std < 1e-6 * scale
        np.testing.assert_allclose(d.mean(0)[det], want[det], rtol=1e-3, atol=1e-4 * scale)
        se = std[~det] / np.sqrt(len(draws)) + 1e-3 * scale
        t = np.abs(d.mean(0)[~det] - want[~det]) / se
        assert np.mean(t) < 2.2 and np.percentile(t, 95) < 5.0


def test_rcs_lower_distortion_than_per_column():
    """Port of tests/test_optimality.py::test_rcs_lower_distortion_than_per_column:
    the Prop. 3.3 sketch has lower E||J(I-R)g||² than a diagonal mask."""
    r = np.random.default_rng(3)
    n, m, B, k = 16, 12, 32, 4
    W = r.normal(size=(n, m)) * (0.5 ** np.arange(m))[None, :]
    G = r.normal(size=(B, n)) * (0.7 ** np.arange(n))[None, :]
    exact = G @ W
    cfg = SketchConfig(method="rcs", budget=k / n, ridge=1e-6)
    cfg_col = SketchConfig(method="per_column", budget=k / n)

    def dist(ghat):
        return np.sum((ghat.numpy().astype(np.float64) @ W - exact) ** 2)

    d_rcs = np.mean([dist(sketching.apply_rcs(cfg, _t(G), _t(W), rng.generator(i, "cpu")))
                     for i in range(400)])
    d_col = np.mean([dist(sketching.sketch_dense(cfg_col, _t(G), _t(W),
                                                 rng.generator(i, "cpu"))) for i in range(400)])
    assert d_rcs < d_col


# ------------------------------------------------------------- variance


def _sketch_vjp(cfg):
    def fn(layer, seed, W, g):
        ghat = sketching.sketch_dense(cfg, g, W, rng.generator(rng.fold_in(seed, 97 + layer),
                                                               "cpu"))
        return ghat @ W

    return fn


@pytest.mark.parametrize("method", ["per_column", "l1"])
def test_prop22_decomposition(method):
    """total ≈ local + propagated at every node (cross term vanishes)."""
    r = np.random.default_rng(0)
    Ws = [_t(r.normal(size=(12, 12)) / np.sqrt(12)) for _ in range(3)]
    G_out = _t(r.normal(size=(16, 12)))
    cfg = SketchConfig(method=method, budget=0.5)
    d = chain_variance_decomposition(Ws, G_out, _sketch_vjp(cfg), range(400))
    for k in range(3):
        total, expect = d["total"][k], d["local"][k] + d["propagated"][k]
        assert total == pytest.approx(expect, rel=0.15), (k, total, expect)


def test_variance_dampens_with_contractive_jacobians():
    """Prop. 2.2 remark: the propagated term scales with the downstream
    Jacobians' operator norms, so contractive chains damp upstream error
    relative to the locally injected distortion."""
    r = np.random.default_rng(1)
    G_out = _t(r.normal(size=(16, 12)))
    cfg = SketchConfig(method="per_column", budget=0.5)

    def prop_share(scale):
        Ws = [_t(r.normal(size=(12, 12)) / np.sqrt(12) * scale) for _ in range(4)]
        d = chain_variance_decomposition(Ws, G_out, _sketch_vjp(cfg), range(200))
        return d["propagated"][0] / max(d["local"][0], 1e-12)

    assert prop_share(0.4) < prop_share(1.6)


def _vjp_grad_fn(W, x, cfg, col_w=None):
    def loss(xx, gen):
        y = torch.sin(sketched_linear(xx, W, key=gen, cfg=None if gen is None else cfg))
        return (y if col_w is None else y * col_w[None, :]).sum()

    def g(seed):
        xx = x.clone().requires_grad_(True)
        gen = None if seed is None else rng.generator(seed, "cpu")
        return torch.autograd.grad(loss(xx, gen), xx)[0]

    return g


def test_variance_decreases_with_budget():
    r = np.random.default_rng(2)
    W = _t(r.normal(size=(20, 20)) / np.sqrt(20))
    x = _t(r.normal(size=(8, 20)))
    exact = _vjp_grad_fn(W, x, None)(None)
    Vs = [float(mc_gradient_variance(_vjp_grad_fn(W, x, SketchConfig(method="l1", budget=p)),
                                     exact, range(300))["variance"]) for p in (0.1, 0.3, 0.7)]
    assert Vs[0] > Vs[1] > Vs[2]


def test_data_dependent_beats_uniform_variance():
    """ℓ1 probabilities give lower gradient variance than uniform per-column
    at the same budget when G's column norms span orders of magnitude."""
    r = np.random.default_rng(3)
    W = _t(r.normal(size=(24, 24)) / 5)
    x = _t(r.normal(size=(16, 24)))
    col_w = _t(0.45 ** np.arange(24))
    exact = _vjp_grad_fn(W, x, None, col_w)(None)

    def V(method):
        gfn = _vjp_grad_fn(W, x, SketchConfig(method=method, budget=0.25), col_w)
        return float(mc_gradient_variance(gfn, exact, range(600))["variance"])

    v_l1, v_uniform = V("l1"), V("per_column")
    assert v_l1 < 0.7 * v_uniform, (v_l1, v_uniform)


def test_mc_gradient_variance_matches_jax_on_identical_draws():
    r = np.random.default_rng(5)
    K = 50
    draws = {"a": r.normal(size=(K, 3, 4)).astype(np.float32),
             "b": r.normal(size=(K, 5)).astype(np.float32)}
    exact = {"a": r.normal(size=(3, 4)).astype(np.float32),
             "b": r.normal(size=(5,)).astype(np.float32)}
    jd = {k: jnp.asarray(v) for k, v in draws.items()}
    want = jvariance.mc_gradient_variance(lambda i: {k: v[i] for k, v in jd.items()},
                                          {k: jnp.asarray(v) for k, v in exact.items()},
                                          jnp.arange(K))
    got = mc_gradient_variance(lambda i: {k: _t(v[i]) for k, v in draws.items()},
                               {k: _t(v) for k, v in exact.items()}, range(K))
    assert got["n_samples"] == want["n_samples"] == K
    for name in ("variance", "bias_sq", "exact_norm_sq"):
        assert float(got[name]) == pytest.approx(float(want[name]), rel=1e-5)


def test_chain_variance_decomposition_matches_jax_on_identical_draws():
    """Each package's sketch_vjp draws the same column masks: JAX from
    ``fold_in(key_i, k)``, the port by looking up the masks JAX drew under
    the port's ``fold_in(i, k)``."""
    r = np.random.default_rng(6)
    L, n, K = 3, 10, 40
    Ws = [r.normal(size=(n, n)).astype(np.float32) / np.sqrt(n) for _ in range(L)]
    G_out = r.normal(size=(8, n)).astype(np.float32)
    jkeys = [jax.random.key(i) for i in range(K)]

    def jmask(kk):
        return jax.random.bernoulli(kk, 0.5, (n,)).astype(jnp.float32)

    table = {rng.fold_in(i, k): _t(jmask(jax.random.fold_in(jkeys[i], k)))
             for i in range(K) for k in range(L)}
    want = jvariance.chain_variance_decomposition(
        [jnp.asarray(W) for W in Ws], jnp.asarray(G_out),
        lambda k, kk, W, g: ((g * jmask(kk)[None, :]) / 0.5) @ W, jkeys)
    got = chain_variance_decomposition(
        [_t(W) for W in Ws], _t(G_out),
        lambda k, seed, W, g: ((g * table[seed][None, :]) / 0.5) @ W, range(K))
    for name in ("total", "local", "propagated"):
        # the last node's propagated term is 0 up to rounding (its input is exact)
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6 * max(want["total"]))
    assert all(v > 0 for v in got["local"])


# ------------------------------------------------- schedule and runtime


def test_constant_schedule_and_budgeted_ctx_match_jax():
    assert constant(0.2)(0) == constant(0.2)(123) == pytest.approx(float(jconstant(0.2)(123)))
    assert isinstance(constant(0.2)(5), float)
    base = dict(method="l1", budget=0.4)
    rt = Runtime(policy=SketchPolicy(base=SketchConfig(**base)), device="cpu")
    jrt = JRuntime(policy=JSketchPolicy(base=JSketchConfig(**base)))
    for budget in (None, 1.0, 0.25):
        ctx, jctx = rt.ctx(7, budget=budget, layer_index=2, n_layers=4), jrt.ctx(
            jax.random.key(7), budget=budget, layer_index=2, n_layers=4)
        assert (ctx.layer_index, ctx.n_layers) == (jctx.layer_index, jctx.n_layers) == (2, 4)
        if budget is None:
            assert ctx.policy is None and jctx.policy is None and rt.policy_at(None) is None
        else:
            assert ctx.policy.base.budget == jctx.policy.base.budget
    assert rt.ctx(7).policy is rt.policy and Runtime(device="cpu").policy_at(0.5) is None
    # an exact context leaves every site exact: the plain autograd gradient
    x = torch.randn(6, 8, requires_grad=True)
    w = torch.randn(5, 8)
    from repro_torch.nn.common import dense

    g = torch.autograd.grad(dense({"w": w}, x, rt.ctx(7, budget=None), "mlp_in").sum(), x)[0]
    assert torch.equal(g, torch.ones(6, 5) @ w)
