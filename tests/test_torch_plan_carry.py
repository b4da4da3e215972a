"""Plan carry in repro_torch (``onepass`` and ``stale``) against the JAX
package, recomputed in the same process on the same numpy inputs.

* the planner from carried scores (``column_plan_from_scores``): marginals;
* the one-pass backward given JAX's plan: dX, rows, cols, db and the
  refreshed carry;
* the carry's transport (``core/plan_state.py``): seeding, collection,
  write-back after the update, and its absence from the gradient norm;
* one SGD step of a 2-layer LM from JAX's own initial state;
* Monte Carlo unbiasedness under the uniform prior and under a wrong carry.

Tolerances: float32 rtol=1e-5; matmul outputs and gradients add atol=1e-5
(an element that cancels to ~0 keeps the absolute rounding of its K-term
float32 sum); carried scores, sums of |G| over the rows, add atol=1e-6 of
the site's largest score. The Monte Carlo thresholds are those of JAX's
tests/test_plan_state.py.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.execution import ExecutionConfig as JExecutionConfig
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import SketchConfig as JSketchConfig
from repro.core import SketchPolicy as JSketchPolicy
from repro.core import plan_state as jpstate
from repro.core import sketching as jsk
from repro.optim import sgd as jsgd
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import rng
from repro_torch.api import Runtime, SketchConfig, SketchPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import estimators, plan_state, sketching
from repro_torch.core.sketching import ColumnPlan
from repro_torch.interop import params_from_jax
from repro_torch.models import lm
from repro_torch.nn.common import Ctx
from repro_torch.optim import adamw, sgd
from repro_torch.tree import tree_leaves

# the packages' ``core`` re-export the function of the same name
jsl = importlib.import_module("repro.core.sketched_linear")
sketched_linear = importlib.import_module("repro_torch.core.sketched_linear")

RTOL, MM_ATOL = 1e-5, 1e-5
N, DIN, DOUT = 32, 16, 24
# widths that divide a block of 32: q/o 64, k/v 32, mlp 128
TINY = dict(name="lm-tiny-carry", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv=2, d_ff=128, vocab=128, q_chunk=16, kv_chunk=16)
B, S = 2, 16


def _t(a):
    return torch.tensor(np.asarray(a))


def _cfg(pkg, **kw):
    return (JSketchConfig if pkg == "jax" else SketchConfig)(**kw)


def _policy(pkg, backend, budget=0.4, block=4):
    cfg = _cfg(pkg, method="l1", budget=budget, backend=backend, block=block)
    return (JSketchPolicy if pkg == "jax" else SketchPolicy)(base=cfg)


def _batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _sslots(params):
    """{path: carry leaf} of a port parameter tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif path[-1] == plan_state.PLAN_SLOT:
            out["/".join(path)] = node

    walk(params, ())
    return out


# ---------------------------------------------------------------------------
# Planning from carried scores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scores_kind", ["skewed", "zeros"])
@pytest.mark.parametrize("method,block,n,budget", [
    ("l1", 4, 24, 0.4), ("l1", 128, 512, 0.25), ("l2_sq", 0, 40, 0.3),
    ("l1", 128, 100, 0.5), ("l1", 4, 24, 0.999), ("l1", 0, 40, 1.0)])
def test_column_plan_from_scores_matches_jax(scores_kind, method, block, n, budget):
    """Marginals, keep count and 1/p scales agree with JAX for the same
    carried scores, on the block and the per-column branch (and a width the
    block does not divide); all-zero scores take the uniform guard."""
    r = np.random.default_rng(4)
    scores = (np.zeros(n) if scores_kind == "zeros"
              else r.uniform(0.0, 3.0, size=n) ** 3).astype(np.float32)
    kw = dict(method=method, budget=budget, backend="compact", block=block)
    for want_compact in (True, False):
        plan = sketching.column_plan_from_scores(SketchConfig(**kw), _t(scores),
                                                 rng.generator(0, "cpu"),
                                                 want_compact=want_compact)
        jplan = jsk.column_plan_from_scores(jsk.SketchConfig(**kw), jnp.asarray(scores),
                                            jax.random.key(0), want_compact=want_compact)
        np.testing.assert_allclose(plan.probs.numpy(), np.asarray(jplan.probs), rtol=RTOL,
                                   atol=1e-6)
        assert plan.indices.shape == jplan.indices.shape
        kept = plan.indices.numpy()
        assert len(np.unique(kept)) == len(kept) and np.all(np.diff(kept) > 0)
        eff = sketching.effective_cfg(SketchConfig(**kw), n)
        p_unit = plan.probs.numpy()[::eff.block] if eff.block > 1 else plan.probs.numpy()
        np.testing.assert_allclose(plan.scales.numpy(), 1.0 / p_unit[kept], rtol=RTOL)
        if not want_compact:
            assert plan.gate.shape == (n,) and int((plan.gate > 0).sum()) == \
                int((np.asarray(jplan.gate) > 0).sum())
    if scores_kind == "zeros":
        assert np.allclose(plan.probs.numpy(), plan.probs.numpy()[0])


def test_column_plan_from_scores_requires_exact_r():
    cfg = SketchConfig(method="l1", budget=0.5, backend="mask", exact_r=False)
    with pytest.raises(ValueError, match="exact_r"):
        sketching.column_plan_from_scores(cfg, torch.ones(8), rng.generator(0, "cpu"))


# ---------------------------------------------------------------------------
# The one-pass backward given JAX's plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["onepass", "stale"])
@pytest.mark.parametrize("method,block,n,budget", [
    ("l1", 128, 512, 0.25), ("l1", 128, 384, 0.7), ("l2", 0, 40, 0.3),
    ("l1", 128, 100, 0.5), ("l2_sq", 4, 24, 0.4)])
def test_one_pass_given_jax_plan_matches_jax(backend, method, block, n, budget):
    r = np.random.default_rng(1)
    G = (r.normal(size=(64, n)) * r.uniform(0.2, 2.0, size=n)).astype(np.float32)
    W = (r.normal(size=(n, 48)) / np.sqrt(48)).astype(np.float32)
    X = r.normal(size=(64, 48)).astype(np.float32)
    state = r.uniform(0.5, 4.0, size=n).astype(np.float32)
    kw = dict(method=method, budget=budget, backend=backend, block=block)
    jcfg = jsk.effective_cfg(jsk.SketchConfig(**kw), n)
    jplan = jsk.column_plan_from_scores(jcfg, jnp.asarray(state), jax.random.key(3))
    jest = {"onepass": jsl._OnePassEstimator, "stale": jsl._StalePlanEstimator}[backend]()
    want = jest._one_pass(jcfg, jnp.asarray(G), jplan, jnp.asarray(W), jnp.asarray(X),
                          jnp.asarray(state))
    cfg = sketching.effective_cfg(SketchConfig(**kw), n)
    plan = ColumnPlan(indices=_t(jplan.indices).long(), scales=_t(jplan.scales), gate=None,
                      probs=_t(jplan.probs))
    st = _t(state)
    got = estimators.get_estimator(backend)._one_pass(cfg, _t(G), plan, _t(W), _t(X), st)
    np.testing.assert_allclose(got.dx.numpy(), np.asarray(want.dx), rtol=RTOL, atol=MM_ATOL)
    np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows), rtol=RTOL,
                               atol=MM_ATOL)
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    np.testing.assert_allclose(got.db_c.numpy(), np.asarray(want.db_c), rtol=RTOL,
                               atol=MM_ATOL)
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state), rtol=RTOL,
                               atol=1e-6 * float(np.abs(want.state).max()))
    np.testing.assert_array_equal(st.numpy(), state)  # the carry passed in is untouched


def test_plan_carry_validation_matches_jax():
    """Methods without a kernel column reduction are refused by both."""
    for kw in (dict(method="ds", backend="onepass"), dict(method="gsv", backend="stale"),
               dict(method="per_sample", backend="onepass"),
               dict(method="l1", backend="stale", exact_r=False)):
        with pytest.raises(ValueError):
            jsk.SketchConfig(**kw)
        with pytest.raises(ValueError):
            SketchConfig(**kw)
    SketchConfig(method="l2_sq", backend="onepass")


def test_onepass_full_refresh_stale_partial_refresh():
    """``onepass`` returns every column's fresh score; ``stale`` refreshes only
    the kept columns and carries the rest through unchanged."""
    r = np.random.default_rng(2)
    G = _t(r.normal(size=(N, DOUT)).astype(np.float32))
    X = _t(r.normal(size=(N, DIN)).astype(np.float32))
    w = _t(r.normal(size=(DOUT, DIN)).astype(np.float32))
    carry = torch.full((DOUT,), 7.0)
    want_fresh = G.abs().sum(0).numpy()

    def cfg(be):
        return SketchConfig(method="l1", budget=0.4, backend=be, block=4)

    out1 = estimators.get_estimator("onepass").apply_with_state(
        cfg("onepass"), G, X, w, rng.generator(3, "cpu"), carry, has_b=True)
    np.testing.assert_allclose(out1.state.numpy(), want_fresh, rtol=RTOL, atol=1e-6)
    out2 = estimators.get_estimator("stale").apply_with_state(
        cfg("stale"), G, X, w, rng.generator(3, "cpu"), carry, has_b=True)
    s2 = out2.state.numpy()
    kept = np.zeros(DOUT, bool)
    kept[out2.cols.numpy()] = True
    np.testing.assert_allclose(s2[kept], want_fresh[kept], rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(s2[~kept], np.full((~kept).sum(), 7.0))
    assert not kept.all(), "budget 0.4 must drop some blocks for this test"
    assert torch.equal(carry, torch.full((DOUT,), 7.0))  # refreshed out of place


@pytest.mark.parametrize("backend,stale_carry", [
    ("onepass", False), ("onepass", True), ("stale", False), ("stale", True)])
def test_mc_unbiased_under_any_carry(backend, stale_carry):
    """The mean over generators of the site's backward is the exact gradient,
    for the uniform prior and for a deliberately wrong non-uniform carry."""
    cfg = SketchConfig(method="l1", budget=0.5, backend=backend, block=4)
    r = np.random.default_rng(5)
    x = _t(r.normal(size=(N, DIN)).astype(np.float32)).requires_grad_(True)
    w = _t((r.normal(size=(DOUT, DIN)) / np.sqrt(DIN)).astype(np.float32)).requires_grad_(True)
    b = _t((0.1 * r.normal(size=DOUT)).astype(np.float32)).requires_grad_(True)
    g_out = _t(r.normal(size=(N, DOUT)).astype(np.float32))
    carry = torch.linspace(3.0, 0.2, DOUT) if stale_carry else None
    exact = (g_out @ w.detach(), g_out.T @ x.detach(), g_out.sum(0))
    draws = [[], [], []]
    for i in range(600):
        y = sketched_linear.sketched_linear(x, w, b, key=rng.generator(i, "cpu"), cfg=cfg,
                                            plan_state=carry)
        for acc, gr in zip(draws, torch.autograd.grad(y, (x, w, b), g_out)):
            acc.append(gr.numpy())
    for got, want in zip(draws, exact):
        got, want = np.stack(got), want.numpy()
        mean, std = got.mean(0), got.std(0)
        scale = np.max(np.abs(want)) + 1e-9
        det = std < 1e-6 * scale
        np.testing.assert_allclose(mean[det], want[det], rtol=1e-3, atol=1e-4 * scale)
        if det.all():
            continue
        se = std[~det] / np.sqrt(len(got)) + 1e-3 * scale
        t = np.abs(mean[~det] - want[~det]) / se
        assert np.mean(t) < 2.2, f"{backend} stale={stale_carry}: mean|t|={np.mean(t)}"
        assert np.percentile(t, 95) < 5.0


def test_site_returns_refreshed_scores_as_carry_gradient():
    """Through the autograd Function: the carry input's gradient is the
    refreshed carry, the forward leaves the carry unchanged, and a site
    whose carry does not require grad still runs."""
    r = np.random.default_rng(6)
    x = _t(r.normal(size=(N, DIN)).astype(np.float32)).requires_grad_(True)
    w = _t(r.normal(size=(DOUT, DIN)).astype(np.float32)).requires_grad_(True)
    g_out = _t(r.normal(size=(N, DOUT)).astype(np.float32))
    carry = torch.full((DOUT,), 2.0, requires_grad=True)
    cfg = SketchConfig(method="l1", budget=0.999, backend="onepass", block=4)
    y = sketched_linear.sketched_linear(x, w, key=rng.generator(0, "cpu"), cfg=cfg,
                                        plan_state=carry)
    assert torch.equal(carry.detach(), torch.full((DOUT,), 2.0))
    gx, gw, gs = torch.autograd.grad(y, (x, w, carry), g_out)
    np.testing.assert_allclose(gs.numpy(), g_out.abs().sum(0).numpy(), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), (g_out.T @ x.detach()).numpy(), rtol=RTOL,
                               atol=MM_ATOL)
    y = sketched_linear.sketched_linear(x, w, key=rng.generator(0, "cpu"), cfg=cfg,
                                        plan_state=carry.detach())
    assert torch.autograd.grad(y, w, g_out)[0].shape == w.shape


# ---------------------------------------------------------------------------
# Transport: seeding, collection, write-back
# ---------------------------------------------------------------------------


def test_collect_write_roundtrip():
    params = {"layers": [{"w": torch.zeros(4, 4), "sslot": torch.full((4,), 2.0)}],
              "embed": torch.zeros(3, 3)}
    grads = {"layers": [{"w": torch.ones(4, 4), "sslot": torch.tensor([1., 2., 3., 4.])}],
             "embed": torch.ones(3, 3)}
    clean, fresh = plan_state.collect_plan_state(grads)
    assert torch.equal(clean["layers"][0]["sslot"], torch.zeros(4))
    assert torch.equal(clean["layers"][0]["w"], torch.ones(4, 4))
    assert list(fresh) == ["layers/0/sslot"]
    leaf = params["layers"][0]["sslot"]
    out = plan_state.write_plan_state(params, fresh)
    assert out is params and out["layers"][0]["sslot"] is leaf  # written in place
    assert torch.equal(leaf, torch.tensor([1., 2., 3., 4.]))
    assert torch.equal(out["embed"], torch.zeros(3, 3))
    assert plan_state.write_plan_state(params, {}) is params


def test_policy_carry_gates_match_jax():
    for pkg, mod in (("jax", jpstate), ("torch", plan_state)):
        assert not mod.policy_uses_carry(None)
        assert not mod.policy_uses_carry(_policy(pkg, "pallas"))
        assert mod.policy_uses_carry(_policy(pkg, "onepass"))
        assert mod.policy_uses_carry(_policy(pkg, "stale"))
        pol = (JSketchPolicy if pkg == "jax" else SketchPolicy)(
            base=_cfg(pkg, method="l1", budget=0.4),
            overrides={"mlp_in": _cfg(pkg, method="l1", budget=0.4, backend="stale",
                                      block=4)})
        assert mod.policy_uses_carry(pol)
        assert not mod.plan_carry_capable(_cfg(pkg, method="l1", budget=1.0,
                                               backend="onepass"))


@pytest.mark.parametrize("backend", ["onepass", "stale"])
def test_runtime_init_state_seeds_the_carry(backend):
    """``Runtime.init_state`` gives every sketched site a ones carry of its
    output width, and nothing else; JAX seeds the same sites."""
    cfg = ArchConfig(**TINY)
    opt = adamw(1e-3)
    state = Runtime(policy=_policy("torch", backend, block=32),
                    device="cpu").init_state(0, cfg, opt)
    slots = _sslots(state.params)
    assert len(slots) == 7 * cfg.n_layers
    for path, v in slots.items():
        site = path.split("/")[-3:-1]
        w = state.params["layers"][int(path.split("/")[1])][site[0]][site[1]]["w"]
        assert v.shape == (w.shape[0],) and torch.equal(v.detach(), torch.ones_like(v))
        assert v.dtype == torch.float32 and v.requires_grad
    jstate = jinit_state(jax.random.key(0), JArchConfig(**TINY), jsgd(0.1),
                         _policy("jax", backend, block=32))
    jtree = params_from_jax(jax.device_get(jstate.params), cfg, device="cpu")
    assert sorted(_sslots(jtree)) == sorted(slots)
    for pol in (None, _policy("torch", "pallas", block=32),
                SketchPolicy(base=SketchConfig(method="l1", budget=0.4, backend=backend,
                                               block=32), location="first")):
        state = Runtime(policy=pol, device="cpu").init_state(0, cfg, opt)
        assert _sslots(state.params) == {}


@pytest.mark.parametrize("backend", ["onepass", "stale"])
def test_one_sgd_step_matches_jax(backend):
    """A 2-layer LM at budget 0.999 (every block kept, scale 1): one SGD step
    from JAX's ``init_state`` with the carry policy gives JAX's weights and
    every refreshed carry."""
    jcfg, cfg = JArchConfig(**TINY), ArchConfig(**TINY)
    jpol, pol = _policy("jax", backend, 0.999, 32), _policy("torch", backend, 0.999, 32)
    jopt, opt = jsgd(0.5), sgd(0.5)
    batch = _batch(TINY["vocab"])
    jstate = jinit_state(jax.random.key(0), jcfg, jopt, jpol)
    params = params_from_jax(jax.device_get(jstate.params), cfg, device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, jopt, jpol, execution=JExecutionConfig()))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(1))
    runtime = Runtime(policy=pol, device="cpu")
    state = runtime.init_state(0, cfg, opt, params=params)
    assert len(_sslots(state.params)) == 7 * cfg.n_layers
    state, m = runtime.train_step(cfg, opt)(state, batch, 1)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL, abs=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    want = params_from_jax(jax.device_get(jstate.params), cfg, device="cpu")
    got_slots, want_slots = _sslots(state.params), _sslots(want)
    assert sorted(got_slots) == sorted(want_slots)
    for path, v in got_slots.items():
        w = want_slots[path].numpy()
        assert not np.allclose(w, 1.0), f"{path}: JAX's carry was not refreshed"
        np.testing.assert_allclose(v.detach().numpy(), w, rtol=RTOL,
                                   atol=1e-6 * float(np.abs(w).max()))
    got, want = _named(state.params), _named(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert len(got) == len(tree_leaves(state.params))
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=RTOL, atol=MM_ATOL)


def _named(params):
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out.append(("/".join(path), node))

    walk(params, ())
    return out


@pytest.mark.parametrize("backend", ["onepass", "stale"])
def test_train_steps_refresh_and_write_back_the_carry(backend):
    """After a step, ``onepass`` has refreshed every column and ``stale``
    only the kept ones (some still hold the prior); the carry keeps moving
    on the next step; a forward alone leaves it unchanged."""
    cfg = ArchConfig(**TINY)
    # block 16: every site has two or more blocks, and budget 0.4 drops some
    runtime = Runtime(policy=_policy("torch", backend, 0.4, 16), device="cpu")
    opt = sgd(0.1)
    state = runtime.init_state(0, cfg, opt)
    step = runtime.train_step(cfg, opt)
    ctx = Ctx(policy=runtime.policy, key=3, n_layers=cfg.n_layers)
    tb = {k: torch.tensor(v).long() for k, v in _batch(cfg.vocab, 2).items()}
    lm.lm_loss(state.params, tb, ctx, cfg, 3)  # forward alone
    assert all(torch.equal(v.detach(), torch.ones_like(v))
               for v in _sslots(state.params).values())
    state, m = step(state, _batch(cfg.vocab, 0), 1)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    slots1 = {p: v.detach().clone() for p, v in _sslots(state.params).items()}
    for p, v in slots1.items():
        assert torch.isfinite(v).all()
        assert not torch.equal(v, torch.ones_like(v)), f"carry at {p} was not refreshed"
        if backend == "onepass":
            assert not (v == 1.0).any(), f"onepass carry at {p} not fully refreshed"
        else:
            assert (v == 1.0).any(), f"stale carry at {p} fully refreshed"
    state, _ = step(state, _batch(cfg.vocab, 1), 2)
    assert any(not torch.equal(v.detach(), slots1[p])
               for p, v in _sslots(state.params).items())


def test_grad_norm_and_update_exclude_the_carry():
    """At budget 0.999 ``onepass`` gives the exact gradients, so its step must
    report pallas's gradient norm and make pallas's update: a carry left among
    the gradients would add sums of |G| to the norm and, through clipping,
    shrink every weight update."""
    cfg = ArchConfig(**TINY)
    out = {}
    for backend in ("pallas", "onepass"):
        runtime = Runtime(policy=_policy("torch", backend, 0.999, 32), device="cpu")
        opt = adamw(1e-2, clip=1.0)
        state = runtime.init_state(0, cfg, opt)
        state, m = runtime.train_step(cfg, opt)(state, _batch(cfg.vocab), 1)
        out[backend] = (float(m["grad_norm"]),
                        [p.detach() for path, p in _named(state.params)
                         if not path.endswith(plan_state.PLAN_SLOT)])
    assert out["onepass"][0] == pytest.approx(out["pallas"][0], rel=1e-5)
    for a, b in zip(out["onepass"][1], out["pallas"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=1e-6)
    # the JAX package's own check: same-scale norms for stale and pallas
    norms = {}
    for backend in ("pallas", "stale"):
        runtime = Runtime(policy=_policy("torch", backend, 0.4, 32), device="cpu")
        state = runtime.init_state(0, cfg, sgd(0.1))
        _, m = runtime.train_step(cfg, sgd(0.1))(state, _batch(cfg.vocab), 1)
        norms[backend] = float(m["grad_norm"])
    assert norms["stale"] < 10 * norms["pallas"]
