"""Every sketch method on a data axis of several ranks and on split
local-plan sites, on the CPU, over emulated ranks, against the JAX package
and the port's single device.

A mesh rank (data rank ``d`` of ``n_dp``, model rank ``k`` of ``n_mp``)
holds the rows ``d`` of G and X; on a column split the columns ``k`` of G
and the rows ``k`` of W, on a row split the chunk ``k`` of d_in (X's and
W's columns). The functions the mesh path runs take those offsets, so the
emulation calls them rank by rank, with each collective written out (a sum
over the data ranks, a concatenation over the model ranks):

* ``gsv``: every column shard scores the whole width from G's gathered
  columns and the data-summed Gram (``summed_column_scores``), JAX's
  ``column_scores`` within rtol 1e-4 (float32 ``eigh`` in two LAPACK
  builds), the single device's within 1e-5 of the largest score; the
  ``pallas`` backend's parts of the plan drawn from them
  (``split_backward``) are the whole call's rows bit for bit and its dX
  within 1e-5 of the largest entry (the straddling windows' two-part sums);
* ``rcs``: the plan from the data-summed ``Γ`` and the whole width's
  ``W Wᵀ`` (``rcs_plan_from``: gathered rows on a column split, the model
  sum of ``W_k W_kᵀ`` on a row split) has JAX's probabilities (atol 1e-4)
  and the single device's (atol 1e-5); each shard's Ĝ
  (``apply_rcs_directions(lo=, n_loc=)``) is the whole call's on the same
  plan within 1e-5 of the largest entry (the last product over r
  directions summed for a narrower output), and the single device's and
  JAX's Ĝ of the same directions within 1e-4 (``eigh`` of a ``Γ`` summed
  in another order moves the directions as a second LAPACK build does:
  up to 1.8e-5 of the largest entry here);
* ``per_element`` and ``per_sample``: the fold rule's draws
  (``rng.fold_generator``) over 1,600 mesh draws: the mean unbiased by the
  t-statistics of ``test_torch_variance.py``, and the summed per-entry
  variance within 10% of the analytic variance (i.i.d. masks: the law of
  the whole draw), of the single device's and of JAX's Monte Carlo;
* a toy estimator registered for the test, whose plan mixes columns: on
  the gathered weight (its ``apply`` on the whole width, each rank keeping
  its shard of dW) it is its whole-width call, where a call on one shard's
  columns is not;
* every method's yi-6b smoke step on a one-rank mesh (a layout without a
  process group: every collective of a one-rank axis is skipped) bit for
  bit the single device's.

One intra-op thread (module fixture).
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SketchConfig as JSketchConfig
from repro.core import scores as jscores
from repro.core import sketching as jsk
from repro.core import solver as jsolver
from repro_torch import rng
from repro_torch.core import estimators, sketching
from repro_torch.core.scores import column_scores, summed_column_scores
from repro_torch.core.sketched_linear import per_element, split_backward
from repro_torch.core.sketching import SketchConfig
from test_torch_distributed_compact import TOY, TopR

jsl = importlib.import_module("repro.core.sketched_linear")

N, D_IN = 32, 24
DRAWS = 1600
VAR_RTOL = 0.10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _problem(n, seed=0, N=N, d_in=D_IN):
    """G with uneven column scales (a spectrum far from degenerate), W, X."""
    r = np.random.default_rng(seed)
    G = (r.normal(size=(N, n)) * r.uniform(0.2, 2.0, size=n)).astype(np.float32)
    W = (r.normal(size=(n, d_in)) / np.sqrt(d_in)).astype(np.float32)
    X = r.normal(size=(N, d_in)).astype(np.float32)
    return G, W, X


def _rows(n_dp):
    return [slice(d * N // n_dp, (d + 1) * N // n_dp) for d in range(n_dp)]


def _chunks(width, n):
    return [slice(k * width // n, (k + 1) * width // n) for k in range(n)]


# ------------------------------------------------------------------ gsv


@pytest.mark.parametrize("n_dp,n_mp", [(1, 4), (2, 2), (2, 3)])
@pytest.mark.parametrize("method", ["gsv", "gsv_sq"])
def test_gsv_column_shards_score_the_whole_width(method, n_dp, n_mp):
    """Each emulated rank of a column split scores the whole width from
    G's columns gathered over model and the Gram summed over data: JAX's
    ``column_scores`` (rtol 1e-4, atol 1e-5 of the largest) and the port's
    single device's (1e-5 of the largest); every rank's scores the same."""
    G, _, _ = _problem(24)
    Gt = _t(G)
    grams = [Gt[rs].T @ Gt[rs] for rs in _rows(n_dp)]
    want_single = column_scores(method, Gt).numpy()
    want_jax = np.asarray(jscores.column_scores(method, jnp.asarray(G)))
    scale = np.abs(want_single).max()
    got = []
    for d, rs in enumerate(_rows(n_dp)):
        for _ in range(n_mp):
            # this rank's gathered columns are its rows' whole width
            s = summed_column_scores(method, Gt[rs], None, lambda t: sum(grams))
            got.append(s)
    for s in got:
        assert torch.equal(s, got[0])
    np.testing.assert_allclose(got[0].numpy(), want_single, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got[0].numpy(), want_jax, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("shards", [2, 3, 4, 6])
def test_gsv_pallas_plan_split_parts_are_the_whole_call(shards):
    """The ``pallas`` backend at gsv, block 4: the plan drawn over the whole
    width from the scores every rank computes; each column shard's part
    (``split_backward``, the kernels' plain versions here) gives the whole
    call's rows and db bit for bit, zeros for the other shards' rows, and
    the parts' dX summed within 1e-5 of the largest entry."""
    n = 48
    G, W, X = (_t(a) for a in _problem(n, seed=3))
    cfg = SketchConfig(method="gsv", budget=0.25, backend="pallas", block=4)
    est = estimators.get_estimator("pallas")
    plan = sketching.column_plan(cfg, G, W, rng.generator(5, "cpu"), want_compact=True)
    dX, rows, db, _ = est._kernel(cfg, G, plan.indices, plan.scales, W, X)
    cols = (plan.indices[:, None] * 4 + torch.arange(4)[None, :]).reshape(-1)
    dx_sum = torch.zeros_like(dX)
    for c in _chunks(n, shards):
        out, _ = split_backward(est, cfg, G[:, c], X, W[c], plan.indices, plan.scales,
                                lo=c.start, n=n)
        mine = (cols >= c.start) & (cols < c.stop)
        assert torch.equal(out.rows[mine], rows[mine]) and not out.rows[~mine].any()
        assert torch.equal(out.db_c[mine], db[mine]) and not out.db_c[~mine].any()
        dx_sum += out.dx
    np.testing.assert_allclose(dx_sum.numpy(), dX.numpy(), rtol=0,
                               atol=1e-5 * dX.abs().max().item())


# ------------------------------------------------------------------ rcs


def _jax_plan(G, W, budget, r):
    """JAX's direction probabilities and sampled directions, as its
    ``apply_rcs`` computes them, and its Ĝ."""
    jcfg = JSketchConfig(method="rcs", budget=budget)
    half, _ = jsk._sym_sqrt_invsqrt(jnp.asarray(G.T @ G / G.shape[0]), jcfg.ridge)
    A = half @ (jnp.asarray(W) @ jnp.asarray(W).T) @ half
    p = jsolver.optimal_probabilities(jnp.maximum(jnp.linalg.eigh(A)[0], 0.0), r)
    key = jax.random.key(7)
    idx = np.asarray(jsolver.sample_exact_r(key, p, r))
    ghat = np.asarray(jsk.apply_rcs(jcfg, jnp.asarray(G), jnp.asarray(W), key))
    return np.asarray(p), idx, ghat


@pytest.mark.parametrize("n_dp,n_mp", [(1, 4), (2, 2), (4, 2)])
@pytest.mark.parametrize("split", ["column", "row"])
def test_rcs_shards_are_the_whole_call(split, n_dp, n_mp):
    """The rcs plan of emulated ranks (``Γ``'s Gram and row count summed
    over data; ``W Wᵀ`` of W's gathered rows on a column split, summed from
    the d_in chunks on a row split): JAX's probabilities within 1e-4 and
    the single device's within 1e-5. On JAX's sampled directions each
    rank's Ĝ (its rows; on a column split its columns, from the gathered
    G) is the whole call's on the same plan within 1e-5 of the largest
    entry, the single device's and JAX's within 1e-4 of it (the module
    docstring)."""
    n, budget = 16, 0.5
    r = np.random.default_rng(1)
    G = (r.normal(size=(N, n)) * (0.9 ** np.arange(n))[None, :]).astype(np.float32)
    W = (r.normal(size=(n, D_IN)) / np.sqrt(D_IN)).astype(np.float32)
    cfg = SketchConfig(method="rcs", budget=budget)
    Gt, Wt = _t(G), _t(W)
    single = sketching.rcs_plan(cfg, Gt, Wt)
    jp, jidx, jghat = _jax_plan(G, W, budget, single.r)
    idx = torch.tensor(jidx).long()
    gamma = sum(Gt[rs].T @ Gt[rs] for rs in _rows(n_dp)) / float(N)
    wwt = (Wt @ Wt.T if split == "column"
           else sum(Wt[:, c] @ Wt[:, c].T for c in _chunks(D_IN, n_mp)))
    plan = sketching.rcs_plan_from(cfg, gamma, wwt)
    np.testing.assert_allclose(plan.probs.numpy(), single.probs.numpy(), atol=1e-5)
    np.testing.assert_allclose(plan.probs.numpy(), jp, atol=1e-4)
    whole = sketching.apply_rcs_directions(Gt, plan, idx).numpy()
    want = sketching.apply_rcs_directions(Gt, single, idx).numpy()
    got = np.zeros_like(whole)
    for rs in _rows(n_dp):
        if split == "column":
            for c in _chunks(n, n_mp):
                got[rs, c] = sketching.apply_rcs_directions(
                    Gt[rs], plan, idx, lo=c.start, n_loc=c.stop - c.start).numpy()
        else:
            got[rs] = sketching.apply_rcs_directions(Gt[rs], plan, idx).numpy()
    scale = np.abs(whole).max()
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got, jghat, rtol=0, atol=1e-4 * scale)


def test_rcs_direction_signs_cancel():
    """``eigh`` may return an eigenvector with either sign (ranks summing in
    another order, or another LAPACK): Ĝ's two factors both carry it, so
    flipping any direction's sign leaves Ĝ within 1e-6 of the largest
    entry."""
    G, W, _ = _problem(16, seed=2)
    cfg = SketchConfig(method="rcs", budget=0.5)
    plan = sketching.rcs_plan(cfg, _t(G), _t(W))
    idx = torch.arange(0, 16, 2)
    flip = torch.where(torch.arange(16) % 3 == 0, -1.0, 1.0)
    flipped = sketching.RcsPlan(U=plan.U * flip[None, :], probs=plan.probs, half=plan.half,
                                inv_half=plan.inv_half, r=plan.r)
    a = sketching.apply_rcs_directions(_t(G), plan, idx)
    b = sketching.apply_rcs_directions(_t(G), flipped, idx)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                               atol=1e-6 * a.abs().max().item())


# ------------------------------------------------- per_element, per_sample


def _mesh_draw(method, split, G, X, W, budget, seed, n_dp=2, n_mp=2):
    """One draw of dX and dW on an emulated (n_dp, n_mp) mesh by the fold
    rule: the mesh path's functions called rank by rank with their folds
    (a column split: G's and W's rows ``k``, X whole; a row split: G whole,
    X's and W's d_in chunk ``k``); dX summed over model on a column split,
    dW over data."""
    cfg = SketchConfig(method=method, budget=budget)
    n = G.shape[1]
    dX, dW = torch.zeros_like(X), torch.zeros_like(W)
    for d, rs in enumerate(_rows(n_dp)):
        for k, c in enumerate(_chunks(n if split == "column" else X.shape[1], n_mp)):
            gen = rng.generator(seed, "cpu")
            if split == "column":
                Gk, Xk, Wk = G[rs, c], X[rs], W[c]
                w_folds, x_folds = (k,), (d,)
            else:
                Gk, Xk, Wk = G[rs], X[rs, c], W[:, c]
                w_folds, x_folds = (k,), (d, k)
            if method == "per_element":
                out = per_element(cfg, Gk, Xk, Wk, gen, has_b=False, w_folds=w_folds,
                                  x_folds=x_folds)
                dx, dw = out.dx, out.dw
            else:
                Ghat = Gk * sketching.row_gate(cfg, Gk.shape[0], gen, "cpu", (d,))[:, None]
                dx, dw = Ghat @ Wk, Ghat.T @ Xk
            if split == "column":
                dX[rs] += dx
                dW[c] += dw
            else:
                dX[rs, c] = dx
                dW[:, c] += dw
    return dX, dW


def _single_draw(method, G, X, W, budget, seed):
    cfg = SketchConfig(method=method, budget=budget)
    out = estimators.get_estimator("mask").apply(cfg, G, X, W, rng.generator(seed, "cpu"),
                                                 has_b=False)
    return out.dx, out.dw


def _jax_draws(method, G, X, W, budget, draws):
    cfg = JSketchConfig(method=method, budget=budget)
    est = jsl._MaskEstimator()

    def one(key):
        out = est.apply(cfg, jnp.asarray(G), jnp.asarray(X), jnp.asarray(W), key, has_b=False)
        return out.dx, out.dw

    keys = jax.random.split(jax.random.key(11), draws)
    dx, dw = jax.vmap(one)(keys)
    return np.asarray(dx), np.asarray(dw)


def _analytic_var(method, G, X, W, p):
    """Per-entry variance of dX and dW under i.i.d. Bernoulli(p) draws."""
    G, X, W = (a.astype(np.float64) for a in (G, X, W))
    f = (1 - p) / p
    if method == "per_element":
        return f * (G ** 2) @ (W ** 2), f * (G ** 2).T @ (X ** 2)
    return f * (G @ W) ** 2, f * (G ** 2).T @ (X ** 2)


def _assert_unbiased(draws, want):
    """test_torch_variance.py's t-statistics of mean - exact."""
    scale = np.abs(want).max() + 1e-9
    se = draws.std(0) / np.sqrt(len(draws)) + 1e-3 * scale
    t = np.abs(draws.mean(0) - want) / se
    assert np.mean(t) < 1.5 and np.percentile(t, 95) < 4.0, (np.mean(t), np.percentile(t, 95))


@pytest.mark.parametrize("split", ["column", "row"])
@pytest.mark.parametrize("method", ["per_element", "per_sample"])
def test_fold_rule_draws_keep_the_single_device_law(method, split):
    """1,600 mesh draws on an emulated (2, 2) mesh: the mean of dX and dW
    unbiased; each one's summed per-entry variance within 10% of the
    analytic variance, of 1,600 single-device draws' and of 1,600 JAX draws'
    (the same law: i.i.d. masks drawn in independent blocks)."""
    budget = 0.5
    G, W, X = _problem(8, seed=4, N=16, d_in=6)
    Gt, Xt, Wt = _t(G), _t(X), _t(W)
    exact = (G.astype(np.float64) @ W, G.astype(np.float64).T @ X)
    mesh = [_mesh_draw(method, split, Gt, Xt, Wt, budget, s) for s in range(DRAWS)]
    single = [_single_draw(method, Gt, Xt, Wt, budget, s) for s in range(DRAWS)]
    jdx, jdw = _jax_draws(method, G, X, W, budget, DRAWS)
    want_var = _analytic_var(method, G, X, W, budget)
    for j, name in enumerate(("dX", "dW")):
        m = np.stack([d[j].numpy() for d in mesh]).astype(np.float64)
        s = np.stack([d[j].numpy() for d in single]).astype(np.float64)
        jx = (jdx, jdw)[j].astype(np.float64)
        _assert_unbiased(m, exact[j])
        total = m.var(0).sum()
        for ref, label in ((want_var[j].sum(), "analytic"), (s.var(0).sum(), "single device"),
                           (jx.var(0).sum(), "JAX")):
            assert abs(total / ref - 1.0) < VAR_RTOL, (name, label, total, ref)


@pytest.mark.parametrize("method", ["per_element", "per_sample"])
def test_fold_rule_shares_replicated_draws_and_folds_sharded_ones(method):
    """On a column split of an emulated (2, 2) mesh: ``per_element``'s W mask
    is the same on the data ranks of one model rank and differs between
    model ranks, its X mask the same on the model ranks of one data rank
    and different between data ranks; ``per_sample``'s row gate is shared
    by the model ranks and folded by the data rank. With no fold the draws
    are the single device's, bit for bit."""
    cfg = SketchConfig(method=method, budget=0.5)
    seed = 9

    def draw(tag, folds, shape):
        return torch.bernoulli(torch.full(shape, 0.5),
                               generator=rng.fold_generator(rng.generator(seed, "cpu"), tag,
                                                            folds))

    if method == "per_element":
        mw = {(d, k): draw(sketching.TAG_MASK_W, (k,), (4, 6)) for d in (0, 1) for k in (0, 1)}
        mx = {(d, k): draw(sketching.TAG_MASK_X, (d,), (8, 6)) for d in (0, 1) for k in (0, 1)}
        assert torch.equal(mw[0, 0], mw[1, 0]) and not torch.equal(mw[0, 0], mw[0, 1])
        assert torch.equal(mx[0, 0], mx[0, 1]) and not torch.equal(mx[0, 0], mx[1, 0])
        G, W, X = (_t(a) for a in _problem(8, N=8, d_in=6))
        gen = rng.generator(seed, "cpu")
        a = per_element(cfg, G, X, W, gen, has_b=False)
        b = estimators.get_estimator("mask").apply(cfg, G, X, W, rng.generator(seed, "cpu"),
                                                   has_b=False)
        assert torch.equal(a.dx, b.dx) and torch.equal(a.dw, b.dw)
    else:
        z = {(d, k): sketching.row_gate(cfg, 8, rng.generator(seed, "cpu"), "cpu", (d,))
             for d in (0, 1) for k in (0, 1)}
        assert torch.equal(z[0, 0], z[0, 1]) and not torch.equal(z[0, 0], z[1, 0])
        one = sketching.row_gate(cfg, 8, rng.generator(seed, "cpu"), "cpu")
        want = torch.bernoulli(torch.full((8,), 0.5), generator=rng.generator(seed, "cpu")) / 0.5
        assert torch.equal(one, want)


# ------------------------------------------------ a registered estimator


@pytest.fixture(scope="module")
def toy():
    """The gloo tests' registered backend: the r columns of largest l1 score
    over the whole width (a plan that mixes columns: a shard alone keeps its
    own top columns, not the whole width's)."""
    if TOY not in estimators.registered_backends():
        estimators.register_estimator(TopR())
    return estimators.get_estimator(TOY)


@pytest.mark.parametrize("split", ["column", "row"])
@pytest.mark.parametrize("n_mp", [2, 4])
def test_registered_estimator_gathered_route_is_its_whole_call(toy, split, n_mp):
    """A registered backend on a site that a split would shard
    (``nn.common.Ctx.split_kind`` keeps it on the gathered weight): each
    model rank runs the estimator on the whole width from the weight's
    shards gathered (its rows on a column split, its columns of d_in on a
    row split) and the whole input, and keeps its shard of dW (the gathered
    weight's backward); every rank's dX is the whole (its input is
    replicated over model). Put together they are the whole call's bit for
    bit; the estimator on one shard alone keeps other columns."""
    cfg = SketchConfig(method="l1", budget=0.25, backend=TOY)
    G, W, X = (_t(a) for a in _problem(16, seed=6))
    whole = toy.apply(cfg, G, X, W, None, has_b=False)
    dW = torch.zeros_like(whole.dw)
    column = split == "column"
    cuts = _chunks(16 if column else D_IN, n_mp)
    Ww = torch.cat([W[c] for c in cuts], 0) if column else torch.cat([W[:, c] for c in cuts], 1)
    for c in cuts:
        out = toy.apply(cfg, G, X, Ww, None, has_b=False)
        if column:
            dW[c] = out.dw[c]
        else:
            dW[:, c] = out.dw[:, c]
        assert torch.equal(out.dx, whole.dx)
    assert torch.equal(dW, whole.dw)
    if column:
        alone = toy.apply(cfg, G[:, cuts[0]], X, W[cuts[0]], None, has_b=False)
        assert not torch.equal(alone.dw, whole.dw[cuts[0]])


@pytest.mark.parametrize("kind", ["gsv", "rcs", "per_element", "per_sample", "toy"])
def test_one_rank_mesh_step_is_the_single_device_step(toy, kind):
    """One SGD step of yi-6b smoke under each method (mask; the toy
    backend) on a (1, 1) mesh is the single device's step bit for bit: the
    loss and every parameter (no axis has two ranks, so every draw is the
    site generator's, every score and Gram unsummed)."""
    from repro_torch.api import ExecutionConfig, SketchPolicy
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import lm
    from repro_torch.optim import sgd
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = smoke_config("yi_6b")
    method, backend = ("l1", TOY) if kind == "toy" else (kind, "mask")
    pol = SketchPolicy(base=SketchConfig(method=method, budget=0.5, backend=backend))
    r = np.random.default_rng(8)
    tokens = torch.tensor(r.integers(0, cfg.vocab, (4, 16)))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    mesh = meshlib.layout((1, 1), ("data", "model"))
    mesh.device_mesh, mesh.device = object(), torch.device("cpu")
    out = []
    for ex in (None, ExecutionConfig(mesh=mesh)):
        opt = sgd(0.1)
        st = init_state(0, cfg, opt, params=lm.init_params(3, cfg, device="cpu"), device="cpu",
                        execution=ex)
        step = make_train_step(cfg, opt, pol, execution=ex, device="cpu")
        st, m = step(st, batch if ex is None else shard_batch(batch, mesh=mesh), 4)
        out.append((m["loss"], st.params))
    (l0, p0), (l1, p1) = out
    assert torch.equal(l0, l1)
    from repro_torch.tree import tree_leaves

    a, b = tree_leaves(p0), tree_leaves(p1)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
