"""Compact gradients of the port against the JAX package.

Ports the cases of ``tests/test_compact_grad.py``: densify and the gradient
norm, clipping, SGD / momentum SGD / AdamW dense against compact, lazy AdamW,
slot placement, the fold, and a train step with compact gradients against
the dense step. Beside them, parity with JAX: the same numpy rows, indices,
parameters and moments go through JAX's ``densify``, ``global_grad_norm``,
``sgd``, ``adamw`` and ``adamw(lazy=True)`` and the port's; a compact-gradient
step of the port against JAX's at budget 0.999 (every block kept).

Tolerances: the optimizer updates are elementwise float32 with the same
operations on both sides, 1e-6 relative (1e-7 absolute); a train step runs
two layers of float32 sums in other orders, rtol 2e-5 / atol 2e-6 on the
parameters, as JAX's own test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.execution import ExecutionConfig as JExecutionConfig
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import CompactGrad as JCompactGrad
from repro.core import SketchConfig as JSketchConfig
from repro.core import SketchPolicy as JSketchPolicy
from repro.core import compact_grad as jcg
from repro.optim import adamw as jadamw
from repro.optim import global_grad_norm as jglobal_grad_norm
from repro.optim import sgd as jsgd
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import compact_grad as cg
from repro_torch.core import plan_state, site
from repro_torch.core.compact_grad import CompactGrad, GradSlot
from repro_torch.data.synthetic import LMStream
from repro_torch.interop import compact_grad_from_jax, params_from_jax
from repro_torch.optim import Optimizer, adamw, clip_by_global_norm, global_grad_norm, sgd
from repro_torch.train.trainer import TrainerConfig
from repro_torch.tree import tree_leaves

OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
STEP_RTOL, STEP_ATOL = 2e-5, 2e-6
# the JAX test's arch: widths 32 (attn), 64 (mlp) and 16 (kv)
TINY = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv=2, d_ff=64,
            vocab=64, q_chunk=16, kv_chunk=16)


def _rows_idx(n=8, d=4, idx=(1, 5), seed=0):
    rows = np.random.default_rng(seed).normal(size=(len(idx), d)).astype(np.float32)
    return rows, np.asarray(idx, np.int64), (n, d)


def _port_cg(rows, idx, dense=None):
    return CompactGrad(rows=torch.tensor(rows), idx=torch.tensor(idx),
                       dense=None if dense is None else torch.tensor(dense))


def _jax_cg(rows, idx, dense=None):
    return JCompactGrad(rows=jnp.asarray(rows), idx=jnp.asarray(idx, jnp.float32),
                        dense=None if dense is None else jnp.asarray(dense))


# ---------------------------------------------------------------------------
# CompactGrad, densify, norm, clip
# ---------------------------------------------------------------------------


def test_densify_and_norm_match_dense_and_jax():
    rows, idx, (n, d) = _rows_idx()
    g = _port_cg(rows, idx)
    dense = cg.densify(g, torch.zeros(n, d))
    assert dense.shape == (n, d) and dense.dtype == torch.float32
    np.testing.assert_array_equal(dense[1].numpy(), rows[0])
    np.testing.assert_array_equal(dense[5].numpy(), rows[1])
    assert float(dense.abs().sum()) == pytest.approx(float(np.abs(rows).sum()), rel=1e-6)
    # the norm treats a CompactGrad as its densified form
    assert float(global_grad_norm({"w": g})) == pytest.approx(
        float(global_grad_norm({"w": dense})), rel=1e-6)
    # JAX, on the same numbers: densify, and the norm with a dense part
    jd = jcg.densify(_jax_cg(rows, idx), jnp.zeros((n, d)))
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jd))
    other = np.random.default_rng(3).normal(size=(3, 2)).astype(np.float32)
    got = global_grad_norm({"w": g, "b": torch.tensor(other)})
    want = jglobal_grad_norm({"w": _jax_cg(rows, idx), "b": jnp.asarray(other)})
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    # a dense part of disjoint support adds its square
    dpart = np.zeros((n, d), np.float32)
    dpart[3] = 2.0
    assert float(global_grad_norm({"w": _port_cg(rows, idx, dpart)})) == pytest.approx(
        float(jglobal_grad_norm({"w": _jax_cg(rows, idx, dpart)})), rel=1e-6)
    with pytest.raises(ValueError, match="like"):
        cg.densify(g)


def test_clip_matches_dense():
    rows, idx, (n, d) = _rows_idx()
    g = _port_cg(rows, idx)
    dense = cg.densify(g, torch.zeros(n, d))
    (c_cg,), gn_cg = clip_by_global_norm((g,), 0.1)
    (c_de,), gn_de = clip_by_global_norm((dense,), 0.1)
    assert float(gn_cg) == pytest.approx(float(gn_de), rel=1e-6)
    assert isinstance(c_cg, CompactGrad) and torch.equal(c_cg.idx, g.idx)
    np.testing.assert_allclose(cg.densify(c_cg, torch.zeros(n, d)).numpy(), c_de.numpy(),
                               rtol=1e-6)


def test_compact_grad_from_jax_turns_float_indices_into_integers():
    rows, idx, (n, d) = _rows_idx(n=10, d=3, idx=(0, 4, 9))
    jg = _jax_cg(rows, idx, np.zeros((n, d), np.float32))
    got = compact_grad_from_jax(jax.device_get(jg), device="cpu")
    assert got.idx.dtype == torch.int64 and got.idx.tolist() == [0, 4, 9]
    np.testing.assert_array_equal(cg.densify(got).numpy(), np.asarray(jcg.densify(jg)))
    with pytest.raises(ValueError, match="whole"):
        compact_grad_from_jax(JCompactGrad(rows=jnp.asarray(rows),
                                           idx=jnp.asarray([0.0, 4.5, 9.0])), device="cpu")


# ---------------------------------------------------------------------------
# Optimizers: compact against dense, and against JAX
# ---------------------------------------------------------------------------

OPTS = {"sgd": (lambda: sgd(0.1), lambda: jsgd(0.1)),
        "sgd_momentum": (lambda: sgd(0.1, momentum=0.9), lambda: jsgd(0.1, momentum=0.9)),
        "adamw": (lambda: adamw(1e-2, weight_decay=0.1), lambda: jadamw(1e-2, weight_decay=0.1)),
        "adamw_lazy": (lambda: adamw(1e-2, weight_decay=0.1, lazy=True),
                       lambda: jadamw(1e-2, weight_decay=0.1, lazy=True))}


def _params(n=16, d=8, seed=1):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adamw"])
def test_optimizer_update_dense_vs_compact(name):
    """Updating with a CompactGrad equals updating with its densified form."""
    rows, idx, _ = _rows_idx(n=16, d=8, idx=(0, 3, 9))
    g = _port_cg(rows, idx)
    p0 = _params()
    opt_c, opt_d = OPTS[name][0](), OPTS[name][0]()
    pc, pd = {"w": torch.tensor(p0)}, {"w": torch.tensor(p0)}
    st_c, st_d = opt_c.init(pc), opt_d.init(pd)
    for t in range(3):
        pc, st_c = opt_c.update({"w": g}, st_c, pc, t)
        pd, st_d = opt_d.update({"w": cg.densify(g, pd["w"])}, st_d, pd, t)
    np.testing.assert_allclose(pc["w"].numpy(), pd["w"].numpy(), rtol=OPT_RTOL, atol=OPT_ATOL)


# lazy AdamW ignores a dense part on both sides, so it runs without one
@pytest.mark.parametrize("name,with_dense", [
    ("sgd", False), ("sgd", True), ("sgd_momentum", False), ("sgd_momentum", True),
    ("adamw", False), ("adamw", True), ("adamw_lazy", False)])
def test_optimizers_match_jax_on_compact_grads(name, with_dense):
    """The same rows, indices, parameters and (nonzero) moments through JAX's
    optimizer and the port's, three steps, with a 1-D dense leaf beside the
    compact one; with a dense part of disjoint support where asked."""
    rows, idx, (n, d) = _rows_idx(n=16, d=8, idx=(0, 3, 9), seed=4)
    dpart = None
    if with_dense:
        dpart = np.zeros((n, d), np.float32)
        dpart[[1, 5]] = np.random.default_rng(6).normal(size=(2, d)).astype(np.float32)
    bias_g = np.random.default_rng(7).normal(size=(d,)).astype(np.float32)
    p0, b0 = _params(), np.random.default_rng(8).normal(size=(d,)).astype(np.float32)
    rng = np.random.default_rng(9)
    m0 = rng.normal(size=(n, d)).astype(np.float32)
    v0 = rng.uniform(0.1, 1.0, size=(n, d)).astype(np.float32)
    mb0, vb0 = np.full((d,), 0.5, np.float32), np.full((d,), 0.25, np.float32)

    opt, jopt = OPTS[name][0](), OPTS[name][1]()
    params = {"b": torch.tensor(b0), "w": torch.tensor(p0)}
    jparams = {"b": jnp.asarray(b0), "w": jnp.asarray(p0)}
    st, jst = opt.init(params), jopt.init(jparams)
    if "m" in st:
        st["m"]["w"].copy_(torch.tensor(m0))
        st["m"]["b"].copy_(torch.tensor(mb0))
        jst = dict(jst, m={"b": jnp.asarray(mb0), "w": jnp.asarray(m0)})
    if "v" in st:
        st["v"]["w"].copy_(torch.tensor(v0))
        st["v"]["b"].copy_(torch.tensor(vb0))
        jst = dict(jst, v={"b": jnp.asarray(vb0), "w": jnp.asarray(v0)})
    grads = {"b": torch.tensor(bias_g), "w": _port_cg(rows, idx, dpart)}
    jgrads = {"b": jnp.asarray(bias_g), "w": _jax_cg(rows, idx, dpart)}
    for t in range(3):
        params, st = opt.update(grads, st, params, t)
        jparams, jst = jopt.update(jgrads, jst, jparams, jnp.asarray(t))
    for k in ("w", "b"):
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), rtol=OPT_RTOL,
                                   atol=OPT_ATOL)
    for mom in ("m", "v"):
        if mom in st:
            np.testing.assert_allclose(st[mom]["w"].numpy(), np.asarray(jst[mom]["w"]),
                                       rtol=OPT_RTOL, atol=OPT_ATOL)


def test_adamw_lazy_decay_semantics():
    """lazy=True: kept rows get the standard AdamW update; the other rows
    keep their parameters AND moments (no decay)."""
    rows, idx, _ = _rows_idx(n=10, d=4, idx=(2, 7))
    g = _port_cg(rows, idx)
    params = {"w": torch.ones(10, 4)}
    opt = adamw(1e-2, weight_decay=0.1, lazy=True)
    st = {"m": {"w": torch.full((10, 4), 0.5)}, "v": {"w": torch.full((10, 4), 0.25)}}
    ref_st = {k: {"w": v["w"].clone()} for k, v in st.items()}
    new_p, new_st = opt.update({"w": g}, st, {"w": params["w"].clone()}, 3)
    untouched = [i for i in range(10) if i not in (2, 7)]
    assert torch.equal(new_p["w"][untouched], params["w"][untouched])
    assert torch.equal(new_st["m"]["w"][untouched], ref_st["m"]["w"][untouched])
    assert torch.equal(new_st["v"]["w"][untouched], ref_st["v"]["w"][untouched])
    # kept rows match the dense update restricted to them
    pd, std = adamw(1e-2, weight_decay=0.1).update(
        {"w": cg.densify(g, params["w"])}, ref_st, {"w": params["w"].clone()}, 3)
    for i in (2, 7):
        np.testing.assert_allclose(new_p["w"][i].numpy(), pd["w"][i].numpy(), rtol=OPT_RTOL)
        np.testing.assert_allclose(new_st["v"]["w"][i].numpy(), std["v"]["w"][i].numpy(),
                                   rtol=OPT_RTOL)


# ---------------------------------------------------------------------------
# Slots: placement, the site, the fold
# ---------------------------------------------------------------------------


def _compact_policy(pkg="torch", backend="compact", block=0, budget=0.5, **kw):
    mk_cfg, mk_pol = ((JSketchConfig, JSketchPolicy) if pkg == "jax"
                      else (SketchConfig, SketchPolicy))
    return mk_pol(base=mk_cfg(method="l1", budget=budget, backend=backend, block=block), **kw)


def test_with_grad_slots_places_and_sizes_slots():
    from repro_torch.models import lm

    cfg = ArchConfig(**TINY)
    params = lm.init_params(0, cfg, device="cpu")
    pol = _compact_policy()
    aug = cg.with_grad_slots(params, pol, n_layers=cfg.n_layers)
    for layer, orig in zip(aug["layers"], params["layers"]):
        for group, names in (("attn", "qkvo"), ("mlp", ("in", "gate", "out"))):
            for name in names:
                site_p = layer[group][name]
                slot = site_p[cg.GRAD_SLOT]
                assert isinstance(slot, GradSlot) and slot.rows is None
                assert slot.r == cg.compact_rank(pol.base, site_p["w"].shape[0])
                assert site_p["w"] is orig[group][name]["w"]  # the same tensors
                assert cg.GRAD_SLOT not in orig[group][name]
    # r = budget * d_ff at mlp in, as JAX's slot
    from repro.models import lm as jlm

    jparams = jax.device_get(jlm.init_params(jax.random.key(0), JArchConfig(**TINY)))
    jaug = jcg.with_grad_slots(jparams, _compact_policy("jax"), n_layers=2)
    jrows = jaug["segments"][0][0]["mlp"]["in"]["gslot"].rows.shape
    assert jrows == (2, aug["layers"][0]["mlp"]["in"][cg.GRAD_SLOT].r, cfg.d_model)
    # the head and the embedding get none; a mask policy gives none at all
    assert "lm_head" not in aug or cg.GRAD_SLOT not in aug["lm_head"]
    mask_aug = cg.with_grad_slots(params, SketchPolicy(base=SketchConfig(method="l1",
                                                                          budget=0.5)))
    assert not any(isinstance(x, GradSlot) for x in tree_leaves(mask_aug))
    # every compact-capable backend resolves to compact rows
    for backend in ("compact", "pallas", "onepass", "stale"):
        spec = site.resolve_site("mlp_in", SketchConfig(method="l1", budget=0.5,
                                                        backend=backend, block=16),
                                 d_out=64, d_in=32)
        assert spec.compact_rows == 32
        assert (spec.carry_rows is not None) == (backend in ("onepass", "stale"))
    assert site.resolve_site("mlp_in", SketchConfig(method="l1", budget=0.5),
                             d_out=64, d_in=32).compact_rows is None


def test_no_slots_for_location_or_shared_sites():
    """Location policies (per-layer configs) keep the dense path; a weight
    under a ``"shared"`` subtree (applied more than once per step) gets no
    slot, as in JAX."""
    from repro_torch.models import lm

    cfg = ArchConfig(**TINY)
    params = lm.init_params(0, cfg, device="cpu")
    for loc in ("first", "last"):
        assert cg.with_grad_slots(params, _compact_policy(location=loc), n_layers=2) is params
    tree = {"shared": {"attn": {"q": {"w": torch.zeros(8, 4)}}},
            "block": {"attn": {"q": {"w": torch.zeros(8, 4)}}}}
    aug = cg.with_grad_slots(tree, _compact_policy())
    assert cg.GRAD_SLOT not in aug["shared"]["attn"]["q"]
    assert isinstance(aug["block"]["attn"]["q"][cg.GRAD_SLOT], GradSlot)


def test_fold_slot_grads_roundtrip():
    slot = GradSlot(2)
    slot.put(torch.ones(2, 3), torch.tensor([0, 2]))
    g = {"site": {"w": None, cg.GRAD_SLOT: slot}, "other": {"w": torch.ones(2, 2)}}
    folded = cg.fold_slot_grads(g)
    assert isinstance(folded["site"]["w"], CompactGrad) and folded["site"]["w"].dense is None
    assert cg.GRAD_SLOT not in folded["site"]
    assert torch.equal(folded["other"]["w"], torch.ones(2, 2))
    want = torch.zeros(4, 3).index_add_(0, torch.tensor([0, 2]), torch.ones(2, 3))
    assert torch.equal(cg.densify(folded["site"]["w"], torch.zeros(4, 3)), want)
    with pytest.raises(RuntimeError, match="not filled"):
        cg.fold_slot_grads({"site": {"w": None, cg.GRAD_SLOT: GradSlot(2)}})


@pytest.mark.parametrize("backend,block", [("compact", 0), ("pallas", 4), ("stale", 4)])
def test_site_with_a_slot_gives_w_no_gradient(backend, block):
    """With a slot, the site's backward fills it and returns None for ``w``
    (autograd.grad then reports ``w`` unused); dX and db match the dense
    path's, and the slot's rows scattered are the dense path's dW. A slot
    filled twice, or resolved for another rank, raises."""
    from repro_torch import rng
    from repro_torch.core import linear

    scfg = SketchConfig(method="l1", budget=0.5, backend=backend, block=block)
    g = np.random.default_rng(0)
    x = torch.tensor(g.normal(size=(2, 8, 16)).astype(np.float32), requires_grad=True)
    w = torch.tensor(g.normal(size=(32, 16)).astype(np.float32), requires_grad=True)
    b = torch.zeros(32, requires_grad=True)
    gy = torch.tensor(g.normal(size=(2, 8, 32)).astype(np.float32))
    sslot = torch.ones(32, requires_grad=True) if backend == "stale" else None
    r = cg.compact_rank(scfg, 32)

    def run(slot):
        y = linear(x, w, b, key=rng.generator(5, "cpu"), cfg=scfg,
                                   plan_state=sslot, grad_slot=slot)
        return torch.autograd.grad(y, [x, w, b], gy, allow_unused=True)

    dx_d, dw_d, db_d = run(None)
    slot = GradSlot(r)
    dx_c, dw_c, db_c = run(slot)
    assert dw_c is None and dw_d is not None
    assert slot.idx.dtype == torch.int64 and slot.rows.shape == (r, 16)
    assert torch.equal(dx_c, dx_d) and torch.equal(db_c, db_d)
    assert torch.equal(cg.densify(CompactGrad(slot.rows, slot.idx), w), dw_d)
    with pytest.raises(RuntimeError, match="twice"):
        slot.put(slot.rows, slot.idx)
    with pytest.raises(ValueError, match="resolves"):
        linear(x, w, b, key=rng.generator(5, "cpu"), cfg=scfg,
                               plan_state=sslot, grad_slot=GradSlot(r + 1))


# ---------------------------------------------------------------------------
# The train step: compact against dense, against JAX, end to end
# ---------------------------------------------------------------------------


def _batch(vocab, seed=1, B=4, S=16):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int64)
    return {"tokens": toks, "labels": toks}


class _Spy:
    """An optimizer that records the gradients it was given."""

    def __init__(self, opt):
        self.seen = []
        self.opt = Optimizer(opt.init, self._update)
        self._inner = opt

    def _update(self, grads, state, params, step):
        self.seen.append(grads)
        return self._inner.update(grads, state, params, step)


def _assert_compact_sites(grads, params):
    """Every sketched site's ``w`` gradient is a CompactGrad without a dense
    part; every other leaf a dense tensor of its parameter's shape."""
    n_compact = 0
    for layer_g in grads["layers"]:
        for group in ("attn", "mlp"):
            for site_g in layer_g[group].values():
                assert isinstance(site_g["w"], CompactGrad) and site_g["w"].dense is None
                n_compact += 1
    dense = [g for g in tree_leaves(grads) if not isinstance(g, CompactGrad)]
    assert all(isinstance(g, torch.Tensor) for g in dense)
    assert n_compact == 7 * len(params["layers"])


# (backend, block, optimizer): per-column compact with AdamW; block-granular
# compact and pallas with momentum SGD; stale (a gslot and an sslot in each
# site) with AdamW and lazy AdamW
STEP_CASES = [("compact", 0, "adamw"), ("compact", 4, "sgd"), ("pallas", 4, "sgd"),
              ("stale", 4, "adamw"), ("onepass", 4, "adamw")]


@pytest.mark.parametrize("backend,block,optname", STEP_CASES)
def test_train_step_compact_equals_dense(backend, block, optname):
    mk = {"sgd": lambda: sgd(0.1, momentum=0.9), "adamw": lambda: adamw(1e-2, clip=1.0)}[optname]
    cfg = ArchConfig(**TINY)
    policy = _compact_policy(backend=backend, block=block)
    out = {}
    for compact in (False, True):
        rt = Runtime(policy=policy, execution=ExecutionConfig(compact_grads=compact),
                     device="cpu")
        spy = _Spy(mk())
        state = rt.init_state(0, cfg, spy.opt)
        state, m = rt.train_step(cfg, spy.opt)(state, _batch(cfg.vocab), 2)
        if compact:
            _assert_compact_sites(spy.seen[0], state.params)
            assert not any(isinstance(x, GradSlot) for x in tree_leaves(state.params))
            assert not any(isinstance(x, GradSlot) for x in tree_leaves(state.opt_state))
        else:
            assert not any(isinstance(g, CompactGrad) for g in tree_leaves(spy.seen[0]))
        out[compact] = (m, state)
    (m_d, s_d), (m_c, s_c) = out[False], out[True]
    assert float(m_c["loss"]) == pytest.approx(float(m_d["loss"]), rel=1e-6)
    assert float(m_c["grad_norm"]) == pytest.approx(float(m_d["grad_norm"]), rel=1e-4)
    la, lb = tree_leaves(s_d.params), tree_leaves(s_c.params)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
    if backend in ("stale", "onepass"):
        carried = plan_state.collect_plan_state(s_c.params)[1]
        assert len(carried) == 7 * cfg.n_layers
        assert not all(torch.equal(v, torch.ones_like(v)) for v in carried.values())


@pytest.mark.parametrize("backend,optname", [("pallas", "sgd"), ("pallas", "adamw_lazy"),
                                             ("stale", "adamw")])
def test_compact_step_matches_jax(backend, optname):
    """One compact-gradient step at budget 0.999 (every block kept, scale 1)
    from JAX's ``init_state``: the port gives JAX's parameters. AdamW's first
    step is g / (|g| + eps) per element, which turns a 1e-7 relative
    difference in a gradient element near eps into a whole step; eps 1e-3
    keeps the comparison well conditioned (a gradient difference of e moves
    a parameter by at most lr e / eps). No weight decay: JAX stacks the
    layers, so its norm scales are 2-D and decay, the port's 1-D ones do not
    (the optimizer tests above hold the decay of 2-D leaves to JAX's)."""
    jcfg, cfg = JArchConfig(**TINY), ArchConfig(**TINY)
    kw = dict(eps=1e-3)
    opt, jopt = {"sgd": OPTS["sgd_momentum"],
                 "adamw": (lambda: adamw(1e-2, **kw), lambda: jadamw(1e-2, **kw)),
                 "adamw_lazy": (lambda: adamw(1e-2, lazy=True, **kw),
                                lambda: jadamw(1e-2, lazy=True, **kw))}[optname]
    opt, jopt = opt(), jopt()
    jpol = _compact_policy("jax", backend, 16, 0.999)
    pol = _compact_policy("torch", backend, 16, 0.999)
    batch = _batch(TINY["vocab"], 3)
    jstate = jinit_state(jax.random.key(0), jcfg, jopt, jpol)
    params = params_from_jax(jax.device_get(jstate.params), cfg, device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, jopt, jpol,
                                     execution=JExecutionConfig(compact_grads=True)))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(1))
    rt = Runtime(policy=pol, execution=ExecutionConfig(compact_grads=True), device="cpu")
    state = rt.init_state(0, cfg, opt, params=params)
    state, m = rt.train_step(cfg, opt)(state, batch, 1)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5, abs=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    want = params_from_jax(jax.device_get(jstate.params), cfg, device="cpu")
    for a, b in zip(tree_leaves(state.params), tree_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_runtime_train_runs_the_compact_path():
    """``Runtime(execution=ExecutionConfig(compact_grads=True)).train`` with
    lazy AdamW: finite losses and parameters, the loss falling, and no slot
    left in the state."""
    cfg = ArchConfig(**TINY)
    rt = Runtime(policy=_compact_policy(backend="pallas", block=16, budget=0.4),
                 execution=ExecutionConfig(compact_grads=True), device="cpu")
    opt = adamw(3e-2, weight_decay=0.1, clip=1.0, lazy=True)
    data = LMStream(vocab=cfg.vocab, seed=0).batches(4, 16)
    state, hist = rt.train(cfg, opt, data, TrainerConfig(steps=6, log_every=1),
                           on_metrics=lambda m: None)
    losses = [h["loss"] for h in hist]
    assert len(losses) == 6 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(torch.isfinite(p).all() for p in tree_leaves(state.params))
    assert not any(isinstance(x, GradSlot) for x in tree_leaves(state.params))


def test_compact_grads_rejects_accum():
    with pytest.raises(ValueError, match="accum"):
        ExecutionConfig(compact_grads=True, accum=2)
    with pytest.raises(ValueError, match="accum"):
        ExecutionConfig(accum=0)
    assert ExecutionConfig(accum=2).accum == 2  # dense accumulation is ported
    # JAX rejects the same configuration
    with pytest.raises(ValueError, match="accum"):
        JExecutionConfig(compact_grads=True, accum=2)
