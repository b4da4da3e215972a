"""Telemetry of repro_torch against the JAX package, recomputed in the same
process on the same numpy inputs.

* the probe math (``probe_from_rows``, ``collect_probes``, ``summarize``) on
  the same arrays: rtol 1e-5, atol 1e-7;
* the probe of every backend given JAX's plan: one site with JAX's sampled
  plan (indices, scales and marginals) fed into the port's backward, and one
  tiny-LM train step per backend in which both packages' samplers draw with
  the same fixed offset, so both run the same plan at every site from their
  own marginals: per-site vectors under JAX's keys and the step summary within
  rtol 1e-5, atol 1e-6;
* Monte Carlo: ports of JAX's ``test_variance_probe_unbiased_vs_bruteforce``
  (800 draws, rel 0.15) and ``test_variance_probe_matches_diagonal_under_exact_r``
  (rel 0.1);
* probes change no training (bit for bit), also with compact gradients;
* ``TelemetryConfig`` validation, the slot builders, the sinks (byte for
  byte JAX's files) and the cost table (JAX's numbers under JAX's keys).
"""
import dataclasses
import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionConfig as JExecutionConfig
from repro.api import SketchConfig as JSketchConfig
from repro.api import SketchPolicy as JSketchPolicy
from repro.api import TelemetryConfig as JTelemetryConfig
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import sketching as jsk
from repro.models import lm as jlm
from repro.optim import sgd as jsgd
from repro.telemetry import probes as jprobes
from repro.telemetry import sinks as jsinks
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import rng
from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy, TelemetryConfig
from repro_torch.configs.base import ArchConfig
from repro_torch.core import sketching
from repro_torch.core.sketching import ColumnPlan
from repro_torch.interop import params_from_jax
from repro_torch.optim import sgd
from repro_torch.telemetry import probes as tprobes
from repro_torch.telemetry import sinks as tsinks
from repro_torch.tree import tree_leaves


jsolver = importlib.import_module("repro.core.solver")
tsolver = importlib.import_module("repro_torch.core.solver")
tsite = importlib.import_module("repro_torch.core.site")

RTOL, ATOL = 1e-5, 1e-6
# widths that divide a block of 4: q/o 64, k/v 32, mlp 128
TINY = dict(name="lm-tiny-tel", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
            d_ff=128, vocab=128, q_chunk=16, kv_chunk=16)
B, S = 2, 16
BACKENDS = [("mask", 0), ("compact", 0), ("compact", 4), ("pallas", 4), ("onepass", 4),
            ("stale", 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: with several, the CPU's reductions (the embedding
    gradient among them) need not give the same bits on every call, which
    the bit-for-bit comparisons need; and the test processes share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _t(a):
    return torch.tensor(np.asarray(a))


def _policy(pkg, backend, block, budget=0.4):
    if pkg == "jax":
        return JSketchPolicy(base=JSketchConfig(method="l1", budget=budget, backend=backend,
                                                block=block))
    return SketchPolicy(base=SketchConfig(method="l1", budget=budget, backend=backend,
                                          block=block))


def _batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# Probe math on the same arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r,d", [(24, 16), (7, 130), (1, 5)])
def test_probe_from_rows_matches_jax(r, d):
    g = np.random.default_rng(r)
    rows = g.normal(size=(r, d)).astype(np.float32)
    probs = g.uniform(0.05, 1.0, size=r).astype(np.float32)
    got = tprobes.probe_from_rows(_t(rows), _t(probs)).numpy()
    want = np.asarray(jprobes.probe_from_rows(jnp.asarray(rows), jnp.asarray(probs)))
    assert got.shape == (tprobes.PROBE_WIDTH,) and tprobes.PROBE_FIELDS == jprobes.PROBE_FIELDS
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("per_site", [True, False])
def test_collect_and_summarize_match_jax(per_site):
    """JAX's slotted tree with random probe vectors ([n_layers, 4] per stacked
    site), unstacked into the port's per-layer tree: the port's
    ``collect_probes`` gives JAX's vectors layer by layer and its
    ``summarize`` JAX's summary under JAX's keys."""
    jcfg, cfg = JArchConfig(**TINY), ArchConfig(**TINY)
    jpol = _policy("jax", "compact", 4)
    jparams = jprobes.with_probe_slots(jlm.init_params(jax.random.key(0), jcfg), jpol,
                                       n_layers=jcfg.n_layers)
    g = np.random.default_rng(1)
    jtree = jax.tree_util.tree_map_with_path(
        lambda p, x: (g.uniform(0.0, 3.0, size=x.shape).astype(np.float32)
                      if "pslot" in jax.tree_util.keystr(p) else np.asarray(x)), jparams)
    tree = params_from_jax(jtree, cfg, device="cpu")
    clean, probes = tprobes.collect_probes(tree)
    jclean, jvecs = jprobes.collect_probes(jtree)
    assert "pslot" not in json.dumps(jax.tree_util.tree_map(lambda _: 0, clean))
    assert len(probes) == cfg.n_layers * len(jvecs) == 7 * cfg.n_layers
    for path, v in probes.items():
        _, i, rest = path.split("/", 2)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jvecs[f"segments/0/0/{rest}"])[int(i)])
    got = tprobes.summarize(probes, per_site=per_site)
    want = jprobes.summarize(jvecs, per_site=per_site)
    assert sorted(got) == sorted(want)
    for k in ("probe_gsq", "probe_var", "probe_snr", "probe_align"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=1e-7)
    if per_site:
        assert sorted(got["probe_sites"]) == sorted(want["probe_sites"])
        for k, v in got["probe_sites"].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want["probe_sites"][k]),
                                       rtol=RTOL, atol=1e-7)
    assert tprobes.summarize({}) == {} == jprobes.summarize({})


def test_site_key_maps_the_dense_stack():
    assert tprobes.site_key("layers/11/mlp/gate") == "segments/0/0/mlp/gate"
    for p in ("0", "2", "lm_head", "blocks/1/attn/q", "layers/x/attn/q"):
        assert tprobes.site_key(p) == p


# ---------------------------------------------------------------------------
# The probe of every backend given JAX's plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,block", BACKENDS)
def test_site_probe_given_jax_plan_matches_jax(monkeypatch, backend, block):
    """One site (N 48, n 32, d 20): JAX's sampled plan (from its own key) fed
    into the port's planner, then the site's backward with a probe slot: the
    slot's gradient is JAX's probe, and dX, dW are JAX's."""
    g = np.random.default_rng(5)
    x = g.normal(size=(48, 20)).astype(np.float32)
    w = (g.normal(size=(32, 20)) / np.sqrt(20)).astype(np.float32)
    gout = (g.normal(size=(48, 32)) * g.uniform(0.2, 2.0, size=32)).astype(np.float32)
    carry = g.uniform(0.5, 4.0, size=32).astype(np.float32)
    kw = dict(method="l1", budget=0.4, backend=backend, block=block)
    jcfg = JSketchConfig(**kw)
    plan_carry = backend in ("onepass", "stale")

    def jloss(w_, pslot, sslot):
        from repro.core.sketched_linear import sketched_linear as jlinear

        y = jlinear(jnp.asarray(x), w_, key=jax.random.key(7), cfg=jcfg, probe_slot=pslot,
                    plan_state=sslot)
        return jnp.sum(y * jnp.asarray(gout))

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(w), jnp.zeros(4, jnp.float32), jnp.asarray(carry) if plan_carry else None)
    ecfg = jsk.effective_cfg(jcfg, 32)
    if plan_carry:
        jplan = jsk.column_plan_from_scores(ecfg, jnp.asarray(carry), jax.random.key(7))
    else:
        jplan = jsk.column_plan(ecfg, jnp.asarray(gout), jnp.asarray(w), jax.random.key(7),
                                want_compact=backend != "mask")
    plan = ColumnPlan(indices=_t(jplan.indices).long(), scales=_t(jplan.scales),
                      gate=None if jplan.gate is None else _t(jplan.gate), probs=_t(jplan.probs))
    name = "column_plan_from_scores" if plan_carry else "column_plan"
    monkeypatch.setattr(importlib.import_module("repro_torch.core.sketched_linear"), name,
                        lambda *a, **k: plan)
    wt = _t(w).requires_grad_(True)
    pslot = torch.zeros(tprobes.PROBE_WIDTH, requires_grad=True)
    y = tsite.sketched_site(SketchConfig(**kw), _t(x), wt, gen=rng.generator(0, "cpu"),
                            sslot=_t(carry) if plan_carry else None, pslot=pslot)
    dw, probe = torch.autograd.grad((y * _t(gout)).sum(), [wt, pslot])
    np.testing.assert_allclose(dw.numpy(), np.asarray(jgrads[0]), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(probe.numpy(), np.asarray(jgrads[1]), rtol=RTOL, atol=ATOL)
    assert probe[3] == 1.0 and probe[1] > 0


def _fixed_u_samplers(monkeypatch, u=0.37):
    """Both packages' systematic sampler (Alg. 2) with the offset ``u`` fixed
    instead of drawn: each site keeps the same columns in both packages,
    chosen from that package's own marginals."""

    def jsample(key, p, r):
        n = p.shape[-1]
        cum = jnp.cumsum(p.astype(jnp.float32)).at[-1].set(jnp.float32(r))
        idx = jnp.searchsorted(cum, u + jnp.arange(r, dtype=jnp.float32), side="left")
        return jnp.clip(idx, 0, n - 1).astype(jnp.int32)

    def tsample(gen, p, r):
        n = p.shape[-1]
        cum = torch.cumsum(p.to(torch.float32), 0)
        cum[-1] = float(r)
        idx = torch.searchsorted(cum, u + torch.arange(r, dtype=torch.float32), side="left")
        return idx.clamp(0, n - 1)

    monkeypatch.setattr(jsolver, "sample_exact_r", jsample)
    monkeypatch.setattr(tsolver, "sample_exact_r", tsample)


@pytest.mark.parametrize("backend,block", BACKENDS)
def test_lm_step_probes_match_jax(monkeypatch, backend, block):
    """Two SGD steps of the tiny LM from JAX's initial state, every site at
    l1@0.4 under ``backend``, both packages on the same plans: every
    per-site probe vector (JAX's keys; the layers of a stacked JAX site
    summed) and the step summary agree with JAX's on both steps, the second
    sampling from the refreshed carry under onepass and stale."""
    _fixed_u_samplers(monkeypatch)
    jcfg, cfg = JArchConfig(**TINY), ArchConfig(**TINY)
    jpol, pol = _policy("jax", backend, block), _policy("torch", backend, block)
    jopt, opt = jsgd(0.1), sgd(0.1)
    jstate = jinit_state(jax.random.key(0), jcfg, jopt, jpol)
    params = params_from_jax(jax.device_get(jstate.params), cfg, device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, jopt, jpol, execution=JExecutionConfig(
        telemetry=JTelemetryConfig())))
    rt = Runtime(policy=pol, device="cpu", execution=ExecutionConfig(telemetry=TelemetryConfig()))
    state = rt.init_state(0, cfg, opt, params=params)
    step = rt.train_step(cfg, opt)
    for i in range(2):
        batch = _batch(cfg.vocab, i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.key(i + 1))
        state, m = step(state, batch, i + 1)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL, abs=ATOL)
        sites, jsites = m["probe_sites"], jm["probe_sites"]
        assert sorted(sites) == sorted(jsites) and len(sites) == 7
        for k, v in sites.items():
            want = np.asarray(jsites[k])
            assert want[3] == cfg.n_layers  # every layer's site probed
            np.testing.assert_allclose(v.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=k)
        for k in ("probe_gsq", "probe_var", "probe_snr", "probe_align"):
            assert math.isfinite(float(m[k]))
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# Monte Carlo: the probe against brute force
# ---------------------------------------------------------------------------


def _site(seed=0, N=32, n=24, d=16):
    g = np.random.default_rng(seed)
    x = g.normal(size=(N, d)).astype(np.float32)
    w = (g.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    gout = g.normal(size=(N, n)).astype(np.float32)
    return _t(x), _t(w), _t(gout)


def _probe_and_dw(cfg, x, w, gout, seed):
    wt = w.clone().requires_grad_(True)
    pslot = torch.zeros(tprobes.PROBE_WIDTH, requires_grad=True)
    y = tsite.sketched_site(cfg, x, wt, gen=rng.generator(seed, "cpu"), pslot=pslot)
    dw, probe = torch.autograd.grad((y * gout).sum(), [wt, pslot])
    return probe, dw


@pytest.mark.parametrize("method", ["l1", "per_column"])
def test_variance_probe_unbiased_vs_bruteforce(method):
    """Under independent gates the probe's mean over 800 draws matches the
    brute-force VJP variance E‖dŴ − dW‖² and ‖dW‖² (JAX's margin, rel 0.15)."""
    x, w, gout = _site()
    cfg = SketchConfig(method=method, budget=0.4, exact_r=False, backend="mask")
    draws = [_probe_and_dw(cfg, x, w, gout, s) for s in range(800)]
    probes = torch.stack([p for p, _ in draws]).numpy()
    dws = torch.stack([d for _, d in draws]).numpy()
    dw_exact = (gout.T @ x).numpy()
    var_mc = float(np.mean(np.sum(np.square(dws - dw_exact[None]), axis=(1, 2))))
    mean = probes.mean(0)
    assert mean[3] == pytest.approx(1.0)
    assert mean[1] == pytest.approx(var_mc, rel=0.15), (mean, var_mc)
    assert mean[0] == pytest.approx(float(np.sum(dw_exact ** 2)), rel=0.15)


def test_variance_probe_matches_diagonal_under_exact_r():
    """Correlated exact-r sampling: the probe's mean over 800 draws matches
    the diagonal variance Σ_j ((1 − p_j)/p_j)‖u_j‖² (JAX's margin, rel 0.1)."""
    x, w, gout = _site()
    cfg = SketchConfig(method="l1", budget=0.4, backend="compact")
    p = sketching.column_plan(cfg, gout, w, rng.generator(0, "cpu"),
                              want_compact=True).probs.numpy()
    u = (gout.T @ x).numpy()
    diag = float(np.sum((1.0 - p) / p * np.sum(u ** 2, axis=1)))
    probes = torch.stack([_probe_and_dw(cfg, x, w, gout, s)[0] for s in range(800)]).numpy()
    assert probes.mean(0)[1] == pytest.approx(diag, rel=0.1), (probes.mean(0)[1], diag)


# ---------------------------------------------------------------------------
# Probes change no training
# ---------------------------------------------------------------------------


# compact gradients with every compact backend (mask emits a dense dW)
@pytest.mark.parametrize("backend,block,compact",
                         [(b, k, False) for b, k in BACKENDS]
                         + [(b, k, True) for b, k in BACKENDS if b != "mask"])
def test_probes_do_not_change_training(backend, block, compact):
    """A step with probes equals the step without them bit for bit: loss,
    parameters, optimizer state and plan carry, from the same state, batch
    and seed (with compact gradients too); the probed step has a finite,
    positive summary."""
    cfg = ArchConfig(**TINY)
    pol = _policy("torch", backend, block, budget=0.3)
    out = {}
    for tel in (None, TelemetryConfig()):
        ex = ExecutionConfig(compact_grads=compact, telemetry=tel)
        rt = Runtime(policy=pol, device="cpu", execution=ex)
        opt = sgd(0.1, momentum=0.9)
        state = rt.init_state(0, cfg, opt)
        step = rt.train_step(cfg, opt)
        for i in range(2):
            state, m = step(state, _batch(cfg.vocab, i), 10 + i)
        out[tel is not None] = (state, m)
    (s0, m0), (s1, m1) = out[False], out[True]
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for a, b in zip(tree_leaves(s0.params) + tree_leaves(s0.opt_state),
                    tree_leaves(s1.params) + tree_leaves(s1.opt_state)):
        assert torch.equal(a, b)
    assert "probe_snr" not in m0
    assert float(m1["probe_var"]) > 0 and float(m1["probe_gsq"]) > 0
    assert math.isfinite(float(m1["probe_snr"]))
    tot = torch.stack(list(m1["probe_sites"].values())).sum(0)
    assert float(tot[0]) == pytest.approx(float(m1["probe_gsq"]), rel=1e-5)


def test_exact_step_emits_no_probe():
    cfg = ArchConfig(**TINY)
    rt = Runtime(device="cpu", execution=ExecutionConfig(telemetry=TelemetryConfig()))
    state = rt.init_state(0, cfg, sgd(0.1))
    _, m = rt.train_step(cfg, sgd(0.1))(state, _batch(cfg.vocab), 1)
    assert "probe_snr" not in m and "probe_sites" not in m


# ---------------------------------------------------------------------------
# Config, slot builders, sinks and the cost table
# ---------------------------------------------------------------------------


def test_telemetry_config_validation():
    with pytest.raises(ValueError, match="accum"):
        ExecutionConfig(telemetry=TelemetryConfig(), accum=2)
    with pytest.raises(ValueError, match="accum"):
        JExecutionConfig(telemetry=JTelemetryConfig(), accum=2)
    ex = ExecutionConfig(telemetry=TelemetryConfig(probes=False), accum=2)
    hash(ex)  # the telemetry config stays hashable on the execution config
    with pytest.raises(ValueError, match="interval"):
        TelemetryConfig(interval=0)
    assert dataclasses.asdict(TelemetryConfig()) == dataclasses.asdict(JTelemetryConfig())


def test_probe_slot_builders():
    """Slots at every probe-capable site (JAX's count per layer), none for a
    location policy or a non-column method; ``collect_probes`` strips them
    all; the MLP builder honours the head's exclusion and the location."""
    cfg, jcfg = ArchConfig(**TINY), JArchConfig(**TINY)
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.3))
    params = Runtime(device="cpu").init_state(0, cfg, sgd(0.1)).params
    slotted = tprobes.with_probe_slots(params, pol, n_layers=cfg.n_layers)
    n_slots = sum(tprobes.PROBE_SLOT in site for layer in slotted["layers"]
                  for grp in ("attn", "mlp") for site in layer[grp].values())
    jslotted = jprobes.with_probe_slots(jlm.init_params(jax.random.key(0), jcfg),
                                        JSketchPolicy(base=JSketchConfig(method="l1",
                                                                         budget=0.3)),
                                        n_layers=2)
    jn = sum("pslot" in jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jslotted)[0])
    assert n_slots == cfg.n_layers * jn == 14
    slot = slotted["layers"][0]["attn"]["q"][tprobes.PROBE_SLOT]
    assert slot.shape == (4,) and slot.requires_grad and not slot.any()
    assert slotted["layers"][0]["attn"]["q"]["w"] is params["layers"][0]["attn"]["q"]["w"]
    loc = SketchPolicy(base=SketchConfig(method="l1", budget=0.3), location="first")
    assert tprobes.with_probe_slots(params, loc, n_layers=2) is params
    rcs = SketchPolicy(base=SketchConfig(method="rcs", budget=0.3))
    assert tprobes.collect_probes(tprobes.with_probe_slots(params, rcs, n_layers=2))[1] == {}
    grads, probes = tprobes.collect_probes(slotted)
    assert len(probes) == n_slots
    assert [id(x) for x in tree_leaves(grads)] == [id(x) for x in tree_leaves(params)]
    mlp = [{"w": torch.zeros(64, 784)}, {"w": torch.zeros(64, 64)}, {"w": torch.zeros(10, 64)}]
    out = tprobes.mlp_probe_slots(mlp, pol)
    assert [tprobes.PROBE_SLOT in s for s in out] == [True, True, False]  # lm_head excluded
    jout = jprobes.mlp_probe_slots([{"w": jnp.zeros(s["w"].shape)} for s in mlp],
                                   JSketchPolicy(base=JSketchConfig(method="l1", budget=0.3)))
    assert [("pslot" in s) for s in jout] == [True, True, False]
    last = SketchPolicy(base=SketchConfig(method="l1", budget=0.3), location="last",
                        exclude_roles=())
    assert [tprobes.PROBE_SLOT in s for s in tprobes.mlp_probe_slots(mlp, last)] == \
        [False, False, True]
    assert tprobes.mlp_probe_slots(mlp, None) is mlp


def _records():
    return [{"loss": 1.0 / (s + 1), "grad_norm": 0.5 + s, "probe_snr": 2.5, "step": s,
             "budget": None if s == 0 else 0.5,
             "probe_sites": {"segments/0/0/attn/q": [1.0, 2.0, 3.0, 1.0]}}
            for s in range(3)]


def test_sinks_write_jaxs_bytes(tmp_path):
    """The same records through JAX's and the port's JSONL and CSV sinks give
    byte-identical files; the ring keeps the newest; no paths, no sinks."""
    files = {}
    for pkg, mod, TC in (("jax", jsinks, JTelemetryConfig), ("torch", tsinks, TelemetryConfig)):
        paths = (str(tmp_path / pkg / "tel.jsonl"), str(tmp_path / pkg / "tel.csv"))
        sink = mod.build_sinks(TC(jsonl=paths[0], csv=paths[1]))
        for rec in _records():
            sink.write(rec)
        sink.close()
        files[pkg] = [open(p, "rb").read() for p in paths]
        assert mod.build_sinks(TC()) is None and mod.build_sinks(None) is None
    assert files["torch"] == files["jax"]
    lines = [json.loads(line) for line in files["torch"][0].decode().splitlines()]
    assert len(lines) == 3 and lines[0]["probe_sites"]["segments/0/0/attn/q"][1] == 2.0
    assert files["torch"][1].decode().splitlines()[0] == "budget,grad_norm,loss,probe_snr,step"
    ring = tsinks.RingSink(capacity=2)
    for rec in _records():
        ring.write(rec)
    assert len(ring) == 2 and ring.records[-1]["step"] == 2
    assert tsinks.percentiles(ring.records, "loss") == jsinks.percentiles(ring.records, "loss")
    assert tsinks.recovery_record("x", step=1) == jsinks.recovery_record("x", step=1)


@pytest.mark.parametrize("method,backend,block", [("l1", "compact", 4), ("per_column", "mask", 0),
                                                  ("l1", "stale", 16), ("rcs", "mask", 0)])
def test_site_cost_table_matches_jax(method, backend, block):
    """The port's per-layer tree gives JAX's table for its stacked tree: the
    same keys (``segments/0/0/...``), ``layers`` summed, the same FLOPs; the
    totals and the measured-FLOPs join agree."""
    cfg, jcfg = ArchConfig(**TINY), JArchConfig(**TINY)
    kw = dict(method=method, budget=0.25, backend=backend, block=block)
    params = Runtime(device="cpu").init_state(0, cfg, sgd(0.1)).params
    table = tsinks.site_cost_table(params, SketchPolicy(base=SketchConfig(**kw)), n_tokens=128,
                                   n_layers=cfg.n_layers)
    jtable = jsinks.site_cost_table(jlm.init_params(jax.random.key(0), jcfg),
                                    JSketchPolicy(base=JSketchConfig(**kw)), n_tokens=128,
                                    n_layers=jcfg.n_layers)
    assert table == jtable and len(table) == 7
    assert all(row["layers"] == cfg.n_layers for row in table.values())
    assert tsinks.table_totals(table) == jsinks.table_totals(jtable)
    assert tsinks.join_hlo_cost(table, {"flops": 1e9}) == \
        jsinks.join_hlo_cost(jtable, {"flops": 1e9})
    assert tsinks.site_cost_table(params, None, 128) == {}
