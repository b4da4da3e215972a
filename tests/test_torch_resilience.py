"""The port's resilience layer (``repro_torch.resilience``) on the CPU: fault
injection, the gradient sentinel and its skip gate, the exact-bucket
escalation, the supervisor's checkpoint rollback, and the trainer's hooks.

Ports of ``tests/test_resilience.py`` on JAX's MLP fixture ``(32, 16, 16, 4)``
(all but the 8-device re-shard, which runs on gloo ranks in
``tests/test_torch_distributed_elastic.py``; here, the device losses the
supervisor cannot re-shard raise) and
of ``tests/test_obs.py``'s two resilience cases. Against JAX in the same
process: fault plans, sentinel decisions and trip flags equal exactly (host
logic, or one comparison per value); an exact supervised run gives JAX's
event sequence (timings aside) and JAX's final parameters within rtol 1e-5 /
atol 1e-6 (the tolerance of ``test_exact_accumulation_matches_jax``: float32
reorderings only); ``ClassStream`` batches equal bit for bit. A tripped
step keeps the parameters, the moments and the plan carry bit for bit under
every sketched backend. One intra-op thread, as the trainer tests run: the
bit-for-bit comparisons need the CPU's reductions in one order.
"""
import dataclasses
import gc
import json
import math
import os
import weakref

import jax
import numpy as np
import pytest
import torch

from repro import compat
from repro.api import ExecutionConfig as JExecutionConfig
from repro.api import Runtime as JRuntime
from repro.data.synthetic import ClassStream as JClassStream
from repro.models.mlp import mlp_arch as jmlp_arch
from repro.optim import adamw as jadamw
from repro.optim import constant as jconstant
from repro.resilience import FaultPlan as JFaultPlan
from repro.resilience import FaultSpec as JFaultSpec
from repro.resilience import GradSentinel as JGradSentinel
from repro.resilience import ResilienceConfig as JResilienceConfig
from repro.resilience import Supervisor as JSupervisor
from repro.resilience.sentinel import trip_flag as jtrip_flag
from repro.train.train_step import init_state as jinit_state
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.api import (ExecutionConfig, FaultPlan, FaultSpec, GradSentinel, ObsConfig,
                             ResilienceConfig, Runtime, SketchConfig, SketchPolicy, Supervisor,
                             TelemetryConfig)
from repro_torch.configs.base import ArchConfig
from repro_torch.core import plan_state
from repro_torch.data.synthetic import ClassStream, LMStream
from repro_torch.interop import params_from_jax
from repro_torch.models.mlp import mlp_arch
from repro_torch.optim import Optimizer, adamw, constant
from repro_torch.resilience import DeviceLossFault, FaultInjector
from repro_torch.resilience.sentinel import trip_flag
from repro_torch.train import checkpoint as ckptlib
from repro_torch.train import train_step as tstep_mod
from repro_torch.train.trainer import TrainerConfig, train_loop
from repro_torch.tree import tree_leaves

SIZES = (32, 16, 16, 4)
TINY = dict(name="res-tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
            d_ff=128, vocab=128, q_chunk=32, kv_chunk=32)
RTOL, ATOL = 1e-5, 1e-6  # test_exact_accumulation_matches_jax's: float32 reorderings


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return mlp_arch(SIZES)


def _opt():
    return adamw(constant(1e-2), clip=1.0)


def _data(batch=16, seed=0):
    return ClassStream(dim=SIZES[0], n_classes=SIZES[-1], seed=seed).batches(batch)


def _runtime(resilience=None, policy="l1", telemetry=None, obs=None):
    pol = (SketchPolicy(base=SketchConfig(method="l1", budget=0.5))
           if policy == "l1" else None)
    return Runtime(policy=pol, device="cpu", execution=ExecutionConfig(
        resilience=resilience, telemetry=telemetry, obs=obs))


def _leaves(state):
    return [t.detach().numpy() for t in tree_leaves(state.params) + tree_leaves(state.opt_state)]


def _spec_tuple(plan):
    return tuple((f.step, f.kind, f.scale, f.sleep_s, f.mesh_shape) for f in plan.faults)


# ---------------------------------------------------------------------------
# config and plan plumbing
# ---------------------------------------------------------------------------


def test_resilience_config_validation():
    with pytest.raises(ValueError):
        ResilienceConfig(max_grad_norm=0.0)
    with pytest.raises(ValueError):
        ResilienceConfig(spike_factor=1.0)
    with pytest.raises(ValueError):
        ResilienceConfig(ema_decay=1.5)
    with pytest.raises(ValueError):
        ExecutionConfig(resilience="not-a-config")
    # JAX's fields and defaults; frozen and hashable (part of the step-cache key)
    assert dataclasses.asdict(ResilienceConfig()) == dataclasses.asdict(JResilienceConfig())
    assert hash(ResilienceConfig()) == hash(ResilienceConfig())
    with pytest.raises(dataclasses.FrozenInstanceError):
        ResilienceConfig().sentinel = False
    assert ResilienceConfig().replace(escalate_steps=2).escalate_steps == 2


@pytest.mark.parametrize("bad", [dict(max_grad_norm=-1.0), dict(spike_factor=0.5),
                                 dict(ema_decay=0.0), dict(ema_decay=1.0),
                                 dict(warmup_steps=-1), dict(escalate_steps=-1),
                                 dict(rollback_after=-1), dict(max_recoveries=-1)])
def test_resilience_config_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError) as jerr:
        JResilienceConfig(**bad)
    with pytest.raises(ValueError) as err:
        ResilienceConfig(**bad)
    assert str(err.value) == str(jerr.value)


def test_fault_plan_validation_and_determinism():
    with pytest.raises(ValueError):
        FaultSpec(step=1, kind="meteor")
    with pytest.raises(ValueError):
        FaultSpec(step=1, kind="device_loss")  # needs mesh_shape
    with pytest.raises(ValueError):  # one fault per step
        FaultPlan(faults=(FaultSpec(step=2, kind="spike"), FaultSpec(step=2, kind="nonfinite")))
    a = FaultPlan.random(seed=7, steps=50, n=4)
    b = FaultPlan.random(seed=7, steps=50, n=4)
    assert a == b
    assert len(a.faults) == 4


@pytest.mark.parametrize("kw", [dict(seed=7, steps=50, n=4), dict(seed=0, steps=10, n=3),
                                dict(seed=3, steps=30, n=6, min_step=5),
                                dict(seed=11, steps=40, n=5,
                                     kinds=("nonfinite", "spike", "slow", "ckpt_io")),
                                dict(seed=2, steps=4, n=3, kinds=("slow",))])
def test_fault_plan_random_matches_jax(kw):
    plan, jplan = FaultPlan.random(**kw), JFaultPlan.random(**kw)
    assert _spec_tuple(plan) == _spec_tuple(jplan)
    assert plan.kinds == jplan.kinds
    assert all(plan.at(f.step) == f for f in plan.faults) and plan.at(10**6) is None


@pytest.mark.parametrize("kw", [dict(ckpt_every=3), dict(ckpt_every=5),
                                dict(ckpt_every=4, mesh_shape=(2, 4))])
def test_fault_plan_drill_matches_jax(kw):
    assert _spec_tuple(FaultPlan.drill(**kw)) == _spec_tuple(JFaultPlan.drill(**kw))


@pytest.mark.parametrize("bad", [dict(step=-1, kind="spike"), dict(step=1, kind="spike", scale=1.0),
                                 dict(step=1, kind="spike", scale=float("inf")),
                                 dict(step=1, kind="device_loss"), dict(step=1, kind="meteor")])
def test_fault_spec_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError) as jerr:
        JFaultSpec(**bad)
    with pytest.raises(ValueError) as err:
        FaultSpec(**bad)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError):  # cannot place 4 faults in [1, 4)
        FaultPlan.random(seed=0, steps=4, n=4)


def test_fault_injector_fires_once():
    plan = FaultPlan(faults=(FaultSpec(step=3, kind="nonfinite"),))
    inj = FaultInjector(plan)
    assert inj.take(2) is None
    assert inj.take(3).kind == "nonfinite"
    assert inj.take(3) is None  # spent: a retried trajectory runs clean
    assert inj.pending == 0
    assert FaultInjector.wrap(inj) is inj and FaultInjector.wrap(None) is None


def test_faults_kwarg_requires_resilience():
    with pytest.raises(ValueError, match="resilience"):
        train_loop(_runtime(None), _cfg(), _opt(), _data(), TrainerConfig(steps=2),
                   faults=FaultPlan(faults=(FaultSpec(step=1, kind="spike"),)))


def test_step_takes_fault_scale_only_with_resilience():
    """The three-argument step without resilience, JAX's four-argument step
    with it; ``fault_scale`` multiplies the reported loss."""
    cfg, opt = _cfg(), _opt()
    batch = next(_data())
    rt = _runtime(None)
    state = rt.init_state(0, cfg, opt)
    _, m = rt.train_step(cfg, opt)(state, batch, 1)
    assert "sentinel_trip" not in m
    rt = _runtime(ResilienceConfig(sentinel=False))
    state = rt.init_state(0, cfg, opt)
    with pytest.raises(TypeError):
        rt.train_step(cfg, opt)(state, batch, 1)
    _, m2 = rt.train_step(cfg, opt)(state, batch, 1, 3.0)
    assert "sentinel_trip" not in m2
    assert float(m2["loss"]) == pytest.approx(3.0 * float(m["loss"]), rel=1e-6)


# ---------------------------------------------------------------------------
# sentinel: bit-identity, skip and escalate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["mlp", "lm-stale"])
def test_sentinel_untripped_is_bit_identical(model):
    """Resilience on and never tripped equals resilience off bit for bit: the
    MLP (JAX's case) and the tiny LM under ``stale``, carry included."""
    if model == "mlp":
        cfg, data, pol = _cfg(), _data, "l1"
    else:
        cfg = ArchConfig(**TINY)
        data = lambda: LMStream(vocab=cfg.vocab, seed=0).batches(4, 16)  # noqa: E731
        pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.4, backend="stale",
                                             block=16))
    tcfg = TrainerConfig(steps=6, log_every=2, seed=3)
    rts = {}
    for name, res in (("off", None), ("on", ResilienceConfig(max_grad_norm=1e12))):
        rt = _runtime(res, policy=pol) if model == "mlp" else Runtime(
            policy=pol, device="cpu", execution=ExecutionConfig(resilience=res))
        rts[name] = train_loop(rt, cfg, _opt(), data(), tcfg)
    (s_off, _), (s_on, hist) = rts["off"], rts["on"]
    for a, b in zip(_leaves(s_off), _leaves(s_on)):
        assert a.tobytes() == b.tobytes()  # bitwise, not approx
    assert all(m["sentinel_trip"] == 0.0 for m in hist)
    if model != "mlp":
        assert len(plan_state.collect_plan_state(s_on.params)[1]) == 7 * cfg.n_layers


def test_nonfinite_fault_skips_update_and_escalates():
    rcfg = ResilienceConfig(escalate_steps=3, rollback_after=0)
    plan = FaultPlan(faults=(FaultSpec(step=2, kind="nonfinite"),))
    budgets, events = [], []
    state, hist = train_loop(
        _runtime(rcfg), _cfg(), _opt(), _data(), TrainerConfig(steps=8, log_every=1),
        faults=plan, on_event=events.append, on_metrics=lambda m: budgets.append(m["budget"]))
    by_step = {m["step"]: m for m in hist}
    # the poisoned step reports the trip; params survived (loss stays finite)
    assert by_step[2]["sentinel_trip"] == 1.0
    assert np.isfinite(by_step[3]["loss"])
    # escalation window: exact (None) for the next escalate_steps steps
    assert [by_step[s]["budget"] for s in (3, 4, 5)] == [None, None, None]
    assert by_step[6]["budget"] == 1.0
    kinds = [e["event"] for e in events]
    assert kinds == ["fault_injected", "sentinel_trip"]
    assert events[1]["cause"] == "nonfinite_or_norm"
    # step counter still advanced through the skipped update
    assert state.step == 8


def test_spike_detection_via_host_ema():
    rcfg = ResilienceConfig(max_grad_norm=1e9, warmup_steps=2, escalate_steps=2, rollback_after=0)
    sent = GradSentinel(rcfg)
    for step in range(5):
        assert sent.observe(step, {"loss": 1.0, "sentinel_trip": 0.0}) is None
    cause = sent.observe(5, {"loss": 50.0, "sentinel_trip": 0.0})
    assert cause == "loss_spike"
    assert sent.override(0.5) is None  # escalated to exact
    sent.observe(6, {"loss": 1.0, "sentinel_trip": 0.0})
    sent.observe(7, {"loss": 1.0, "sentinel_trip": 0.0})
    assert sent.override(0.5) == 0.5  # window closed


def _metric_sequence(seed, n=80):
    """Seeded scalars with NaN and infinite losses, spikes, in-step trips and
    low or NaN probe SNRs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = {"loss": float(1.0 + 0.1 * rng.standard_normal()), "sentinel_trip": 0.0,
             "probe_snr": float(rng.uniform(0.0, 2.0))}
        u = rng.random()
        if u < 0.06:
            m["loss"] = float("nan")
        elif u < 0.1:
            m["loss"] = float("inf")
        elif u < 0.2:
            m["loss"] *= 30.0
        elif u < 0.3:
            m["sentinel_trip"] = 1.0
        if rng.random() < 0.1:
            m["probe_snr"] = float("nan")
        if rng.random() < 0.1:
            del m["probe_snr"]
        out.append(m)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [dict(), dict(min_snr=0.3, warmup_steps=2, escalate_steps=3,
                                             rollback_after=4, ema_decay=0.7)])
def test_grad_sentinel_matches_jax(seed, kw):
    """One seeded sequence of fetched scalars through both sentinels: the
    same cause, override, escalation, consecutive count and rollback verdict
    at every step."""
    sent, jsent = GradSentinel(ResilienceConfig(**kw)), JGradSentinel(JResilienceConfig(**kw))
    seen = set()
    for step, m in enumerate(_metric_sequence(seed)):
        cause = sent.observe(step, dict(m))
        assert cause == jsent.observe(step, dict(m)), step
        assert sent.override(0.5) == jsent.override(0.5)
        assert (sent.consecutive, sent.escalate_left, sent.should_rollback, sent.last_cause) == \
            (jsent.consecutive, jsent.escalate_left, jsent.should_rollback, jsent.last_cause)
        seen.add(cause)
    assert sent.trips == jsent.trips
    assert {"nonfinite_or_norm", "nonfinite_loss", "loss_spike"} <= seen
    if kw.get("min_snr") is not None:
        assert "snr_collapse" in seen


@pytest.mark.parametrize("loss,gn", [(1.0, 5.0), (float("nan"), 1.0), (1.0, float("nan")),
                                     (float("inf"), 1.0), (1.0, float("inf")), (1.0, 1000.0),
                                     (1.0, 1000.0001), (float("-inf"), 0.0), (-3.0, 0.0)])
def test_trip_flag_matches_jax(loss, gn):
    ok, tripped = trip_flag(torch.tensor(loss), torch.tensor(gn), 1e3)
    jok, jtripped = jtrip_flag(np.float32(loss), np.float32(gn), 1e3)
    assert bool(ok) == bool(jok)
    assert float(tripped) == float(jtripped) == (0.0 if bool(ok) else 1.0)
    assert tripped.dtype == torch.float32


def _carry_run(backend, kind, tmp_path=None):
    """The tiny LM under ``backend`` (``pallas-compact``: compact gradients
    and lazy AdamW) with one ``kind`` fault at step 2: the state's leaves
    after steps 0, 1 and 2, and the history."""
    cfg = ArchConfig(**TINY)
    compact = backend == "pallas-compact"
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.4, block=16,
                                         backend=backend.split("-")[0]))
    rcfg = ResilienceConfig(escalate_steps=2, rollback_after=0)
    rt = Runtime(policy=pol, device="cpu",
                 execution=ExecutionConfig(resilience=rcfg, compact_grads=compact))
    opt = adamw(constant(1e-2), clip=1.0, lazy=compact)
    state = rt.init_state(0, cfg, opt)
    # the optimizers and the carry write update these tensors in place
    live = tree_leaves(state.params) + tree_leaves(state.opt_state)
    snaps = {}

    def on_metrics(m):
        if m["step"] in (0, 1, 2):
            snaps[m["step"]] = [t.detach().clone() for t in live]

    sup = Supervisor(rt, cfg, opt, TrainerConfig(steps=6, log_every=1),
                     fault_plan=FaultPlan(faults=(FaultSpec(step=2, kind=kind),)))
    state, hist = sup.run(LMStream(vocab=cfg.vocab, seed=0).batches(4, 16), state=state,
                          on_metrics=on_metrics)
    return cfg, state, hist, snaps, sup


@pytest.mark.parametrize("kind", ["nonfinite", "spike"])
@pytest.mark.parametrize("backend", ["stale", "onepass", "pallas", "pallas-compact"])
def test_tripped_sketched_step_keeps_params_moments_and_carry(backend, kind):
    """A ``nonfinite`` or ``spike`` fault on a sketched step of the tiny LM:
    the step trips, the parameters, the AdamW moments and the plan carry stay
    bit for bit as they were, the next escalate_steps steps run exact, and
    every leaf is finite at the end."""
    cfg, state, hist, snaps, sup = _carry_run(backend, kind)
    by_step = {m["step"]: m for m in hist}
    assert by_step[2]["sentinel_trip"] == 1.0 and by_step[2]["budget"] == 1.0
    assert [by_step[s]["budget"] for s in range(6)] == [1.0, 1.0, 1.0, None, None, 1.0]
    assert all(torch.equal(a, b) for a, b in zip(snaps[1], snaps[2]))
    # the snapshots follow the live state: a clean step changes it
    assert not all(torch.equal(a, b) for a, b in zip(snaps[0], snaps[1]))
    carry = plan_state.collect_plan_state(state.params)[1]
    assert len(carry) == (0 if backend.startswith("pallas") else 7 * cfg.n_layers)
    assert all(torch.isfinite(t).all() for t in tree_leaves(state.params)
               + tree_leaves(state.opt_state))
    assert [e["event"] for e in sup.events] == ["fault_injected", "sentinel_trip"]


# ---------------------------------------------------------------------------
# checkpoint IO and rollback recovery
# ---------------------------------------------------------------------------


def test_ckpt_io_fault_recovers_with_sync_retry(tmp_path):
    rcfg = ResilienceConfig(rollback_after=0)
    plan = FaultPlan(faults=(FaultSpec(step=3, kind="ckpt_io"),))
    events = []
    train_loop(_runtime(rcfg), _cfg(), _opt(), _data(),
               TrainerConfig(steps=10, log_every=5, ckpt_dir=str(tmp_path), ckpt_every=4),
               faults=plan, on_event=events.append)
    kinds = [e["event"] for e in events]
    assert "ckpt_io_recovered" in kinds
    # the sync retry landed the checkpoint despite the injected failure
    assert ckptlib.latest_verified_step(str(tmp_path)) == 8


def test_ckpt_io_fault_at_the_final_wait_is_retried(tmp_path):
    """The write armed on the last save fails in the writer thread and is
    retried synchronously at the loop's final wait."""
    events = []
    train_loop(_runtime(ResilienceConfig()), _cfg(), _opt(), _data(),
               TrainerConfig(steps=8, log_every=4, ckpt_dir=str(tmp_path), ckpt_every=4),
               faults=FaultPlan(faults=(FaultSpec(step=6, kind="ckpt_io"),)),
               on_event=events.append)
    assert [e["event"] for e in events] == ["fault_injected", "ckpt_io_recovered"]
    assert events[1]["step"] == 8 and "injected IO fault" in events[1]["error"]
    assert ckptlib.latest_verified_step(str(tmp_path)) == 8
    with pytest.raises(ckptlib.CheckpointError):  # without resilience it raises
        ckptlib.inject_fault_once()
        train_loop(_runtime(None), _cfg(), _opt(), _data(),
                   TrainerConfig(steps=2, log_every=4, ckpt_dir=str(tmp_path / "b"),
                                 ckpt_every=1))


def test_rollback_restores_verified_checkpoint(tmp_path):
    rcfg = ResilienceConfig(rollback_after=2, escalate_steps=2)
    plan = FaultPlan(faults=(FaultSpec(step=6, kind="nonfinite"),
                             FaultSpec(step=7, kind="nonfinite")))
    tcfg = TrainerConfig(steps=12, log_every=4, ckpt_dir=str(tmp_path), ckpt_every=3)
    sup = Supervisor(_runtime(rcfg), _cfg(), _opt(), tcfg, fault_plan=plan)
    state, hist = sup.run(_data())
    assert state.step == 12
    assert sup.recoveries == 1
    rb = [e for e in sup.events if e["event"] == "rollback"]
    assert len(rb) == 1
    assert rb[0]["cause"] == "nonfinite_or_norm"
    assert rb[0]["resume_step"] == 6  # newest verified ckpt before the burst
    assert rb[0]["steps_lost"] == 2


def test_supervisor_caps_recoveries(tmp_path):
    rcfg = ResilienceConfig(rollback_after=1, max_recoveries=1)
    plan = FaultPlan(faults=(FaultSpec(step=2, kind="nonfinite"),
                             FaultSpec(step=4, kind="nonfinite")))
    tcfg = TrainerConfig(steps=8, log_every=4, ckpt_dir=str(tmp_path), ckpt_every=2)
    sup = Supervisor(_runtime(rcfg), _cfg(), _opt(), tcfg, fault_plan=plan)
    with pytest.raises(RuntimeError, match="max_recoveries"):
        sup.run(_data())


@pytest.mark.parametrize("ckpt", [False, True], ids=["no_ckpt_dir", "mesh_too_large"])
def test_supervisor_reraises_device_loss(tmp_path, ckpt):
    """A device loss the supervisor cannot re-shard: without a checkpoint
    directory it dumps the ``device_loss`` crash bundle, counts the
    recovery and re-raises the fault unchanged (with the step, the mesh
    shape, the history and the state), as JAX does; with one, a surviving
    mesh larger than the process group (here none: one rank) raises a
    ``ValueError`` naming both sizes, from the fault. The re-shard itself
    runs on gloo ranks (``tests/test_torch_distributed_elastic.py``)."""
    obs = ObsConfig(crash_dir=str(tmp_path / "crash"))
    ckpt_dir = str(tmp_path / "ckpt")
    tcfg = TrainerConfig(steps=8, log_every=1, ckpt_dir=ckpt_dir if ckpt else None,
                         ckpt_every=3)
    plan = FaultPlan(faults=(FaultSpec(step=5, kind="device_loss", mesh_shape=(2, 4)),))
    sup = Supervisor(_runtime(obs=obs), _cfg(), _opt(), tcfg, fault_plan=plan)
    assert sup.runtime.execution.resilience == ResilienceConfig()  # installed
    if ckpt:
        with pytest.raises(ValueError, match=r"needs 8 ranks, the process group has 1") as err:
            sup.run(_data())
        assert isinstance(err.value.__cause__, DeviceLossFault)
        assert ckptlib.latest_verified_step(ckpt_dir) == 3  # drained
    else:
        with pytest.raises(DeviceLossFault) as err:
            sup.run(_data())
        e = err.value
        assert (e.step, e.mesh_shape, e.state.step) == (5, (2, 4), 5)
        assert [h["step"] for h in e.history] == [0, 1, 2, 3, 4]
    assert sup.recoveries == 1
    meta = json.load(open(tmp_path / "crash" / "crash_000_device_loss" / "meta.json"))
    assert meta["extra"] == {"step": 5, "mesh_shape": [2, 4], "attempt": 0}


def test_supervised_retry_reuses_steps_and_frees_the_failed_attempt(tmp_path, monkeypatch):
    """Across a rollback: one step build per bucket (the exact one included)
    for both attempts, and the failed attempt's tensors are freed before the
    retry's first update (reference counting alone: the cyclic collector is
    off)."""
    builds = []
    real = tstep_mod.make_train_step

    def counting(cfg, opt, policy=None, **kw):
        builds.append(None if policy is None else policy.base.budget)
        return real(cfg, opt, policy, **kw)

    monkeypatch.setattr(tstep_mod, "make_train_step", counting)
    base = _opt()
    refs, first_of = [], {}

    def update(grads, state, params, step):
        leaves = tree_leaves(params)
        attempt = 0 if not refs or any(r() is leaves[0] for r in refs[0]) else 1
        if attempt == 1 and 1 not in first_of:
            first_of[1] = [r() is None for r in refs[0]]
        if len(refs) == attempt:
            refs.append([weakref.ref(t) for t in leaves + tree_leaves(state)])
        return base.update(grads, state, params, step)

    opt = Optimizer(base.init, update)  # a fresh optimizer: a fresh step-cache key
    plan = FaultPlan(faults=(FaultSpec(step=6, kind="nonfinite"),
                             FaultSpec(step=7, kind="nonfinite")))
    tcfg = TrainerConfig(steps=12, log_every=4, ckpt_dir=str(tmp_path), ckpt_every=3)
    sup = Supervisor(_runtime(ResilienceConfig(rollback_after=2, escalate_steps=2)), _cfg(), opt,
                     tcfg, fault_plan=plan)
    gc.disable()
    try:
        state, _ = sup.run(_data())
    finally:
        gc.enable()
    assert sup.recoveries == 1 and len(refs) == 2
    assert sorted(builds, key=str) == [0.5, None]
    assert first_of[1] and all(first_of[1])
    assert all(r() is None for r in refs[0])
    assert state.step == 12


# ---------------------------------------------------------------------------
# the full acceptance drill
# ---------------------------------------------------------------------------


def test_full_drill_recovers_and_matches_fault_free(tmp_path):
    """JAX's acceptance drill: seeded plan over {nonfinite, spike, ckpt_io};
    every fault recovered, final loss within tolerance of the fault-free run,
    every recovery event on the JSONL sink."""
    steps, ckpt_every = 30, 5
    tel = TelemetryConfig(jsonl=str(tmp_path / "events.jsonl"), interval=1)
    rcfg = ResilienceConfig(rollback_after=3, escalate_steps=4)

    def one(workdir, plan):
        tcfg = TrainerConfig(steps=steps, log_every=5, ckpt_dir=str(workdir),
                             ckpt_every=ckpt_every, seed=0)
        sup = Supervisor(_runtime(rcfg, telemetry=tel), _cfg(), _opt(), tcfg, fault_plan=plan)
        state, hist = sup.run(_data())
        return state, hist, sup

    _, hist_clean, _ = one(tmp_path / "clean", None)
    plan = FaultPlan.drill(ckpt_every=ckpt_every)
    state, hist, sup = one(tmp_path / "faulted", plan)

    assert state.step == steps
    fired = {e["step"] for e in sup.events if e["event"] == "fault_injected"}
    assert fired == {f.step for f in plan.faults}
    kinds = [e["event"] for e in sup.events]
    assert "ckpt_io_recovered" in kinds
    assert "rollback" in kinds
    assert kinds.count("sentinel_trip") >= 4

    # recovered, not merely survived: close to the fault-free trajectory
    clean_loss = hist_clean[-1]["loss"]
    assert abs(hist[-1]["loss"] - clean_loss) < 0.5 * clean_loss + 0.1

    # every recovery event also reached the telemetry sink
    with open(tmp_path / "events.jsonl") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    sunk = [r["event"] for r in recs if "event" in r]
    for k in ("fault_injected", "sentinel_trip", "ckpt_io_recovered", "rollback"):
        assert k in sunk, f"{k} missing from sink"


def _strip(events):
    return [{k: v for k, v in e.items() if k != "wall_s"} for e in events]


def test_exact_supervised_run_matches_jax(tmp_path):
    """An exact (``policy=None``) supervised run of the MLP through a
    checkpoint-write fault, a two-step non-finite burst that rolls back, and a
    spike: the port's events equal JAX's (wall times aside), and so do the
    budgets and steps of the stitched history; the losses and the final
    parameters agree within rtol 1e-5 / atol 1e-6. Both start from JAX's
    weights."""
    cfg, jcfg = _cfg(), jmlp_arch(SIZES)
    jopt = jadamw(jconstant(1e-2), clip=1.0)
    jstate = jinit_state(compat.prng_key(0), jcfg, jopt)
    params = params_from_jax(jax.device_get(jstate.params), cfg, device="cpu")
    kw = dict(rollback_after=2, escalate_steps=2)
    faults = ((0, "ckpt_io"), (5, "nonfinite"), (6, "nonfinite"), (8, "spike"))
    steps, every = 10, 2

    jsup = JSupervisor(
        JRuntime(execution=JExecutionConfig(resilience=JResilienceConfig(**kw))), jcfg, jopt,
        JTrainerConfig(steps=steps, log_every=1, ckpt_dir=str(tmp_path / "jax"),
                       ckpt_every=every),
        fault_plan=JFaultPlan(faults=tuple(JFaultSpec(step=s, kind=k) for s, k in faults)))
    jfinal, jhist = jsup.run(JClassStream(dim=SIZES[0], n_classes=SIZES[-1]).batches(16),
                             state=jstate, on_metrics=lambda m: None)

    opt = _opt()
    rt = Runtime(device="cpu", execution=ExecutionConfig(resilience=ResilienceConfig(**kw)))
    sup = Supervisor(rt, cfg, opt, TrainerConfig(steps=steps, log_every=1,
                                                 ckpt_dir=str(tmp_path / "port"),
                                                 ckpt_every=every),
                     fault_plan=FaultPlan(faults=tuple(FaultSpec(step=s, kind=k)
                                                       for s, k in faults)))
    final, hist = sup.run(_data(), state=rt.init_state(0, cfg, opt, params=params),
                          on_metrics=lambda m: None)

    assert _strip(sup.events) == _strip(jsup.events)
    assert [e["event"] for e in sup.events] == [
        "fault_injected", "ckpt_io_recovered", "fault_injected", "sentinel_trip",
        "fault_injected", "sentinel_trip", "rollback", "fault_injected", "sentinel_trip"]
    # the checkpoint of step 6 holds step 4's state: the tripped step 5 kept it
    assert sup.events[6]["resume_step"] == 6 and sup.events[6]["steps_lost"] == 1
    assert [(h["step"], h["budget"]) for h in hist] == [(h["step"], h["budget"]) for h in jhist]
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               rtol=RTOL, atol=ATOL)
    assert [h["sentinel_trip"] for h in hist] == [h["sentinel_trip"] for h in jhist]
    assert final.step == int(np.asarray(jfinal.step)) == steps
    want = params_from_jax(jax.device_get(jfinal.params), cfg, device="cpu")
    assert [sorted(layer) for layer in final.params] == [sorted(layer) for layer in want]
    for got_layer, want_layer in zip(final.params, want):
        for k, v in got_layer.items():
            np.testing.assert_allclose(v.detach().numpy(), want_layer[k].numpy(),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed,start", [(0, 0), (3, 5), (17, 2)])
def test_class_stream_matches_jax(seed, start):
    ours = ClassStream(dim=SIZES[0], n_classes=SIZES[-1], seed=seed).batches(16, start_step=start)
    theirs = JClassStream(dim=SIZES[0], n_classes=SIZES[-1], seed=seed).batches(
        16, start_step=start)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == {"x", "y"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


# ---------------------------------------------------------------------------
# observability: crash bundles and the recovery span
# ---------------------------------------------------------------------------


def test_ckpt_io_fault_leaves_crash_bundle(tmp_path):
    """An injected checkpoint-IO fault dumps a flight-recorder bundle whose
    spans.json (Chrome-trace form) contains the fault_injected span, and the
    synchronous retry runs under a ckpt_save_sync span."""
    cfg = ObsConfig(crash_dir=str(tmp_path / "crash"))
    rcfg = ResilienceConfig(rollback_after=0)
    plan = FaultPlan(faults=(FaultSpec(step=3, kind="ckpt_io"),))
    rt = Runtime(device="cpu", execution=ExecutionConfig(resilience=rcfg, obs=cfg))
    train_loop(rt, _cfg(), _opt(), _data(),
               TrainerConfig(steps=10, log_every=5, ckpt_dir=str(tmp_path / "ckpt"),
                             ckpt_every=4),
               faults=plan)
    bundle = os.path.join(cfg.crash_dir, "crash_000_ckpt_io")
    assert os.path.isdir(bundle)
    meta = json.load(open(os.path.join(bundle, "meta.json")))
    assert meta["reason"] == "ckpt_io"
    # the fault arms at step 3; the async writer's failure surfaces at a
    # later checkpoint wait — the bundle records the step that observed it
    assert meta["n_spans"] > 0 and meta["extra"]["step"] >= 3
    spans = json.load(open(os.path.join(bundle, "spans.json")))
    names = {e["name"] for e in spans["traceEvents"]}
    assert "fault_injected" in names and "train_step" in names
    for fname in ("metrics.json", "events.json"):
        json.load(open(os.path.join(bundle, fname)))  # valid JSON, present
    [sync] = rt.observability().tracer.spans("ckpt_save_sync")
    assert sync.attrs["step"] == 8


def test_supervisor_rollback_bundle_and_recovery_span(tmp_path):
    cfg = ObsConfig(crash_dir=str(tmp_path / "crash"))
    rcfg = ResilienceConfig(rollback_after=2, escalate_steps=2)
    plan = FaultPlan(faults=(FaultSpec(step=6, kind="nonfinite"),
                             FaultSpec(step=7, kind="nonfinite")))
    tcfg = TrainerConfig(steps=12, log_every=4, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=3)
    rt = Runtime(device="cpu", execution=ExecutionConfig(resilience=rcfg, obs=cfg))
    sup = Supervisor(rt, _cfg(), _opt(), tcfg, fault_plan=plan)
    state, _ = sup.run(_data())
    assert state.step == 12
    assert sup.recoveries == 1
    # recovery counters live in the unified registry (adopted component)
    snap = rt.observability().metrics_snapshot()
    assert snap["resilience.recoveries"] == 1.0
    assert snap["resilience.events"] >= 1.0
    # the rollback crash bundle + the recovery span
    bundle = os.path.join(cfg.crash_dir, "crash_000_rollback")
    meta = json.load(open(os.path.join(bundle, "meta.json")))
    assert meta["extra"]["cause"] == "nonfinite_or_norm"
    events = json.load(open(os.path.join(bundle, "events.json")))
    assert any(e.get("event") == "fault_injected" for e in events)
    [rec] = rt.observability().tracer.spans("recovery.rollback")
    assert rec.attrs["step"] == 7 and rec.duration_s > 0
    assert not math.isnan(rec.duration_s)
