"""The training loop of repro_torch (``train/trainer.py``, accumulation in
``train/train_step.py``) on the tiny LM:

* exact accumulation: an ``accum=2`` step's loss and gradients equal JAX's
  ``accum=2`` step's from the same weights (rtol 1e-5, atol 1e-6);
* sketched accumulation: an ``accum=2`` ``stale`` step equals the mean of
  its two microbatches run alone under their seeds, carry included (bit for
  bit: the same operations in the same order);
* an adaptive schedule builds one step function per bucket before the loop
  (counted) and runs only those; its warning and its ``accum`` error;
* a run resumed from a checkpoint repeats the straight run bit for bit;
* ports of JAX's tests/test_trainer.py and the legacy shim's one warning.
"""
import importlib
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionConfig as JExecutionConfig
from repro.configs.base import ArchConfig as JArchConfig
from repro.optim import Optimizer as JOptimizer
from repro.train.train_step import init_state as jinit_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.api import (BudgetSchedule, ExecutionConfig, Runtime, SketchConfig,
                             SketchPolicy, StragglerController)
from repro_torch.configs.base import ArchConfig
from repro_torch.core import plan_state
from repro_torch.data.synthetic import LMStream
from repro_torch.interop import params_from_jax
from repro_torch.optim import Optimizer, adamw, cosine_warmup, sgd
from repro_torch.train import trainer
from repro_torch.train.train_step import micro_seed
from repro_torch.train.trainer import TrainerConfig
from repro_torch.tree import tree_leaves, tree_map


tstep_mod = importlib.import_module("repro_torch.train.train_step")

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
            vocab=128, q_chunk=32, kv_chunk=32)
RTOL, ATOL = 1e-5, 1e-6


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



def _batch(vocab, B=4, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _capture(opt_init):
    """An optimizer that leaves the parameters as they are and returns the
    gradients it was given as its new state (the carry is still written)."""
    return Optimizer(opt_init, lambda grads, state, params, step: (params, grads))


def _clone_state(state):
    return tstep_mod.TrainState(params=tree_map(lambda t: t.detach().clone(), state.params),
                                opt_state=tree_map(lambda t: t.detach().clone(),
                                                   state.opt_state),
                                step=state.step)


# ---------------------------------------------------------------------------
# Accumulation
# ---------------------------------------------------------------------------


def test_exact_accumulation_matches_jax():
    """``accum=2`` under exact backprop: the loss, the gradient norm and every
    averaged gradient equal JAX's ``accum=2`` step's from the same weights."""
    jcfg, cfg = JArchConfig(**TINY), ArchConfig(**TINY)
    jopt = JOptimizer(lambda p: jax.tree.map(jnp.zeros_like, p),
                      lambda grads, state, params, step: (params, grads))
    jstate = jinit_state(jax.random.key(0), jcfg, jopt)
    params = params_from_jax(jax.device_get(jstate.params), cfg, device="cpu")
    batch = _batch(cfg.vocab)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, None, execution=JExecutionConfig(accum=2)))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(1))
    rt = Runtime(device="cpu", execution=ExecutionConfig(accum=2))
    opt = _capture(lambda p: {})
    state = rt.init_state(0, cfg, opt, params=params)
    state, m = rt.train_step(cfg, opt)(state, batch, 1)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL, abs=ATOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=RTOL)
    want = params_from_jax(jax.device_get(jstate.opt_state), cfg, device="cpu")
    got = state.opt_state
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["stale", "pallas"])
def test_sketched_accumulation_is_the_mean_of_its_microbatches(backend):
    """An ``accum=2`` step equals the mean of its two microbatches, each run
    alone as an ``accum=1`` step under ``micro_seed(key, m)`` from the same
    state (so both sample from the same carry): the gradients, the loss and,
    under ``stale``, the written-back carry, bit for bit."""
    cfg = ArchConfig(**TINY)
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.4, backend=backend, block=16))
    rt1 = Runtime(policy=pol, device="cpu")
    state0 = rt1.init_state(0, cfg, sgd(0.1))
    state0, _ = rt1.train_step(cfg, sgd(0.1))(state0, _batch(cfg.vocab, seed=9), 5)  # a carry
    opt = _capture(lambda p: {})
    batch, key = _batch(cfg.vocab, B=4), 77
    rt2 = Runtime(policy=pol, device="cpu", execution=ExecutionConfig(accum=2))
    s_acc, m_acc = rt2.train_step(cfg, opt)(_clone_state(state0), batch, key)
    step1 = rt1.train_step(cfg, opt)
    loss = torch.zeros(())
    acc = tree_map(lambda p: torch.zeros(p.shape), state0.params)
    carries = []
    for m in range(2):
        mb = {k: v[2 * m:2 * m + 2] for k, v in batch.items()}
        s_m, m_m = step1(_clone_state(state0), mb, micro_seed(key, m))
        loss = loss + m_m["loss"] / 2
        grads = s_m.opt_state
        fresh = plan_state.collect_plan_state(s_m.params)[1]
        carries.append(fresh)
        for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
            a.add_(g / 2)
    assert torch.equal(m_acc["loss"], loss)
    got_carry = plan_state.collect_plan_state(s_acc.params)[1]
    # the gradients the optimizer saw (the carry's zeroed in both)
    assert len(tree_leaves(s_acc.opt_state)) == len(tree_leaves(acc))
    for a, b in zip(tree_leaves(s_acc.opt_state), tree_leaves(acc)):
        assert torch.equal(a, b)
    if backend == "stale":
        assert len(got_carry) == 7 * cfg.n_layers
        for path, v in got_carry.items():
            want = torch.zeros_like(v).add_(carries[0][path] / 2).add_(carries[1][path] / 2)
            assert torch.equal(v, want), path
            assert not torch.equal(carries[0][path], carries[1][path])
    else:
        assert got_carry == {}


def test_accumulation_splits_positions_and_segments_on_the_batch_axis():
    """A batch with ``positions`` and ``segments`` [B, S] splits every entry
    on axis 0: under exact backprop the accum=2 loss is the accum=1 loss (the
    mean over equal microbatches). JAX's accumulation splits ``positions``
    on axis 1 (its M-RoPE layout, [3, B, S]) and fails on this batch
    (ROADMAP.md, Queue 3)."""
    cfg = ArchConfig(**TINY)
    batch = dict(_batch(cfg.vocab, B=4), positions=np.tile(np.arange(16), (4, 1)) + 3,
                 segments=np.repeat([[1] * 8 + [2] * 8], 4, axis=0))
    losses = []
    for accum in (1, 2):
        rt = Runtime(device="cpu", execution=ExecutionConfig(accum=accum))
        state = rt.init_state(0, cfg, sgd(0.1))
        _, m = rt.train_step(cfg, sgd(0.1))(state, batch, 1)
        losses.append(float(m["loss"]))
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)


def test_accumulation_rejects_a_batch_it_cannot_split():
    cfg = ArchConfig(**TINY)
    rt = Runtime(device="cpu", execution=ExecutionConfig(accum=3))
    state = rt.init_state(0, cfg, sgd(0.1))
    with pytest.raises(ValueError, match="microbatches"):
        rt.train_step(cfg, sgd(0.1))(state, _batch(cfg.vocab, B=4), 1)


# ---------------------------------------------------------------------------
# Schedules in the loop
# ---------------------------------------------------------------------------


def test_adaptive_trains_with_only_prebuilt_buckets(monkeypatch):
    """``BudgetSchedule.adaptive`` through ``Runtime.train``: exactly one step
    function is built per bucket, all before the first step, and every step
    runs one of them; the controller walks down; probes ride along."""
    events = []
    real = tstep_mod.make_train_step

    def counting(cfg, opt, policy=None, **kw):
        fn = real(cfg, opt, policy, **kw)
        idx = sum(e == "build" for e in events)
        events.append("build")

        def step(*a):
            events.append(idx)
            return fn(*a)

        return step

    monkeypatch.setattr(tstep_mod, "make_train_step", counting)
    sched = BudgetSchedule.adaptive(0.05, budgets=(None, 1.0, 0.5, 0.2), window=2)
    rt = Runtime(policy=SketchPolicy(base=SketchConfig(method="l1", budget=0.5)),
                 schedule=sched, device="cpu")
    data = LMStream(vocab=TINY["vocab"], seed=0).batches(4, 16)
    _, hist = rt.train(ArchConfig(**TINY), sgd(0.1), data, TrainerConfig(steps=10, log_every=1),
                       on_metrics=lambda m: None)
    n = len(sched.buckets())
    assert events[:n] == ["build"] * n and "build" not in events[n:]
    assert len(events) == n + 10
    assert all(m["budget"] in sched.buckets() for m in hist)
    assert hist[0]["budget"] is None and len({m["budget"] for m in hist}) >= 3
    assert all(math.isfinite(m["probe_snr"]) for m in hist if m["budget"] is not None)
    assert all("probe_sites" not in m for m in hist)  # the implicit config: per_site=False


def test_adaptive_warns_when_it_cannot_measure():
    """An adaptive schedule that can see no probe warns; a healthy one does
    not; adaptive with accumulation is refused."""

    def runs_with_warning(rt):
        data = LMStream(vocab=TINY["vocab"], seed=0).batches(2, 16)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            rt.train(ArchConfig(**TINY), sgd(0.1), data, TrainerConfig(steps=2, log_every=1),
                     on_metrics=lambda m: None)
        return any("cannot measure gradient SNR" in str(w.message) for w in rec)

    sched = BudgetSchedule.adaptive(1.0, budgets=(1.0, 0.5))
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.3))
    assert runs_with_warning(Runtime(policy=SketchPolicy(base=SketchConfig(
        method="per_element", budget=0.3)), schedule=sched, device="cpu"))
    assert runs_with_warning(Runtime(policy=SketchPolicy(), schedule=sched, device="cpu"))
    assert runs_with_warning(Runtime(policy=SketchPolicy(
        base=SketchConfig(method="l1", budget=0.3), location="first"), schedule=sched,
        device="cpu"))
    assert not runs_with_warning(Runtime(policy=pol, schedule=sched, device="cpu"))
    with pytest.raises(ValueError, match="accum == 1"):
        Runtime(policy=pol, schedule=sched, device="cpu",
                execution=ExecutionConfig(accum=2)).train(
            ArchConfig(**TINY), sgd(0.1), LMStream(vocab=TINY["vocab"], seed=0).batches(2, 16),
            TrainerConfig(steps=2))


def test_warmup_exact_then_sketched_under_plan_carry():
    """``warmup_exact(2)`` with ``onepass``: the exact steps leave the carry
    as it was (no site reads it), the sketched ones refresh it."""
    cfg = ArchConfig(**TINY)
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.4, backend="onepass", block=16))
    rt = Runtime(policy=pol, schedule=BudgetSchedule.warmup_exact(2), device="cpu")
    data = LMStream(vocab=cfg.vocab, seed=0).batches(2, 16)
    state, hist = rt.train(cfg, sgd(0.1), data, TrainerConfig(steps=2, log_every=1),
                           on_metrics=lambda m: None)
    assert [h["budget"] for h in hist] == [None, None]
    assert all(torch.equal(v, torch.ones_like(v))
               for v in plan_state.collect_plan_state(state.params)[1].values())
    state, hist = rt.train(cfg, sgd(0.1), data, TrainerConfig(steps=3, log_every=1),
                           state=state, on_metrics=lambda m: None)
    assert [h["budget"] for h in hist] == [1.0]
    assert not any(torch.equal(v, torch.ones_like(v))
                   for v in plan_state.collect_plan_state(state.params)[1].values())


# ---------------------------------------------------------------------------
# Checkpoints and resume
# ---------------------------------------------------------------------------


def test_resume_repeats_the_straight_run_bit_for_bit(tmp_path, capsys):
    """``warmup_exact(2)``, ``stale`` l1@0.4, AdamW: a 6-step run, and a run
    stopped at 3 (checkpoint every 3) and resumed by a fresh Runtime with the
    data from step 3 on, give the same losses from step 3 and the same final
    parameters (carry included) and optimizer state, bit for bit."""
    cfg = ArchConfig(**TINY)
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.4, backend="stale", block=16))

    def run(steps, ckpt, start=0):
        rt = Runtime(policy=pol, schedule=BudgetSchedule.warmup_exact(2), device="cpu")
        data = LMStream(vocab=cfg.vocab, seed=0).batches(4, 16, start_step=start)
        opt = adamw(cosine_warmup(3e-3, 2, 6), weight_decay=0.1, clip=1.0)
        return rt.train(cfg, opt, data, TrainerConfig(steps=steps, log_every=1,
                                                      ckpt_dir=str(ckpt), ckpt_every=3),
                        on_metrics=lambda m: None)

    s_full, h_full = run(6, tmp_path / "a")
    run(3, tmp_path / "b")
    s_res, h_res = run(6, tmp_path / "b", start=3)
    assert "resumed from step 3" in capsys.readouterr().out
    assert [h["step"] for h in h_res] == [3, 4, 5]
    assert [h["loss"] for h in h_res] == [h["loss"] for h in h_full[3:]]
    assert [h["budget"] for h in h_res] == [1.0, 1.0, 1.0]
    assert s_res.step == s_full.step == 6
    for a, b in zip(tree_leaves(s_full.params) + tree_leaves(s_full.opt_state),
                    tree_leaves(s_res.params) + tree_leaves(s_res.opt_state)):
        assert torch.equal(a, b)
    assert len(plan_state.collect_plan_state(s_res.params)[1]) == 7 * cfg.n_layers


# ---------------------------------------------------------------------------
# Ports of JAX's tests/test_trainer.py, and the legacy shim
# ---------------------------------------------------------------------------


def _run(policy, steps=30, ckpt=None, start_state=None):
    opt = adamw(cosine_warmup(3e-3, 5, steps), clip=1.0)
    data = LMStream(vocab=TINY["vocab"], seed=0).batches(4, 32)
    tcfg = TrainerConfig(steps=steps, log_every=max(1, steps // 10), ckpt_dir=ckpt,
                         ckpt_every=10)
    return Runtime(policy=policy, device="cpu").train(ArchConfig(**TINY), opt, data, tcfg,
                                                      state=start_state,
                                                      on_metrics=lambda m: None)


def test_exact_training_reduces_loss():
    _, hist = _run(None)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.2


def test_sketched_training_reduces_loss():
    _, hist = _run(SketchPolicy(base=SketchConfig(method="l1", budget=0.3)))
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.15


def test_resume_from_checkpoint(tmp_path):
    d = str(tmp_path)
    _run(None, steps=10, ckpt=d)
    _, hist2 = _run(None, steps=20, ckpt=d)  # picks up at step 10
    assert hist2[0]["step"] >= 10 and hist2[-1]["step"] == 19


def test_straggler_controller_drops_and_recovers():
    c = StragglerController((1.0, 0.5, 0.2), window=4, target_step_s=1.0)
    for _ in range(4):
        c.observe(1.0)
    assert c.budget == 1.0
    for _ in range(4):
        c.observe(2.0)  # slow regime: drop the budget
    assert c.budget == 0.5
    for _ in range(4):
        c.observe(2.0)
    assert c.budget == 0.2
    for _ in range(6):
        c.observe(0.9)  # recovered: climb back
    assert c.budget >= 0.5


def test_legacy_train_warns_once_and_matches_runtime(monkeypatch):
    """The legacy ``train`` warns ``DeprecationWarning`` once per process and
    takes the Runtime's steps; ``straggler_budgets`` maps to a reactive
    schedule."""
    monkeypatch.setattr(trainer, "_warned_legacy", False)
    cfg = ArchConfig(**TINY)
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.3))
    tcfg = TrainerConfig(steps=2, log_every=1)

    def data():
        return LMStream(vocab=cfg.vocab, seed=0).batches(2, 16)

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, h1 = trainer.train(cfg, sgd(0.1), data(), tcfg, pol, device="cpu",
                              on_metrics=lambda m: None)
        trainer.train(cfg, sgd(0.1), data(), tcfg, pol, device="cpu", on_metrics=lambda m: None)
    assert sum(issubclass(w.category, DeprecationWarning) for w in rec) == 1
    _, h2 = Runtime(policy=pol, device="cpu").train(cfg, sgd(0.1), data(), tcfg,
                                                     on_metrics=lambda m: None)
    assert [h["loss"] for h in h1] == [h["loss"] for h in h2]
    rt = Runtime.from_legacy_kwargs(pol, straggler_budgets=(1.0, 0.5), device="cpu")
    assert rt.schedule.is_reactive and rt.schedule.buckets() == (1.0, 0.5)
    assert Runtime.from_legacy_kwargs(device="cpu").schedule == BudgetSchedule()


def test_prefetch_places_batches_forwards_errors_and_stops_its_worker():
    """``prefetch`` yields the batches as the train step takes them, raises a
    worker's exception in the consumer, and leaves no thread behind once
    closed, even over an endless stream."""
    import threading

    from repro_torch.data.pipeline import prefetch, shard_batch

    before = threading.active_count()
    it = prefetch(LMStream(vocab=64, seed=0).batches(2, 8), size=2, device="cpu")
    b = next(it)
    want = next(LMStream(vocab=64, seed=0).batches(2, 8))
    assert b["tokens"].dtype == torch.int64 and torch.equal(b["tokens"],
                                                            torch.as_tensor(want["tokens"]).long())
    it.close()
    assert threading.active_count() == before

    def failing():
        yield {"tokens": np.zeros((1, 2), np.int32)}
        raise KeyError("worker failed")

    it = prefetch(failing(), device="cpu")
    next(it)
    with pytest.raises(KeyError, match="worker failed"):
        next(it)
    assert threading.active_count() == before
    assert shard_batch(want) is want
