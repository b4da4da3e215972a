"""Budget schedules and controllers of repro_torch against the JAX package's,
on the same inputs: buckets, step-indexed budgets, the controllers a schedule
makes for a policy (the adaptive one's effective budgets re-sorted), the
budget sequences the adaptive controller walks for a sequence of SNRs and the
straggler controller for a sequence of step times, and the validation
errors. Everything is compared exactly, except a straggler target
calibrated from fed step times, which the clock reads back to within
1e-5 s."""
import math

import pytest
import torch

from repro.api import AdaptiveBudgetController as JAdaptive
from repro.api import BudgetSchedule as JSchedule
from repro.api import SketchConfig as JSketchConfig
from repro.api import SketchPolicy as JSketchPolicy
from repro.api import StragglerController as JStraggler
from repro_torch.api import (AdaptiveBudgetController, BudgetSchedule, Controller,
                             SketchConfig, SketchPolicy, StragglerController)


# (constructor, args, kwargs) of each schedule, applied to both packages
SCHEDULES = [
    ("__call__", (), {}),
    ("constant", (0.5,), {}),
    ("constant", (None,), {}),
    ("warmup_exact", (3,), {}),
    ("warmup_exact", (0,), {}),
    ("warmup_exact", (5, 0.3), {}),
    ("piecewise", ((0, 1.0), (4, 0.5), (9, None)), {}),
    ("piecewise", ((2, 0.5), (6, 0.2)), {}),
    ("anneal", (20,), {}),
    ("anneal", (3,), {"start": 1.0, "end": 0.1, "n_buckets": 4}),
    ("anneal", (12,), {"start": 0.8, "end": 0.05, "n_buckets": 3}),
    ("straggler", (), {}),
    ("straggler", ((1.0, 0.5, 0.2),), {"window": 4, "target_step_s": 0.5}),
    ("adaptive", (2.0,), {}),
    ("adaptive", (1.0,), {"budgets": (None, 1.0, 0.5, 0.1), "window": 2}),
    ("adaptive", (0.3,), {"budgets": (1.0, 0.5, 0.2, 0.1)}),
]


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



def _make(cls, ctor, args, kwargs):
    return cls(*args, **kwargs) if ctor == "__call__" else getattr(cls, ctor)(*args, **kwargs)


def _policy(pkg, budget):
    if budget is None:
        return None
    if pkg == "jax":
        return JSketchPolicy(base=JSketchConfig(method="l1", budget=budget))
    return SketchPolicy(base=SketchConfig(method="l1", budget=budget))


def _budget_or_error(sched, step):
    try:
        return sched.budget_at(step)
    except ValueError as e:
        return ("ValueError", str(e))


def _controller_view(c):
    if c is None:
        return None
    return (type(c).__name__, tuple(c.budgets), tuple(getattr(c, "effective", ())),
            c.budget, getattr(c, "window", None), c.wants_metrics)


@pytest.mark.parametrize("ctor,args,kwargs", SCHEDULES,
                         ids=[f"{c}{a}{k or ''}" for c, a, k in SCHEDULES])
def test_schedule_matches_jax(ctor, args, kwargs):
    """buckets(), budget_at(0..20) and make_controller(policy) — for no
    policy and policies at budgets 0.2 and 0.6 — are JAX's."""
    s, js = _make(BudgetSchedule, ctor, args, kwargs), _make(JSchedule, ctor, args, kwargs)
    assert s.buckets() == js.buckets()
    assert (s.is_adaptive, s.is_reactive) == (js.is_adaptive, js.is_reactive)
    assert [_budget_or_error(s, t) for t in range(21)] == \
        [_budget_or_error(js, t) for t in range(21)]
    for b in (None, 0.2, 0.6):
        assert _controller_view(s.make_controller(policy=_policy("torch", b))) == \
            _controller_view(js.make_controller(policy=_policy("jax", b)))


# SNR sequences (None: a step with no probe signal, as at an exact bucket)
SNRS = [
    [1.6, 1.6, 1.1, 1.1, 0.5, 0.5, 10.0, 10.0, 10.0, 10.0, 0.01, 0.01, 0.01],
    [None, None, None, 3.0, 2.5, 2.0, 0.4, 0.3, None, 5.0, 5.0, 5.0, 5.0, 0.2],
    [float("nan"), 2.0, float("inf"), 1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4],
    [0.05 * (i % 7) + 0.2 for i in range(40)],
]
CONTROLLERS = [
    ((1.0, 0.5, 0.2), 0.8, {"effective": (0.6, 0.5, 0.2), "window": 2, "ema": 1.0}),
    ((None, 1.0, 0.5, 0.1), 1.0, {"effective": (None, 0.2, 0.5, 0.1), "window": 3}),
    ((None, 0.5, 0.2), 0.5, {"window": 1, "ema": 0.3}),
    ((1.0, 0.5), 2.0, {}),
]


@pytest.mark.parametrize("snrs", SNRS, ids=range(len(SNRS)))
@pytest.mark.parametrize("budgets,target,kw", CONTROLLERS, ids=range(len(CONTROLLERS)))
def test_adaptive_controller_walks_jaxs_budgets(budgets, target, kw, snrs):
    """The same SNR sequence fed to both controllers gives the same budget
    after every step (and the same level and smoothed SNR)."""
    c, jc = AdaptiveBudgetController(budgets, target, **kw), JAdaptive(budgets, target, **kw)
    for snr in snrs:
        m = {} if snr is None else {"probe_snr": snr}
        assert c.step_end(m) == jc.step_end(m)
        assert (c.level, c._count) == (jc.level, jc._count)
        assert (c._ema is None and jc._ema is None) or c._ema == jc._ema
    assert c.predicted_snr(2.0, 0.5, 0.2) == jc.predicted_snr(2.0, 0.5, 0.2)
    assert math.isinf(c.predicted_snr(2.0, 0.5, None))


@pytest.mark.parametrize("times", [
    [1.0] * 4 + [2.0] * 8 + [0.9] * 6,
    [0.3, 0.31, 0.29, 0.3, 0.3, 0.3, 0.3, 0.3, 0.7, 0.7, 0.7, 0.8, 0.2, 0.2, 0.2, 0.2],
    [0.5 + 0.4 * ((i * 7) % 5 == 0) for i in range(40)],
], ids=["drop-and-recover", "calibrated", "bursty"])
@pytest.mark.parametrize("kw", [{"window": 4, "target_step_s": 1.0},
                                {"window": 4}, {"window": 3, "slow_factor": 1.2,
                                                "fast_factor": 1.1}])
def test_straggler_controller_walks_jaxs_budgets(times, kw):
    """The same step times fed to both straggler controllers give the same
    budgets (the target calibrated from the first full window when unset)."""
    c, jc = StragglerController((1.0, 0.5, 0.2), **kw), JStraggler((1.0, 0.5, 0.2), **kw)
    for dt in times:
        assert c.observe(dt) == jc.observe(dt)
        assert c.level == jc.level
    assert (c.target is None) == (jc.target is None)
    if c.target is not None:
        # observe(dt) reads dt back through the clock: equal up to its rounding
        assert c.target == pytest.approx(jc.target, abs=1e-5)


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("bad", [
    lambda S: S(points=((0, 0.5), (0, 0.2))),
    lambda S: S(points=((3, 0.5), (1, 0.2))),
    lambda S: S.constant(1.5),
    lambda S: S.constant(0.0),
    lambda S: S.adaptive(2.0, budgets=(0.5, 1.0)),
    lambda S: S.adaptive(2.0, budgets=(None, None)),
    lambda S: S.adaptive(0.0),
    lambda S: S(adaptive_budgets=(1.0, 0.5)),
    lambda S: S(target_snr=2.0),
    lambda S: S(points=((0, 0.5),), adaptive_budgets=(1.0, 0.5), target_snr=1.0),
    lambda S: S(points=((0, 0.5),), reactive=(1.0, 0.5)),
    lambda S: S.anneal(10, n_buckets=1),
    lambda S: S.straggler((1.0, 2.0)),
    lambda S: S.adaptive(1.0, budgets=(1.0, 0.5)).budget_at(0),
])
def test_schedule_validation_matches_jax(bad):
    """Each bad schedule raises ValueError in both packages, with JAX's
    message."""
    msg = _error(lambda: bad(BudgetSchedule))
    assert msg is not None and msg == _error(lambda: bad(JSchedule))


def test_controller_validation_matches_jax():
    for args, kw in [(((), 1.0), {}), (((1.0, 0.5), 0.0), {}),
                     (((1.0, 0.5), 1.0), {"effective": (0.5,)})]:
        msg = _error(lambda: AdaptiveBudgetController(*args, **kw))
        assert msg is not None and msg == _error(lambda: JAdaptive(*args, **kw))


def test_controller_protocol_default():
    """A Controller subclass needs only ``budget``; step_end returns it."""

    class Fixed(Controller):
        budget = 0.5

    c = Fixed()
    c.step_begin()
    assert c.step_end({"probe_snr": 1.0}) == 0.5 and not c.wants_metrics
    assert AdaptiveBudgetController.wants_metrics and not StragglerController.wants_metrics
