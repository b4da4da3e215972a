"""Budget schedules: which sketch budget runs at which step (port of
``repro/api/schedule.py``).

The paper trades gradient variance against backward cost and App. B.1 moves
the knob during a run: warm up exact and then sketch, or drop the budget when
a straggler slows the step. Unbiasedness (§2.2) makes this safe: switching
budgets mid-run never biases the gradient, only its variance.

:class:`BudgetSchedule` is piecewise constant in the step index and realised
as pre-built buckets: ``Runtime.train`` builds one step function per distinct
budget before the loop, and the loop switches between them. Controller-driven
modes share the :class:`Controller` protocol: the trainer calls
``step_begin()`` before and ``step_end(metrics)`` after each step and reads
``.budget`` for the next bucket. :class:`StragglerController` watches
measured step times (App. B.1);
:class:`~repro_torch.telemetry.controller.AdaptiveBudgetController` the
probes' gradient SNR (``BudgetSchedule.adaptive``).

Budget values:
  * ``None``  — exact backprop (no sketching at all);
  * ``1.0``   — the policy as configured (its own per-site budgets);
  * ``0<b<1`` — the policy with every site's budget overridden to ``b``
    (``SketchPolicy.with_budget``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence, Tuple

from repro_torch.obs import clock

__all__ = ["BudgetSchedule", "Controller", "StragglerController"]

Budget = Optional[float]  # None = exact; 1.0 = policy as configured


def _check_budget(b: Budget):
    if b is not None and not (0.0 < b <= 1.0):
        raise ValueError(f"budget must be None (exact) or in (0, 1], got {b}")


def _dedupe_points(points) -> Tuple[Tuple[int, Budget], ...]:
    """Collapse points landing on the same step (later budget wins) so
    degenerate constructor inputs yield a valid ascending schedule."""
    by_step = {}
    for s, b in points:
        by_step[int(s)] = b
    return tuple(sorted(by_step.items()))


@dataclasses.dataclass(frozen=True)
class BudgetSchedule:
    """Piecewise-constant budget-vs-step schedule, or a controller-driven
    (reactive / adaptive) bucket set.

    Attributes:
      points: ``((step, budget), ...)`` with strictly ascending non-negative
        steps; the budget before the first point is ``1.0`` (policy as
        configured). Empty = constant ``1.0``.
      reactive: descending budget buckets for straggler mitigation (paper
        App. B.1); index 0 is the full backward. Non-empty ``reactive``
        switches the schedule to reactive mode: the budget for each step
        comes from a :class:`StragglerController` watching measured step
        times.
      adaptive_budgets: budget buckets for the closed-loop SNR controller
        (``BudgetSchedule.adaptive``), ordered highest-fidelity first /
        cheapest last; requires ``target_snr``. The per-step bucket comes
        from an :class:`~repro_torch.telemetry.controller
        .AdaptiveBudgetController` consuming the telemetry probe summary.
      target_snr: gradient-SNR floor for adaptive mode (the
        step-level ``probe_snr`` of ``telemetry/probes.py``).
      window / slow_factor / fast_factor / target_step_s: controller tuning
        (``window`` is shared by both controller modes).

      ``points`` / ``reactive`` / ``adaptive_budgets`` are mutually
      exclusive.
    """

    points: Tuple[Tuple[int, Budget], ...] = ()
    reactive: Tuple[Budget, ...] = ()
    adaptive_budgets: Tuple[Budget, ...] = ()
    target_snr: Optional[float] = None
    window: int = 8
    slow_factor: float = 1.3
    fast_factor: float = 1.05
    target_step_s: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "points",
                           tuple((int(s), b) for s, b in self.points))
        object.__setattr__(self, "reactive", tuple(self.reactive))
        object.__setattr__(self, "adaptive_budgets",
                           tuple(self.adaptive_budgets))
        modes = [bool(self.points), bool(self.reactive),
                 bool(self.adaptive_budgets)]
        if sum(modes) > 1:
            raise ValueError("points, reactive and adaptive_budgets are "
                             "mutually exclusive")
        last = -1
        for s, b in self.points:
            if s <= last:
                raise ValueError(f"schedule steps must ascend, got {self.points}")
            last = s
            _check_budget(b)
        for b in self.reactive:
            _check_budget(b)
        prev = None
        for b in self.adaptive_budgets:
            _check_budget(b)
            eff = float("inf") if b is None else b
            if prev is not None and eff >= prev:
                raise ValueError("adaptive buckets must strictly descend "
                                 "(highest fidelity first, cheapest last), "
                                 f"got {self.adaptive_budgets}")
            prev = eff
        if self.adaptive_budgets and not (self.target_snr or 0) > 0:
            raise ValueError("adaptive schedule needs target_snr > 0")
        if self.target_snr is not None and not self.adaptive_budgets:
            raise ValueError("target_snr only applies to adaptive schedules")

    # -- constructors -------------------------------------------------------

    @classmethod
    def constant(cls, budget: Budget = 1.0) -> "BudgetSchedule":
        """One budget for the whole run (the default is the policy itself)."""
        _check_budget(budget)
        return cls(points=((0, budget),))

    @classmethod
    def warmup_exact(cls, exact_steps: int, budget: Budget = 1.0) -> "BudgetSchedule":
        """Paper App. B.1: exact backward for ``exact_steps``, then sketched
        (``exact_steps=0`` degrades to a constant schedule)."""
        return cls(points=_dedupe_points(((0, None), (int(exact_steps), budget))))

    @classmethod
    def piecewise(cls, *points: Tuple[int, Budget]) -> "BudgetSchedule":
        return cls(points=tuple(points))

    @classmethod
    def anneal(cls, steps: int, *, start: float = 1.0, end: float = 0.1,
               n_buckets: int = 4) -> "BudgetSchedule":
        """Geometric budget anneal ``start -> end`` over ``steps`` steps in
        ``n_buckets`` piecewise-constant stages (each stage = one built
        bucket; short runs collapse colliding stages, keeping the later
        budget)."""
        if n_buckets < 2:
            raise ValueError("anneal needs n_buckets >= 2")
        pts = []
        for i in range(n_buckets):
            frac = i / (n_buckets - 1)
            b = float(start * (end / start) ** frac)
            pts.append((int(round(steps * i / n_buckets)), min(1.0, b)))
        return cls(points=_dedupe_points(pts))

    @classmethod
    def straggler(cls, budgets: Sequence[Budget] = (1.0, 0.5, 0.2, 0.1, 0.05),
                  *, window: int = 8, slow_factor: float = 1.3,
                  fast_factor: float = 1.05,
                  target_step_s: Optional[float] = None) -> "BudgetSchedule":
        """Reactive straggler mitigation over pre-built budget buckets."""
        return cls(reactive=tuple(budgets), window=window,
                   slow_factor=slow_factor, fast_factor=fast_factor,
                   target_step_s=target_step_s)

    @classmethod
    def adaptive(cls, target_snr: float,
                 budgets: Sequence[Budget] = (1.0, 0.5, 0.2, 0.1),
                 *, window: int = 4) -> "BudgetSchedule":
        """Closed-loop schedule: each step runs the cheapest pre-built
        bucket whose probe-predicted gradient SNR meets ``target_snr``.
        ``budgets`` must descend (highest fidelity first); the controller
        re-evaluates every ``window`` steps and moves one bucket at a time.
        Requires telemetry probes: ``Runtime.train`` turns them on for
        adaptive schedules."""
        return cls(adaptive_budgets=tuple(budgets),
                   target_snr=float(target_snr), window=window)

    # -- queries ------------------------------------------------------------

    @property
    def is_reactive(self) -> bool:
        return bool(self.reactive)

    @property
    def is_adaptive(self) -> bool:
        return bool(self.adaptive_budgets)

    def buckets(self) -> Tuple[Budget, ...]:
        """Distinct budget values to pre-build, in first-use order
        (including the implicit ``1.0`` that runs before a late first
        point)."""
        if self.reactive:
            return tuple(dict.fromkeys(self.reactive))
        if self.adaptive_budgets:
            return tuple(dict.fromkeys(self.adaptive_budgets))
        if not self.points:
            return (1.0,)
        lead = () if self.points[0][0] == 0 else (1.0,)
        return tuple(dict.fromkeys(lead + tuple(b for _, b in self.points)))

    def budget_at(self, step: int) -> Budget:
        """Budget for ``step`` (non-controller schedules)."""
        if self.reactive or self.adaptive_budgets:
            raise ValueError("controller-driven schedule: use make_controller()")
        b: Budget = 1.0
        for s, pb in self.points:
            if step >= s:
                b = pb
            else:
                break
        return b

    def make_controller(self, policy=None) -> Optional["Controller"]:
        """The per-step bucket controller, or None for step-indexed
        schedules. ``policy`` (a SketchPolicy) lets adaptive mode map the
        ``1.0`` bucket onto the policy's own base budget for its SNR
        scaling law."""
        if self.reactive:
            return StragglerController(self.reactive, window=self.window,
                                       slow_factor=self.slow_factor,
                                       fast_factor=self.fast_factor,
                                       target_step_s=self.target_step_s)
        if self.adaptive_budgets:
            from repro_torch.telemetry.controller import AdaptiveBudgetController

            base = getattr(getattr(policy, "base", None), "budget", None)
            # Mapping the 1.0 bucket onto the policy's own base budget can
            # break the descending-fidelity contract (e.g. a policy at 0.2
            # with buckets (1.0, 0.5, 0.2, 0.1) -> effective (0.2, 0.5,
            # 0.2, 0.1)). Re-sort by effective fidelity (stable, so the
            # earlier-listed bucket wins a tie) and dedupe, so every bucket
            # the user listed stays reachable — including ones ABOVE the
            # policy's configured budget — and "later = cheaper" holds.
            pairs = []
            for b in self.adaptive_budgets:
                eff = (base if (b is not None and b >= 1.0 and base is not None)
                       else b)
                pairs.append((float("inf") if eff is None else eff, b, eff))
            pairs.sort(key=lambda p: -p[0])
            budgets, effective = [], []
            for feff, b, eff in pairs:
                if effective and feff == (float("inf") if effective[-1] is None
                                          else effective[-1]):
                    continue  # duplicate fidelity: keep the first
                budgets.append(b)
                effective.append(eff)
            return AdaptiveBudgetController(tuple(budgets), self.target_snr,
                                            effective=tuple(effective),
                                            window=self.window)
        return None


class Controller:
    """Protocol for per-step budget-bucket controllers.

    The trainer calls ``step_begin()`` before launching a step, reads
    ``.budget`` to pick the pre-built bucket, and calls
    ``step_end(metrics)`` after the step completes — ``metrics`` is the
    host-fetched step metrics dict when ``wants_metrics`` is True, else
    None. ``budget`` must always be one of the schedule's ``buckets()``:
    controllers select among pre-built step functions, they never cause a
    new build.
    """

    wants_metrics = False  # True -> the trainer fetches the scalars every step

    @property
    def budget(self):
        raise NotImplementedError

    def step_begin(self):  # noqa: B027 — optional hook
        pass

    def step_end(self, metrics=None):
        return self.budget


class StragglerController(Controller):
    """Reactive sketch-budget bucket switching (paper App. B.1).

    The paper observes that VJP approximation can be applied *selectively at
    slow compute nodes*; here it is applied step-wise: the trainer keeps a small set of
    pre-built train steps at different sketch budgets (the
    :class:`BudgetSchedule` buckets); this controller watches recent step
    times and drops to a cheaper backward when the measured step time exceeds
    the target (a slow host, a thermally-throttled chip, contention),
    recovering when times normalise.
    """

    def __init__(self, budgets=(1.0, 0.5, 0.2, 0.1, 0.05), *, window: int = 8,
                 slow_factor: float = 1.3, fast_factor: float = 1.05,
                 target_step_s: float | None = None):
        """budgets must be sorted descending; index 0 = full backward."""
        self.budgets = tuple(budgets)
        self.level = 0
        self.window = window
        self.slow = slow_factor
        self.fast = fast_factor
        self.target = target_step_s
        self._times = deque(maxlen=window)
        self._t0 = None

    @property
    def budget(self) -> float:
        return self.budgets[self.level]

    def step_begin(self):
        self._t0 = clock.now()

    def step_end(self, metrics=None):
        if self._t0 is None:
            return self.budget
        dt = clock.now() - self._t0
        self._times.append(dt)
        if self.target is None and len(self._times) == self.window and self.level == 0:
            # calibrate the target from the first full window at full budget
            self.target = sorted(self._times)[self.window // 2]
        if self.target is None or len(self._times) < 3:
            return self.budget
        med = sorted(self._times)[len(self._times) // 2]
        if med > self.slow * self.target and self.level + 1 < len(self.budgets):
            self.level += 1
            self._times.clear()
        elif med < self.fast * self.target and self.level > 0:
            self.level -= 1
            self._times.clear()
        return self.budget

    def observe(self, dt: float):
        """Test hook: feed an externally measured step time."""
        self._t0 = clock.now() - dt
        return self.step_end()
