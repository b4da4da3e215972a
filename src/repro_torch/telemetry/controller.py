"""Closed-loop budget control: pick the cheapest bucket meeting a target SNR
(a line-for-line port of ``repro/telemetry/controller.py``; pure Python).

The paper shows per-step cost and gradient variance trade off against each
other, and unbiasedness (§2.2) makes it safe to move along that trade-off
*during* a run. :class:`AdaptiveBudgetController` closes the loop: it
consumes the probe summary (``probe_snr`` — the step-level estimate
``‖dW‖² / E‖dŴ − dW‖²`` from ``repro_torch/telemetry/probes.py``) between
steps and walks the schedule's **pre-built** budget buckets toward the
cheapest one whose *predicted* SNR still meets the target: the controller
only selects among the step functions the trainer built before the loop.

Prediction uses the column-sketch scaling law: at uniform budget ``b`` the
probed (diagonal) variance scales as ``(1 − b) / b`` while ``‖dW‖²`` is
budget-free, so a measurement at ``b₀`` extrapolates as

    snr(b) ≈ snr(b₀) · [b (1 − b₀)] / [b₀ (1 − b)].

Exact buckets (``None``) have infinite SNR and always qualify; they provide
no measurement, so after ``window`` quiet steps at an exact bucket the
controller steps down one level to start measuring. Hysteresis: the SNR is
EMA-smoothed, re-evaluated every ``window`` steps, and the level moves at
most one bucket per evaluation.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

__all__ = ["AdaptiveBudgetController"]


class AdaptiveBudgetController:
    # Conforms to the repro_torch.api.schedule.Controller protocol by duck
    # typing (step_begin / step_end / budget / wants_metrics) — deliberately
    # not a subclass, so this module never imports repro_torch.api and stays
    # importable on its own (repro_torch.api imports *us* for the re-export).
    """Adaptive bucket selection against a target gradient SNR.

    Args:
      budgets: schedule bucket values, ordered highest-fidelity first
        (index 0) to cheapest last — ``None`` = exact, ``1.0`` = policy as
        configured, ``0<b<1`` = uniform budget override.
      target_snr: the floor the predicted step SNR must keep.
      effective: per-bucket *effective* column-keep fraction used by the
        scaling law (``None`` for exact buckets; the trainer maps the
        ``1.0`` bucket to the policy's own base budget). Defaults to the
        bucket values themselves.
      window: steps between level re-evaluations (also the patience at an
        exact bucket before stepping down to start measuring).
      ema: smoothing factor for the SNR measurement (1.0 = last value).
    """

    wants_metrics = True

    def __init__(self, budgets: Sequence[Optional[float]], target_snr: float, *,
                 effective: Optional[Sequence[Optional[float]]] = None,
                 window: int = 4, ema: float = 0.5):
        if not budgets:
            raise ValueError("adaptive controller needs at least one bucket")
        self.budgets: Tuple[Optional[float], ...] = tuple(budgets)
        self.effective = (tuple(effective) if effective is not None
                          else self.budgets)
        if len(self.effective) != len(self.budgets):
            raise ValueError("effective budgets must match buckets 1:1")
        if not (target_snr > 0):
            raise ValueError(f"target_snr must be > 0, got {target_snr}")
        self.target = float(target_snr)
        self.window = max(1, int(window))
        self.alpha = float(ema)
        self.level = 0
        self._ema: Optional[float] = None
        self._count = 0

    @property
    def budget(self) -> Optional[float]:
        return self.budgets[self.level]

    def step_begin(self):
        pass

    @staticmethod
    def predicted_snr(snr: float, b_from: Optional[float],
                      b_to: Optional[float]) -> float:
        """Extrapolate a measurement at ``b_from`` to budget ``b_to``."""
        if b_to is None:
            return math.inf
        if b_from is None:
            return 0.0  # exact buckets carry no variance measurement
        b_from = min(float(b_from), 1.0 - 1e-6)
        b_to = min(float(b_to), 1.0 - 1e-6)
        return snr * (b_to * (1.0 - b_from)) / (b_from * (1.0 - b_to))

    def _desired_level(self) -> int:
        b_cur = self.effective[self.level]
        best = 0  # no bucket meets the target -> highest fidelity
        for i in range(len(self.budgets)):
            if self.predicted_snr(self._ema, b_cur, self.effective[i]) >= self.target:
                best = i  # later = cheaper (ordering contract)
        return best

    def step_end(self, metrics: Optional[dict] = None) -> Optional[float]:
        snr = None
        if metrics is not None:
            v = metrics.get("probe_snr")
            if v is not None and math.isfinite(float(v)):
                snr = float(v)
        if snr is None:
            # No probe signal. At an exact bucket that is expected — step
            # down after a patience window to start measuring. Anywhere else
            # (policy with no probe-capable sites) hold the level: never
            # adapt blind.
            if (self.effective[self.level] is None
                    and self.level + 1 < len(self.budgets)):
                self._count += 1
                if self._count >= self.window:
                    self._count = 0
                    self.level += 1
            return self.budget
        self._ema = (snr if self._ema is None
                     else (1.0 - self.alpha) * self._ema + self.alpha * snr)
        self._count += 1
        if self._count < self.window:
            return self.budget
        self._count = 0
        desired = self._desired_level()
        if desired != self.level:
            self.level += 1 if desired > self.level else -1
            self._ema = None  # re-measure at the new bucket
        return self.budget

    def observe(self, snr: float):
        """Test hook: feed an externally measured step SNR."""
        return self.step_end({"probe_snr": snr})
