"""Gradient sentinel: the step's trip flag and the host-side escalation logic
(port of ``repro/resilience/sentinel.py``).

Two halves, split by where the information lives:

  * **In the step** (:func:`trip_flag`, run by the train step when
    ``ResilienceConfig.sentinel`` is set): from quantities the step already
    holds, the loss and the global gradient norm, one boolean
    ``ok = isfinite(loss) & isfinite(gn) & (gn <= max_grad_norm)``. JAX
    gates the update with ``where(ok, new, old)`` leaf by leaf; the port's
    optimizers update in place, so its step reads ``ok`` once on the host
    and, when it is false, skips the update and the plan-carry write
    (``train/train_step.py``, docs/port.md "Resilience"). Either way an
    untripped step is bit for bit a sentinel-off step, and a tripped one
    keeps the old parameters, moments and carry (the step counter still
    advances) and reports ``sentinel_trip = 1``.
  * **Host side** (:class:`GradSentinel`, consulted by the trainer between
    steps): reads the fetched scalars, adds a loss-spike EMA and an optional
    probe-SNR floor, and decides *escalate vs rollback*. On a trip it forces
    the exact (budget=None) prebuilt bucket for K steps, the paper-native
    fallback: unbiasedness means swapping buckets never biases the gradient,
    so when the estimator is the suspect the cheapest remedy is buying its
    variance down. After M *consecutive* trips the estimator is exonerated
    (the exact bucket tripped too) and the sentinel raises
    :class:`RollbackRequired` for the supervisor.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["GradSentinel", "RollbackRequired", "trip_flag"]


class RollbackRequired(RuntimeError):
    """Escalation exhausted: restore the last verified checkpoint.

    Raised by the trainer when the sentinel sees ``rollback_after``
    consecutive trips; carries the trip step, the last cause, and the
    history accumulated so far for the supervisor to stitch.
    """

    def __init__(self, step: int, cause: str, *, history=None):
        super().__init__(f"sentinel requires rollback at step {step} ({cause})")
        self.step = int(step)
        self.cause = cause
        self.history = list(history or [])


def trip_flag(loss: torch.Tensor, grad_norm: torch.Tensor, max_grad_norm: float):
    """The step's sentinel: ``(ok, tripped)``, a bool tensor true when the
    update is safe, and 0.0 / 1.0 as a float32 tensor (1.0: non-finite loss
    or gradients, or a norm above ``max_grad_norm``). Both stay on the
    tensors' device."""
    ok = torch.isfinite(loss) & torch.isfinite(grad_norm) & (grad_norm <= max_grad_norm)
    return ok, 1.0 - ok.to(torch.float32)


class GradSentinel:
    """Host-side trip accounting: spike EMA, budget escalation, rollback.

    Follows the :class:`repro_torch.api.Controller` step cadence (the trainer
    feeds it the same fetched scalars) but composes *with* a schedule
    controller instead of replacing it: :meth:`override` rewrites the
    controller's or schedule's budget to ``None`` (exact) while an
    escalation window is open.
    """

    wants_metrics = True  # the trainer must fetch scalars every step

    def __init__(self, rcfg):
        self.rcfg = rcfg
        self.consecutive = 0
        self.escalate_left = 0
        self.trips: list = []
        self._ema: Optional[float] = None
        self._clean_steps = 0

    # -- budget composition --------------------------------------------------

    def override(self, budget):
        """The budget actually run this step: exact while escalating."""
        return None if self.escalate_left > 0 else budget

    # -- per-step observation ------------------------------------------------

    def observe(self, step: int, metrics: dict) -> Optional[str]:
        """Digest one step's fetched scalars; returns the trip cause (or
        None for a clean step). Faulty losses never update the spike EMA."""
        r = self.rcfg
        loss = metrics.get("loss")
        cause = None
        if metrics.get("sentinel_trip", 0.0) > 0.5:
            cause = "nonfinite_or_norm"
        elif loss is not None and not math.isfinite(loss):
            cause = "nonfinite_loss"
        elif (loss is not None and self._ema is not None
                and self._clean_steps >= r.warmup_steps
                and loss > r.spike_factor * self._ema + 1e-6):
            cause = "loss_spike"
        else:
            snr = metrics.get("probe_snr")
            if (r.min_snr is not None and snr is not None
                    and math.isfinite(snr) and snr < r.min_snr):
                cause = "snr_collapse"

        if cause is not None:
            self.consecutive += 1
            self.escalate_left = r.escalate_steps
            self.trips.append({"step": int(step), "cause": cause})
        else:
            self.consecutive = 0
            if self.escalate_left > 0:
                self.escalate_left -= 1
            if loss is not None and math.isfinite(loss):
                d = 1.0 - r.ema_decay
                self._ema = (loss if self._ema is None
                             else (1.0 - d) * self._ema + d * loss)
                self._clean_steps += 1
        return cause

    @property
    def should_rollback(self) -> bool:
        return (self.rcfg.rollback_after > 0
                and self.consecutive >= self.rcfg.rollback_after)

    @property
    def last_cause(self) -> str:
        return self.trips[-1]["cause"] if self.trips else "unknown"
