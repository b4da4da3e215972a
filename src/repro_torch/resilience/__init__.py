"""repro_torch.resilience: fault injection, the gradient sentinel, recovery
(port of ``repro/resilience``).

Randomized unbiased VJPs trade per-step cost for gradient noise (paper §3),
so a long run must *detect* divergence (non-finite gradients, loss spikes,
probe-SNR collapse) and *degrade gracefully* instead of silently corrupting
the run. Three pieces:

  * :class:`ResilienceConfig`: the frozen, hashable switchboard riding
    ``ExecutionConfig.resilience``. With it set, the train step takes a
    ``fault_scale`` argument and skips the optimizer update and the
    plan-carry write when the step's finiteness/norm flag trips; training is
    bit for bit a resilience-off run when the sentinel never trips.
  * :mod:`~repro_torch.resilience.faults`: a seeded, declarative
    :class:`FaultPlan` (step -> fault) injecting non-finite cotangents, loss
    spikes, slow steps, checkpoint-write errors and simulated device loss,
    so every recovery path is deterministically testable.
  * :class:`~repro_torch.resilience.sentinel.GradSentinel` (host side) and
    :class:`~repro_torch.resilience.supervisor.Supervisor`: escalate the
    budget to exact for K steps on a trip (when the estimator is the
    suspect, buy variance down before buying a rollback), and roll back to
    the last *verified* checkpoint after M consecutive trips. A device loss
    is re-raised: re-sharding needs a mesh, which the port does not have yet
    (docs/port.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.resilience.faults import DeviceLossFault, FaultInjector, FaultPlan, FaultSpec
from repro_torch.resilience.sentinel import GradSentinel, RollbackRequired

__all__ = [
    "DeviceLossFault",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "GradSentinel",
    "ResilienceConfig",
    "RollbackRequired",
    "Supervisor",
]


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Fault detection and recovery policy (hashable; rides
    ``ExecutionConfig.resilience``).

    Attributes:
      sentinel: run the step's gate: the step reports a one-scalar
        ``sentinel_trip`` flag from quantities it already holds (the loss and
        the global gradient norm) and skips the optimizer update and the
        carry write when it trips. An untripped run is bit for bit a
        sentinel-off run.
      max_grad_norm: global-gradient-norm explosion threshold of the gate
        (a non-finite loss or gradient always trips).
      spike_factor: host-side loss-spike EMA: trip when the fetched loss
        exceeds ``spike_factor x EMA(loss)`` after ``warmup_steps`` clean
        steps (faulty losses never update the EMA).
      ema_decay: EMA decay of the loss tracker.
      warmup_steps: clean steps before spike detection arms.
      escalate_steps: K, the steps that run the *exact* (budget=None) bucket
        after a trip, through the same prebuilt-bucket switching the
        Controller protocol uses (no step is built mid-run).
      rollback_after: M, the consecutive trips before the sentinel gives up
        on escalation and raises :class:`RollbackRequired` (0 disables).
      max_recoveries: the supervisor's retry budget across rollbacks before
        the original fault is re-raised.
      min_snr: optional probe-SNR floor (requires telemetry probes); a
        fetched ``probe_snr`` below it counts as a trip.
    """

    sentinel: bool = True
    max_grad_norm: float = 1e3
    spike_factor: float = 8.0
    ema_decay: float = 0.9
    warmup_steps: int = 5
    escalate_steps: int = 4
    rollback_after: int = 3
    max_recoveries: int = 8
    min_snr: Optional[float] = None

    def __post_init__(self):
        if self.max_grad_norm <= 0:
            raise ValueError(f"max_grad_norm must be > 0, got {self.max_grad_norm}")
        if self.spike_factor <= 1.0:
            raise ValueError(f"spike_factor must be > 1, got {self.spike_factor}")
        if not (0.0 < self.ema_decay < 1.0):
            raise ValueError(f"ema_decay must be in (0, 1), got {self.ema_decay}")
        for name in ("warmup_steps", "escalate_steps", "rollback_after", "max_recoveries"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")

    def replace(self, **kw) -> "ResilienceConfig":
        return dataclasses.replace(self, **kw)


def __getattr__(name):
    # Supervisor imports the trainer (which imports repro_torch.api); loading
    # it lazily keeps `repro_torch.api -> repro_torch.resilience` acyclic.
    if name == "Supervisor":
        from repro_torch.resilience.supervisor import Supervisor

        return Supervisor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
