"""Execution configuration (port of ``repro/api/execution.py``).

The JAX config also carries the mesh and the shardings, which are not ported
yet. This one holds compact gradients, the accumulation count, telemetry,
resilience and observability, and is the one factory for
:class:`~repro_torch.nn.common.Ctx` outside the nn substrate.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["ExecutionConfig"]


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Static execution environment of one Runtime (single device, local plan).

    Attributes:
      compact_grads: keep sketched dW compact (rows + indices) from the
        backward through clipping into row-sparse optimizer updates
        (``core/compact_grad.py``; requires ``accum == 1``).
      accum: gradient-accumulation microbatch count: the step splits its
        batch on axis 0 and averages the microbatches' losses, gradients and
        refreshed plan carries (``train/train_step.py``).
      telemetry: a :class:`repro_torch.telemetry.TelemetryConfig` turning on
        the per-site probes and naming optional sinks; ``None`` (the
        default) turns telemetry off. Probes require ``accum == 1``.
      resilience: a :class:`repro_torch.resilience.ResilienceConfig`
        turning on the fault-handling plumbing: the step takes a
        ``fault_scale`` argument (fault injection without another step
        build) and, with ``sentinel=True``, skips the optimizer update when
        the loss or the gradient norm is non-finite or the norm explodes; a
        run where the sentinel never trips is bit for bit a resilience-off
        run. ``None`` (the default) builds the three-argument step.
      obs: a :class:`repro_torch.obs.ObsConfig` turning on spans, the
        metrics registry, the compile and memory ledgers and the flight
        recorder (``Runtime.observability()``); ``None`` (the default)
        turns them off.
    """

    compact_grads: bool = False
    accum: int = 1
    telemetry: Optional[Any] = None  # repro_torch.telemetry.TelemetryConfig
    resilience: Optional[Any] = None  # repro_torch.resilience.ResilienceConfig
    obs: Optional[Any] = None  # repro_torch.obs.ObsConfig

    def __post_init__(self):
        if self.accum < 1:
            raise ValueError(f"accum must be >= 1, got {self.accum}")
        if self.compact_grads and self.accum != 1:
            raise ValueError("compact_grads requires accum == 1 (compact index "
                             "sets differ per microbatch; accumulate densely)")
        if self.telemetry is not None and self.telemetry.probes and self.accum != 1:
            raise ValueError("telemetry probes require accum == 1 (probe vectors would "
                             "average across microbatch plans); use TelemetryConfig("
                             "probes=False) with accumulation")
        if self.resilience is not None and not hasattr(self.resilience, "sentinel"):
            raise ValueError("resilience must be a repro_torch.resilience.ResilienceConfig, "
                             f"got {self.resilience!r}")
        if self.obs is not None and not hasattr(self.obs, "trace_capacity"):
            raise ValueError(f"obs must be a repro_torch.obs.ObsConfig, got {self.obs!r}")

    def replace(self, **kw) -> "ExecutionConfig":
        return dataclasses.replace(self, **kw)

    def make_ctx(self, *, policy=None, key=None, layer_index: int = 0, n_layers: int = 1):
        """The per-call :class:`~repro_torch.nn.common.Ctx` (``key``: the
        integer seed sketched sites derive their generators from)."""
        from repro_torch.nn.common import Ctx

        return Ctx(policy=policy, key=key, layer_index=layer_index, n_layers=n_layers)
