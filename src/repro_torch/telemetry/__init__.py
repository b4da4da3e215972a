"""Telemetry of the port: per-site probes, sinks and the adaptive budget
controller (port of ``repro/telemetry``).

* :mod:`repro_torch.telemetry.probes` — per-site estimates of the sketched
  weight gradient's variance, squared norm and alignment, computed in the
  backward from the kept dW rows and the plan's keep marginals (no second
  backward, no extra pass over G) and carried out of ``torch.autograd.grad``
  as the gradient of a per-step probe slot.
* :mod:`repro_torch.telemetry.sinks` — JSONL / CSV writers, an in-memory
  ring, and the static per-site backward-FLOP table.
* :mod:`repro_torch.telemetry.controller` — the closed-loop controller that
  picks the cheapest pre-built budget bucket meeting a target gradient SNR
  (``BudgetSchedule.adaptive``).

:class:`TelemetryConfig` rides on
:class:`repro_torch.api.ExecutionConfig` (``ExecutionConfig.telemetry``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["TelemetryConfig"]


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Static telemetry switchboard (frozen and hashable).

    Attributes:
      probes: add per-site probe slots to every step (requires
        ``accum == 1``).
      per_site: put the per-site probe vectors in the step's metrics
        (``metrics["probe_sites"]``) beside the step's summary scalars
        (``probe_gsq``, ``probe_var``, ``probe_snr``, ``probe_align``).
      jsonl / csv: optional output paths; the trainer builds the matching
        sinks and writes one record every ``interval`` steps.
      interval: the sinks' write cadence in steps.
    """

    probes: bool = True
    per_site: bool = True
    jsonl: Optional[str] = None
    csv: Optional[str] = None
    interval: int = 1

    def __post_init__(self):
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")
