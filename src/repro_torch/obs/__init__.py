"""repro_torch.obs: execution observability (port of ``repro/obs``).

``repro_torch.telemetry`` instruments the numerical half of the paper's
trade-off (per-site variance probes); this package instruments the execution
half, where wall time and device memory go, across training and serving:

* :mod:`~repro_torch.obs.tracing`: nestable wall-clock spans, Chrome-trace
  and JSONL export, per-request lifecycles;
* :mod:`~repro_torch.obs.metrics`: one Counter/Gauge/Histogram registry
  behind the serving engines' counters, snapshots and Prometheus text;
* :mod:`~repro_torch.obs.ledgers`: the compile ledger (each built train
  step's first-call time and the step-cache hits) and the memory ledger (the
  CUDA allocator around that first call, live ``torch.cuda.memory_stats``);
* :mod:`~repro_torch.obs.flight`: the bounded recent-history ring dumped as a
  crash bundle;
* :mod:`~repro_torch.obs.clock`: the one wall-clock source.

:class:`ObsConfig` is the static, hashable switchboard on
:class:`repro_torch.api.ExecutionConfig` (``ExecutionConfig.obs``, like
``telemetry``). Because it is hashable and equal by value,
:func:`observability` returns one shared mutable :class:`Observability` per
distinct config, so a Runtime, its trainer and its serving engines feed one
tracer, registry and ledger set. ``None`` (the default) gives the
:data:`NULL_OBS` singleton: the null tracer, no registries, nothing on the
hot paths. See docs/port.md, "Observability".
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import clock  # noqa: F401  (re-export: the one clock)
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.ledgers import CompileLedger, MemoryLedger
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import NULL_TRACER, Tracer

__all__ = ["ObsConfig", "Observability", "observability", "NULL_OBS"]


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Static observability switchboard (frozen and hashable: it rides on
    ExecutionConfig, which is part of the Runtime's step-cache key).

    Attributes:
      trace: record wall-clock spans on the instrumented paths (the
        trainer's loop, steps, first calls and checkpoint waits and writes;
        the serving engine's run, waves, decode steps and request
        lifecycles).
      metrics: route counters and gauges through the shared registry (the
        engines' ``counters`` work either way: off, each engine's registry
        is private and nothing exports it).
      compile_ledger / memory_ledger: record each step built through
        ``Runtime.train_step``: its first call's synced wall time and the
        step-cache hits / the CUDA allocator around that first call
        (``ledgers.first_call_memory``).
      flight: keep the bounded recent-history ring and allow crash bundles.
      annotate: additionally open a ``torch.profiler.record_function``
        range per span (shows in ``torch.profiler`` traces; off by default).
      trace_capacity / flight_capacity: ring sizes (completed spans /
        noted events).
      chrome_trace / trace_jsonl: optional export paths written by
        ``Observability.export()`` (the trainer calls it at the end of its
        loop, the continuous engine at the end of each ``run``).
      crash_dir: directory for flight-recorder crash bundles; ``None``
        disables dumping (the ring still fills).
    """

    trace: bool = True
    metrics: bool = True
    compile_ledger: bool = True
    memory_ledger: bool = True
    flight: bool = True
    annotate: bool = False
    trace_capacity: int = 4096
    flight_capacity: int = 256
    chrome_trace: Optional[str] = None
    trace_jsonl: Optional[str] = None
    crash_dir: Optional[str] = None

    def __post_init__(self):
        if self.trace_capacity < 1:
            raise ValueError(f"trace_capacity must be >= 1, got "
                             f"{self.trace_capacity}")
        if self.flight_capacity < 1:
            raise ValueError(f"flight_capacity must be >= 1, got "
                             f"{self.flight_capacity}")


class Observability:
    """The mutable observability state for one :class:`ObsConfig`.

    Shared by every component constructed from an equal config (see
    :func:`observability`); ``NULL_OBS`` is the disabled singleton.
    """

    def __init__(self, cfg: Optional[ObsConfig]):
        self.cfg = cfg
        self.enabled = cfg is not None
        trace_on = self.enabled and cfg.trace
        self.tracer = (Tracer(cfg.trace_capacity, annotate=cfg.annotate)
                       if trace_on else NULL_TRACER)
        self.metrics = MetricsRegistry() if (self.enabled and cfg.metrics) else None
        self.compile_ledger = (CompileLedger()
                               if self.enabled and cfg.compile_ledger else None)
        self.memory_ledger = (MemoryLedger()
                              if self.enabled and cfg.memory_ledger else None)
        self.flight = (FlightRecorder(self.tracer if trace_on else None,
                                      self.metrics,
                                      capacity=cfg.flight_capacity)
                       if self.enabled and cfg.flight else None)
        # (name, registry) pairs adopted from components with several
        # instances: each serving engine owns its counters and registers
        # them here, so report() and prometheus() see them
        self.components: List[Tuple[str, MetricsRegistry]] = []

    # -- component registries ----------------------------------------------

    def adopt(self, name: str, registry: MetricsRegistry) -> None:
        if self.enabled:
            self.components.append((name, registry))

    def _registries(self) -> List[Tuple[str, MetricsRegistry]]:
        regs: List[Tuple[str, MetricsRegistry]] = []
        if self.metrics is not None:
            regs.append(("", self.metrics))
        regs.extend(self.components)
        return regs

    def metrics_snapshot(self) -> dict:
        """Merged flat snapshot across the root registry and every adopted
        component registry (later duplicates get ``#<n>`` suffixes)."""
        out: Dict[str, object] = {}
        for _, reg in self._registries():
            for k, v in reg.snapshot().items():
                key, n = k, 1
                while key in out:
                    key = f"{k}#{n}"
                    n += 1
                out[key] = v
        return out

    def prometheus(self) -> str:
        return "".join(reg.to_prometheus() for _, reg in self._registries())

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        """One JSON-ready dict: compile hit/miss, per-step memory, metrics
        (read it through ``Runtime.observability().report()``)."""
        if not self.enabled:
            return {"enabled": False}
        out: Dict[str, object] = {"enabled": True}
        if self.compile_ledger is not None:
            out["compile"] = self.compile_ledger.to_json()
        if self.memory_ledger is not None:
            out["memory"] = self.memory_ledger.to_json()
        out["metrics"] = self.metrics_snapshot()
        out["n_spans"] = len(self.tracer.spans())
        return out

    def export(self) -> List[str]:
        """Write the configured trace exports; returns the paths written."""
        paths = []
        if self.enabled and self.tracer.enabled:
            if self.cfg.chrome_trace:
                paths.append(self.tracer.export_chrome(self.cfg.chrome_trace))
            if self.cfg.trace_jsonl:
                paths.append(self.tracer.export_jsonl(self.cfg.trace_jsonl))
        return paths

    def dump_crash(self, reason: str, extra: Optional[dict] = None) -> Optional[str]:
        """Flight-recorder crash bundle (None when flight recording or
        ``crash_dir`` is off, so callers need no guards)."""
        if self.flight is None or not self.cfg.crash_dir:
            return None
        return self.flight.dump(self.cfg.crash_dir, reason, extra)


NULL_OBS = Observability(None)

# One shared Observability per distinct ObsConfig, the keyed-state idiom of the
# Runtime step cache (module level, so equal configs share state).
_OBS: Dict[ObsConfig, Observability] = {}


def observability(cfg: Optional[ObsConfig]) -> Observability:
    """The shared :class:`Observability` for ``cfg`` (``NULL_OBS`` for None)."""
    if cfg is None:
        return NULL_OBS
    ob = _OBS.get(cfg)
    if ob is None:
        ob = _OBS[cfg] = Observability(cfg)
    return ob


def _reset() -> None:  # test hook
    _OBS.clear()
