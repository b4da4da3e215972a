"""Retry and rollback orchestrator: the outermost loop of a resilient run
(port of ``repro/resilience/supervisor.py``, one device).

:class:`Supervisor` wraps ``trainer.train_loop`` and owns the recovery the
sentinel cannot do alone:

  * :class:`~repro_torch.resilience.sentinel.RollbackRequired` (M
    consecutive trips: escalation to the exact bucket did not help):
    restore the newest *verified* checkpoint (CRC-checked; ``train_loop``
    auto-resumes) and retry with a per-attempt seed salt, so the retried
    trajectory *resamples* every sketch: a rare bad index draw cannot recur.
  * :class:`~repro_torch.resilience.faults.DeviceLossFault`: JAX re-shards
    the newest checkpoint onto the surviving mesh. That needs a mesh, which
    the port does not have yet; the port's supervisor dumps the
    ``device_loss`` crash bundle and re-raises the fault unchanged, as JAX
    does when it has no checkpoint directory (docs/port.md).

Every recovery is recorded (cause, steps lost, wall-time cost) through the
runtime's telemetry sinks and kept on ``Supervisor.events``;
``benchmarks/torch/bench_resilience.py`` distills them into the wasted-work
fraction and steps-to-recover.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

from repro_torch.obs import clock, observability
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.resilience.faults import DeviceLossFault, FaultInjector
from repro_torch.resilience.sentinel import RollbackRequired

__all__ = ["Supervisor"]


class Supervisor:
    """Run ``train_loop`` to completion across rollbacks.

    ``runtime.execution.resilience`` must be set (a default
    :class:`~repro_torch.resilience.ResilienceConfig` is installed if
    absent: the supervisor is pointless without the sentinel and the fault
    plumbing). Rollback recovery requires ``tcfg.ckpt_dir``; without one, a
    rollback restarts from scratch (recorded as such).
    """

    def __init__(self, runtime, cfg, opt, tcfg, *, fault_plan=None):
        from repro_torch.resilience import ResilienceConfig

        if runtime.execution.resilience is None:
            runtime = runtime.replace(execution=runtime.execution.replace(
                resilience=ResilienceConfig()))
        self.runtime = runtime
        self.cfg = cfg
        self.opt = opt
        self.tcfg = tcfg
        self.injector = FaultInjector.wrap(fault_plan)
        self.events: list = []
        # the recovery counters live in a registry the runtime's
        # observability adopts; `recoveries` reads and sets it as an int
        self._ob = observability(runtime.execution.obs)
        self.metrics = MetricsRegistry()
        if self._ob.metrics is not None:
            self._ob.adopt("resilience", self.metrics)
        self._recoveries = self.metrics.counter("resilience.recoveries")
        self._event_count = self.metrics.counter("resilience.events")

    @property
    def recoveries(self) -> int:
        return int(self._recoveries.value)

    @recoveries.setter
    def recoveries(self, v: int) -> None:
        self._recoveries.set(v)

    def _record(self, rec: dict, sink=None):
        self.events.append(dict(rec))
        self._event_count.inc()
        if self._ob.flight is not None:
            self._ob.flight.note(rec)
        if sink is not None:
            sink.write(dict(rec))

    def run(self, data: Iterable, *, state=None, on_metrics: Optional[Callable] = None):
        """Returns ``(final_state, history)``, the history stitched across
        attempts; the recovery events are on ``self.events`` and the sinks.

        A retry starts after the ``except`` block that handled the fault has
        ended: until then the exception's traceback holds the failed
        attempt's frame, and its state on the device with it."""
        from repro_torch.telemetry import sinks as tsinks
        from repro_torch.train import checkpoint as ckptlib
        from repro_torch.train import trainer

        rcfg = self.runtime.execution.resilience
        sink = tsinks.build_sinks(self.runtime.execution.telemetry)
        tracer = self._ob.tracer
        history: list = []
        attempt = 0
        try:
            while True:
                try:
                    state, hist = trainer.train_loop(
                        self.runtime, self.cfg, self.opt, data, self.tcfg, state=state,
                        faults=self.injector, seed_salt=attempt,
                        on_event=self.events.append, on_metrics=on_metrics)
                    history.extend(hist)
                    return state, history
                except RollbackRequired as e:
                    history.extend(e.history)
                    self._ob.dump_crash("rollback", {"step": e.step, "cause": e.cause,
                                                     "attempt": attempt})
                    self._bump(e, rcfg)
                    attempt += 1
                    with tracer.span("recovery.rollback", step=e.step, cause=e.cause):
                        t0 = clock.now()
                        resume = (ckptlib.latest_verified_step(self.tcfg.ckpt_dir)
                                  if self.tcfg.ckpt_dir else None)
                        state = None  # train_loop restores the verified step or starts anew
                        self._record(tsinks.recovery_record(
                            "rollback", step=e.step, cause=e.cause,
                            resume_step=int(resume or 0),
                            steps_lost=e.step + 1 - int(resume or 0),
                            wall_s=clock.now() - t0), sink)
                except DeviceLossFault as e:
                    # re-sharding needs a mesh (the port's distributed slice)
                    self._ob.dump_crash("device_loss", {
                        "step": e.step, "mesh_shape": list(e.mesh_shape), "attempt": attempt})
                    raise
                except ckptlib.CheckpointError as e:
                    # unrecoverable inside train_loop (the synchronous retry failed too)
                    self._ob.dump_crash("checkpoint_error", {"error": str(e)})
                    raise
        finally:
            if sink is not None:
                sink.close()

    def _bump(self, exc, rcfg):
        self.recoveries += 1
        if self.recoveries > rcfg.max_recoveries:
            raise RuntimeError(
                f"supervisor exceeded max_recoveries={rcfg.max_recoveries}") from exc
