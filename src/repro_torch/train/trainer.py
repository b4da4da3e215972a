"""Training loop: budget schedules, telemetry sinks, periodic async
checkpoints and auto-resume (port of ``repro/train/trainer.py``).

:func:`train_loop` is the Runtime's loop (``Runtime.train`` delegates here);
:func:`train` is the legacy keyword spelling, a shim that builds a Runtime
and warns once. With ``ExecutionConfig(obs=ObsConfig(...))`` the loop records
JAX's spans (``train_loop``, ``build_buckets``, ``train_step`` per step,
``ckpt_wait``; the checkpoint writer's ``ckpt_io_write``), counts
``train.steps``, sets the ``train.budget`` gauge and takes a flight-recorder
snapshot at every logged step, and exports the configured traces at the end.
With ``ExecutionConfig(resilience=ResilienceConfig())`` it runs JAX's
resilience hooks: injected faults (``faults=``, each under a
``fault_injected`` span), the gradient sentinel with its exact-bucket
escalation and ``RollbackRequired``, per-attempt seed salts
(``seed_salt=``), event records (``on_event=``, the sinks and the flight
recorder), and the synchronous retry of a failed checkpoint write under a
``ckpt_save_sync`` span with a ``ckpt_io`` crash bundle.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Iterable, Optional

import torch

from repro_torch import rng
from repro_torch.api import Runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.core import SketchPolicy
from repro_torch.data.pipeline import shard_batch
from repro_torch.obs import clock, observability
from repro_torch.optim import Optimizer
from repro_torch.telemetry import sinks as tsinks
from repro_torch.train import checkpoint as ckptlib
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import TrainState

__all__ = ["TrainerConfig", "train", "train_loop"]


@dataclasses.dataclass
class TrainerConfig:
    """Loop mechanics (steps, logging, checkpointing, seed); the model and
    estimator settings live on the Runtime.

    ``straggler_budgets`` is the legacy spelling of a reactive
    :class:`~repro_torch.api.BudgetSchedule`, honoured only by the legacy
    :func:`train` shim.
    """

    steps: int = 100
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    seed: int = 0
    straggler_budgets: tuple = ()  # legacy; use Runtime.schedule


def _host_metrics(metrics, *, scalars_only: bool = False) -> dict:
    """A metrics dict fetched to plain Python: scalars as floats, nested
    dicts (the per-site probe vectors) as lists of floats, or dropped with
    ``scalars_only`` (the controller's per-step fetch). One device-to-host
    copy per call, not one per key."""
    names, parts = [], []
    for k, v in metrics.items():
        if isinstance(v, dict):
            if not scalars_only:
                for kk, vv in v.items():
                    names.append((k, kk, vv.numel()))
                    parts.append(vv)
        else:
            names.append((k, None, 1))
            parts.append(v)
    if not parts:
        return {}
    flat = torch.cat([p.detach().reshape(-1).to(torch.float32) for p in parts]).cpu().tolist()
    out, i = {}, 0
    for k, kk, n in names:
        vals, i = flat[i:i + n], i + n
        if kk is None:
            out[k] = vals[0]
        else:
            out.setdefault(k, {})[kk] = vals
    return out


def _policy_can_probe(policy, execution=None) -> bool:
    """Does any site of ``policy`` emit telemetry probes? (a column-family
    method and an estimator with the probe hook, on a ``location="all"``
    policy; under ``tp_sketch`` on a mesh, a TP-shardable estimator, whose
    TP plans probe in the backward body)"""
    from repro_torch.core.site import tp_estimator
    from repro_torch.telemetry.probes import probe_capable

    if policy is None or policy.location != "all":
        return False
    tp = execution is not None and execution.tp_sketch and execution.mesh is not None

    def can(cfg):
        return probe_capable(cfg) or (tp and tp_estimator(cfg) is not None)

    return can(policy.base) or any(can(cfg) for _, cfg in policy.overrides)


def train_loop(runtime: Runtime, cfg: ArchConfig, opt: Optimizer, data: Iterable,
               tcfg: Optional[TrainerConfig] = None, *, state: Optional[TrainState] = None,
               on_metrics: Optional[Callable] = None, faults=None, seed_salt: int = 0,
               on_event: Optional[Callable] = None):
    """Run the loop under ``runtime``; returns ``(final_state, history)``.

    In JAX's order: resume from the newest verified checkpoint in
    ``tcfg.ckpt_dir`` (printing ``[trainer] resumed from step N``); build one
    step function per distinct budget of ``runtime.schedule.buckets()``
    before the loop; then per step, the budget from the schedule's
    controller (straggler or adaptive) or ``schedule.budget_at(step)``, the
    step under seed ``rng.fold_in(tcfg.seed, step + 1)`` (the state from
    ``fold_in(seed, 0)``), a fetch of the step's scalars only when the
    controller wants metrics (a host sync per step), a sink record every
    ``telemetry.interval`` steps, a history entry every ``log_every`` steps
    and at the last, and ``maybe_save(step + 1, state)``; at the end the
    pending checkpoint write is waited for.

    History entries (and ``on_metrics``'s argument) hold the step's metrics
    as floats with ``step``, ``budget`` and ``step_s``, the wall time from
    the step's call to its fetched metrics; sink records hold the metrics
    with ``step`` and ``budget``, as JAX writes them.

    An adaptive schedule implies probes: they are turned on here (with
    ``per_site=False`` when the runtime has no telemetry) and the controller
    reads ``probe_snr`` after every step. It raises with ``accum != 1`` and
    warns when no site of the policy can probe.

    Resilience (``runtime.execution.resilience`` set): the steps take a
    ``fault_scale``, and a :class:`~repro_torch.resilience.GradSentinel`
    reads the step's scalars after every step: a skipped update shows as
    ``sentinel_trip``, a trip runs the exact bucket (built with the others
    before the loop) for K steps, and M consecutive trips raise
    :class:`~repro_torch.resilience.RollbackRequired` for the supervisor,
    before the step's checkpoint. ``faults`` is a
    :class:`~repro_torch.resilience.FaultPlan` (or a supervisor's
    :class:`~repro_torch.resilience.FaultInjector`); it raises
    ``ValueError`` without ``resilience``. ``seed_salt`` folds one more term
    into every step seed, ``rng.fold_in(rng.fold_in(seed, step + 1),
    seed_salt)``, so a retried trajectory resamples its sketches; salt 0
    folds nothing, so the first attempt is bit for bit a resilience-off
    run. ``on_event`` receives every fault, trip and checkpoint-recovery
    record (they also go to the telemetry sinks and the flight recorder). A
    failed async checkpoint write raises
    :class:`~repro_torch.train.checkpoint.CheckpointError` without
    resilience; with it, the write is recorded and retried synchronously.
    """
    tcfg = tcfg or TrainerConfig()
    schedule = runtime.schedule
    tel = runtime.execution.telemetry
    if schedule.is_adaptive and runtime.execution.accum != 1:
        raise ValueError("adaptive BudgetSchedule requires accum == 1: the SNR probes "
                         "cannot ride accumulated microbatches, so the controller would "
                         "have no signal; use a fixed, warmup or reactive schedule with "
                         "accumulation")
    if schedule.is_adaptive and (tel is None or not tel.probes):
        from repro_torch.telemetry import TelemetryConfig

        # the controller reads only probe_snr: an implicit config skips the
        # per-site vectors (a given TelemetryConfig keeps its per_site)
        tel = (TelemetryConfig(per_site=False) if tel is None
               else dataclasses.replace(tel, probes=True))
        runtime = runtime.replace(execution=runtime.execution.replace(telemetry=tel))
    if schedule.is_adaptive and not _policy_can_probe(runtime.policy, runtime.execution):
        warnings.warn("adaptive BudgetSchedule cannot measure gradient SNR here (exact or "
                      "location-restricted policy, or no probe-capable site: a column-family "
                      "method and an estimator with the probe hook); the controller will "
                      "hold its first bucket", stacklevel=2)
    rcfg = runtime.execution.resilience
    if faults is not None and rcfg is None:
        raise ValueError("faults= requires runtime.execution.resilience (the step needs its "
                         "fault_scale argument); set ExecutionConfig(resilience="
                         "ResilienceConfig())")
    injector = sentinel = None
    if rcfg is not None:
        from repro_torch.resilience.faults import DeviceLossFault, FaultInjector
        from repro_torch.resilience.sentinel import GradSentinel, RollbackRequired

        injector = FaultInjector.wrap(faults)
        if rcfg.sentinel:
            sentinel = GradSentinel(rcfg)
    ob = observability(runtime.execution.obs)
    tracer = ob.tracer
    traced = tracer.enabled
    if state is None:
        state = runtime.init_state(rng.fold_in(tcfg.seed, 0), cfg, opt)
    mesh = runtime.execution.mesh
    ckpt = (CheckpointManager(tcfg.ckpt_dir, tcfg.ckpt_every, tracer=tracer, mesh=mesh)
            if tcfg.ckpt_dir else None)
    if ckpt is not None:
        shardings = None
        if mesh is not None:
            from repro_torch.train import elastic

            # every rank restores its own shard, whatever mesh saved it
            shardings = elastic.state_shardings(state, mesh)
        restored = ckpt.restore_or_none(state, device=runtime.device, shardings=shardings)
        if restored is not None:
            state, step0 = restored
            print(f"[trainer] resumed from step {step0}")

    # one step function per bucket, all built before the first step; the
    # sentinel's escalation target (exact, None) joins them when the
    # schedule alone would not build it
    buckets = schedule.buckets()
    if sentinel is not None and None not in buckets:
        buckets = buckets + (None,)
    with tracer.span("build_buckets", n_buckets=len(buckets)):
        steps_by_budget = {b: runtime.train_step(cfg, opt, budget=b) for b in buckets}
    controller = schedule.make_controller(policy=runtime.policy)
    fetch_each_step = bool(controller is not None and getattr(controller, "wants_metrics", False))
    sink = tsinks.build_sinks(tel)

    def emit(rec: dict):
        if sink is not None:
            sink.write(dict(rec))
        if on_event is not None:
            on_event(dict(rec))
        if ob.flight is not None:
            ob.flight.note(rec)

    def ckpt_wait_safe():
        # drain a pending async write before raising a recovery fault, so the
        # supervisor sees a settled directory (a write error is recorded: the
        # rollback target is the newest verified checkpoint anyway)
        if ckpt is None:
            return
        try:
            with tracer.span("ckpt_wait"):
                ckpt.wait()
        except ckptlib.CheckpointError as e:
            emit({"event": "ckpt_io_error", "step": step, "error": str(e)})
            ob.dump_crash("ckpt_io", {"step": step, "error": str(e)})

    def save_sync(at_step: int, logged_step: int, err):
        # a failed async write, retried synchronously: one recorded hiccup,
        # no lost checkpoint
        emit({"event": "ckpt_io_recovered", "step": logged_step, "error": str(err)})
        ob.dump_crash("ckpt_io", {"step": logged_step, "error": str(err)})
        with tracer.span("ckpt_save_sync", step=at_step):
            ckptlib.save(ckpt.dir, at_step, state, keep=ckpt.keep, mesh=mesh)

    reg = ob.metrics
    steps_counter = reg.counter("train.steps") if reg is not None else None
    budget_gauge = reg.gauge("train.budget") if reg is not None else None
    history = []
    data_it = iter(data)
    try:
        with tracer.span("train_loop", start_step=state.step, steps=tcfg.steps):
            for step in range(state.step, tcfg.steps):
                batch = next(data_it)
                if mesh is not None:
                    batch = shard_batch(batch, mesh=mesh)  # this rank's rows
                fscale = 1.0
                fault = injector.take(step) if injector is not None else None
                if fault is not None:
                    emit({"event": "fault_injected", "step": step, "kind": fault.kind})
                    with tracer.span("fault_injected", step=step, kind=fault.kind):
                        if fault.kind == "device_loss":
                            ckpt_wait_safe()
                            raise DeviceLossFault(step, fault.mesh_shape, history=history,
                                                  state=state)
                        if fault.kind == "slow":
                            time.sleep(fault.sleep_s)
                        elif fault.kind == "ckpt_io":
                            # under a mesh only rank 0 writes
                            if ckpt is not None and (mesh is None or mesh.rank == 0):
                                ckptlib.inject_fault_once()
                        elif fault.kind == "nonfinite":
                            fscale = float("nan")
                        elif fault.kind == "spike":
                            fscale = fault.scale
                key = rng.fold_in(tcfg.seed, step + 1)
                if seed_salt:
                    # a retried trajectory resamples its sketches; salt 0 folds
                    # nothing, so the first attempt is a resilience-off run
                    key = rng.fold_in(key, seed_salt)
                args = (state, batch, key) if rcfg is None else (state, batch, key, fscale)
                budget = controller.budget if controller else schedule.budget_at(step)
                if sentinel is not None:
                    budget = sentinel.override(budget)
                fn = steps_by_budget[budget]
                if controller:
                    controller.step_begin()
                t0 = clock.now()
                if traced:
                    # the attrs are built on the traced path only
                    with tracer.span("train_step", step=step,
                                     budget=-1.0 if budget is None else budget):
                        state, metrics = fn(*args)
                else:
                    state, metrics = fn(*args)
                if steps_counter is not None:
                    steps_counter.inc()
                host_m = host_scalars = None
                if fetch_each_step or sentinel is not None:
                    # the scalars only: per-site vectors wait for the sink or log
                    host_scalars = _host_metrics(metrics, scalars_only=True)
                elif controller and runtime.device.type == "cuda":
                    torch.cuda.synchronize(runtime.device)  # the step's time
                if controller:
                    controller.step_end(host_scalars if fetch_each_step else None)
                if sentinel is not None:
                    cause = sentinel.observe(step, host_scalars)
                    if cause is not None:
                        emit(tsinks.recovery_record(
                            "sentinel_trip", step=step, cause=cause,
                            escalate_steps=rcfg.escalate_steps,
                            consecutive=sentinel.consecutive))
                    if sentinel.should_rollback:
                        # before maybe_save: a state the sentinel cannot
                        # stabilise must never reach a checkpoint
                        ckpt_wait_safe()
                        raise RollbackRequired(step, sentinel.last_cause, history=history)
                if sink is not None and step % tel.interval == 0:
                    host_m = _host_metrics(metrics)
                    sink.write(dict(host_m, step=step, budget=budget))
                logged = step % tcfg.log_every == 0 or step == tcfg.steps - 1
                if budget_gauge is not None and logged:
                    budget_gauge.set(-1.0 if budget is None else budget)
                    if ob.flight is not None:
                        ob.flight.snapshot(step)
                if logged:
                    m = host_m if host_m is not None else _host_metrics(metrics)
                    m = dict(m, step=step, budget=budget, step_s=clock.now() - t0)
                    history.append(m)
                    if on_metrics:
                        on_metrics(m)
                    else:
                        b = "exact" if budget is None else f"{budget:.2f}"
                        print(f"[trainer] step {step:6d} loss {m['loss']:.4f} budget {b} "
                              f"({m['step_s'] * 1e3:.1f} ms)")
                if ckpt is not None:
                    try:
                        ckpt.maybe_save(step + 1, state)
                    except ckptlib.CheckpointError as e:
                        if rcfg is None:
                            raise
                        save_sync(step + 1, step, e)
            if ckpt is not None:
                try:
                    with tracer.span("ckpt_wait"):
                        ckpt.wait()
                except ckptlib.CheckpointError as e:
                    if rcfg is None:
                        raise
                    save_sync(tcfg.steps, tcfg.steps, e)
    finally:
        if sink is not None:
            sink.close()
        ob.export()
    return state, history


_warned_legacy = False


def train(cfg: ArchConfig, opt: Optimizer, data: Iterable, tcfg: TrainerConfig,
          policy: Optional[SketchPolicy] = None, *, compact_grads: bool = False,
          state: Optional[TrainState] = None, on_metrics: Optional[Callable] = None,
          device="cuda"):
    """Legacy entry point; prefer ``repro_torch.api.Runtime(...).train(...)``.

    Builds the Runtime of the keyword spelling (``tcfg.straggler_budgets``
    becomes a reactive :class:`~repro_torch.api.BudgetSchedule`) and runs
    :func:`train_loop`, so an old call takes the same steps as the equivalent
    Runtime. Warns ``DeprecationWarning`` once per process."""
    global _warned_legacy
    if not _warned_legacy:
        warnings.warn("repro_torch.train.trainer.train(...) with loose keywords is deprecated; "
                      "build a repro_torch.api.Runtime and call Runtime.train(...)",
                      DeprecationWarning, stacklevel=2)
        _warned_legacy = True
    straggler = (tuple(tcfg.straggler_budgets)
                 if (tcfg.straggler_budgets and policy is not None) else ())
    runtime = Runtime.from_legacy_kwargs(policy, compact_grads=compact_grads,
                                         straggler_budgets=straggler, device=device)
    return train_loop(runtime, cfg, opt, data, tcfg, state=state, on_metrics=on_metrics)
