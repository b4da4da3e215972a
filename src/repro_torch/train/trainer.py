"""Training loop: budget schedules, telemetry sinks, periodic async
checkpoints and auto-resume (port of ``repro/train/trainer.py``).

:func:`train_loop` is the Runtime's loop (``Runtime.train`` delegates here);
:func:`train` is the legacy keyword spelling, a shim that builds a Runtime
and warns once. With ``ExecutionConfig(obs=ObsConfig(...))`` the loop records
JAX's spans (``train_loop``, ``build_buckets``, ``train_step`` per step,
``ckpt_wait``; the checkpoint writer's ``ckpt_io_write``), counts
``train.steps``, sets the ``train.budget`` gauge and takes a flight-recorder
snapshot at every logged step, and exports the configured traces at the end.
The JAX loop's resilience hooks (``faults=``, ``seed_salt=``, ``on_event=``,
the sentinel, and the synchronous retry of a failed checkpoint write with its
``ckpt_save_sync`` span) come with the port's resilience slice.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Iterable, Optional

import torch

from repro_torch import rng
from repro_torch.api import Runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.core import SketchPolicy
from repro_torch.obs import clock, observability
from repro_torch.optim import Optimizer
from repro_torch.telemetry import sinks as tsinks
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


def _policy_can_probe(policy) -> bool:
    """Does any site of ``policy`` emit telemetry probes? (a column-family
    method and an estimator with the probe hook, on a ``location="all"``
    policy)"""
    from repro_torch.telemetry.probes import probe_capable

    if policy is None or policy.location != "all":
        return False
    return probe_capable(policy.base) or any(probe_capable(cfg) for _, cfg in policy.overrides)


def train_loop(runtime: Runtime, cfg: ArchConfig, opt: Optimizer, data: Iterable,
               tcfg: Optional[TrainerConfig] = None, *, state: Optional[TrainState] = None,
               on_metrics: Optional[Callable] = None):
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
    if schedule.is_adaptive and not _policy_can_probe(runtime.policy):
        warnings.warn("adaptive BudgetSchedule cannot measure gradient SNR here (exact or "
                      "location-restricted policy, or no probe-capable site: a column-family "
                      "method and an estimator with the probe hook); the controller will "
                      "hold its first bucket", stacklevel=2)
    ob = observability(runtime.execution.obs)
    tracer = ob.tracer
    traced = tracer.enabled
    if state is None:
        state = runtime.init_state(rng.fold_in(tcfg.seed, 0), cfg, opt)
    ckpt = (CheckpointManager(tcfg.ckpt_dir, tcfg.ckpt_every, tracer=tracer)
            if tcfg.ckpt_dir else None)
    if ckpt is not None:
        restored = ckpt.restore_or_none(state, device=runtime.device)
        if restored is not None:
            state, step0 = restored
            print(f"[trainer] resumed from step {step0}")

    # one step function per bucket, all built before the first step
    buckets = schedule.buckets()
    with tracer.span("build_buckets", n_buckets=len(buckets)):
        steps_by_budget = {b: runtime.train_step(cfg, opt, budget=b) for b in buckets}
    controller = schedule.make_controller(policy=runtime.policy)
    fetch_each_step = bool(controller is not None and getattr(controller, "wants_metrics", False))
    sink = tsinks.build_sinks(tel)
    reg = ob.metrics
    steps_counter = reg.counter("train.steps") if reg is not None else None
    budget_gauge = reg.gauge("train.budget") if reg is not None else None
    history = []
    data_it = iter(data)
    try:
        with tracer.span("train_loop", start_step=state.step, steps=tcfg.steps):
            for step in range(state.step, tcfg.steps):
                batch = next(data_it)
                budget = controller.budget if controller else schedule.budget_at(step)
                fn = steps_by_budget[budget]
                if controller:
                    controller.step_begin()
                t0 = clock.now()
                if traced:
                    # the attrs are built on the traced path only
                    with tracer.span("train_step", step=step,
                                     budget=-1.0 if budget is None else budget):
                        state, metrics = fn(state, batch, rng.fold_in(tcfg.seed, step + 1))
                else:
                    state, metrics = fn(state, batch, rng.fold_in(tcfg.seed, step + 1))
                if steps_counter is not None:
                    steps_counter.inc()
                host_m = host_scalars = None
                if controller:
                    # the scalars only: per-site vectors wait for the sink or log
                    if fetch_each_step:
                        host_scalars = _host_metrics(metrics, scalars_only=True)
                    elif runtime.device.type == "cuda":
                        torch.cuda.synchronize(runtime.device)  # the step's time
                    controller.step_end(host_scalars)
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
                    ckpt.maybe_save(step + 1, state)
            if ckpt is not None:
                with tracer.span("ckpt_wait"):
                    ckpt.wait()
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
