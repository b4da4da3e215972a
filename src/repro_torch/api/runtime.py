"""The Runtime: the front door for sketched training and serving steps
(port of ``repro/api/runtime.py``).

A :class:`Runtime` bundles what to estimate (``policy``), how
(``execution``: compact gradients, accumulation, telemetry), when at which
budget (``schedule``, a :class:`~repro_torch.api.schedule.BudgetSchedule`)
and where (``device``, the card by default; without a card ``"cuda"`` raises
``RuntimeError`` when the Runtime is built).
``Runtime(policy, schedule=..., execution=...).train(cfg, opt, data,
TrainerConfig(...))`` runs the training loop (``train/trainer.py``);
``train_step(cfg, opt, budget=b)`` gives one bucket's step function, cached
on ``(runtime, cfg, opt, budget)`` as in JAX; ``serve(params, cfg,
serve=ServeConfig(...))`` gives the continuous-batching engine
(``serve/engine.py``), ``prefill_step`` and ``decode_step`` the steps under
it; ``observability()`` the shared spans, metrics and ledgers of
``execution.obs``; ``ctx`` gives a hand-driven loop its context
(``budget=None``: exact, for evaluation), as the paper's vision models take
it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.api.execution import ExecutionConfig
from repro_torch.api.schedule import BudgetSchedule
from repro_torch.core import SketchPolicy
from repro_torch.device import resolve_device

__all__ = ["Runtime"]

# Step cache: (runtime, cfg, opt, budget) -> step function. Module level, so
# equal Runtimes share steps; LRU-bounded, since an Optimizer hashes by its
# closures' identity and a sweep that rebuilds optimizers would otherwise pin
# every step. A step function holds no state between calls (the gradient,
# probe and carry slots are made per call), so handing one out twice is safe.
_STEP_CACHE: Dict[Tuple, Callable] = {}
_STEP_CACHE_MAX = 64


def _cache_get(key):
    fn = _STEP_CACHE.pop(key, None)
    if fn is not None:
        _STEP_CACHE[key] = fn  # re-insert: move to the LRU tail
    return fn


def _cache_put(key, fn):
    while len(_STEP_CACHE) >= _STEP_CACHE_MAX:
        _STEP_CACHE.pop(next(iter(_STEP_CACHE)))
    _STEP_CACHE[key] = fn


def _ledger_key(runtime, cfg, budget) -> str:
    """Readable spelling of one step-cache key for the compile ledger (the
    runtime's hash tells equal arch and budget under other policies apart)."""
    name = getattr(cfg, "name", type(cfg).__name__)
    return f"train_step/{name}/budget={budget}/rt={hash(runtime) & 0xffffffff:08x}"


def _with_ledger(fn, ob, lkey: str, device):
    """Wrap a built step so that its first call is timed (synced wall time,
    ``first_call_s``) under a ``first_call`` span and read by the allocator
    (``ledgers.first_call_memory``), into the shared ledgers. Eager PyTorch
    has no separate trace and compile to time: this is JAX's own fallback
    spelling. Host code only: the step's computation is unchanged."""
    from repro_torch.obs import clock, ledgers
    from repro_torch.obs.tracing import NULL_TRACER

    tracer = ob.tracer if ob is not None else NULL_TRACER
    first = [True]

    def step(*args, **kw):
        if not first[0]:
            return fn(*args, **kw)
        first[0] = False
        with tracer.span("first_call", key=lkey):
            t0 = clock.now()
            out, mem = ledgers.first_call_memory(lambda: fn(*args, **kw), device)
            first_s = clock.now() - t0
        _ledger_compile(ob, lkey, first_call_s=first_s, memory=mem)
        return out

    return step


def _ledger_compile(ob, lkey: str, *, first_call_s=None, memory=None):
    from repro_torch.obs import ledgers

    if ob is not None and ob.compile_ledger is not None:
        ob.compile_ledger.record_compile(lkey, first_call_s=first_call_s)
    if ob is not None and ob.memory_ledger is not None and memory is not None:
        ob.memory_ledger.record(lkey, memory)
        ob.memory_ledger.sample(lkey)
    if ledgers.global_active():
        ledgers.GLOBAL_COMPILE_LEDGER.record_compile(lkey, first_call_s=first_call_s)


def _ledger_hit(ob, lkey: str):
    from repro_torch.obs import ledgers

    if ob is not None and ob.compile_ledger is not None:
        ob.compile_ledger.record_hit(lkey)
    if ledgers.global_active():
        ledgers.GLOBAL_COMPILE_LEDGER.record_hit(lkey)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Sketched-backprop runtime: what to estimate (``policy``), how
    (``execution``), at which budget when (``schedule``) and where
    (``device``, default the card)."""

    policy: Optional[SketchPolicy] = None
    execution: ExecutionConfig = dataclasses.field(default_factory=ExecutionConfig)
    schedule: BudgetSchedule = dataclasses.field(default_factory=BudgetSchedule)
    device: torch.device | str = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def replace(self, **kw) -> "Runtime":
        return dataclasses.replace(self, **kw)

    def policy_at(self, budget: Optional[float] = 1.0) -> Optional[SketchPolicy]:
        """The effective policy at one budget: None is exact backprop, 1.0 the
        policy as configured, anything else the policy at that budget."""
        if budget is None or self.policy is None:
            return None
        if budget >= 1.0:
            return self.policy
        return self.policy.with_budget(budget)

    def ctx(self, key=None, *, budget: Optional[float] = 1.0, layer_index: int = 0,
            n_layers: int = 1):
        """A :class:`~repro_torch.nn.common.Ctx` for hand-driven model calls
        (``key``: the step's integer seed; ``budget=None``: exact, as for
        evaluation)."""
        return self.execution.make_ctx(policy=self.policy_at(budget), key=key,
                                       layer_index=layer_index, n_layers=n_layers)

    def init_state(self, seed: int, cfg, opt, *, params=None):
        from repro_torch.train.train_step import init_state

        # the policy lets plan-carry estimators seed their carry leaves
        return init_state(seed, cfg, opt, params=params, device=self.device,
                          policy=self.policy)

    def train_step(self, cfg, opt, *, budget: Optional[float] = 1.0) -> Callable:
        """``step_fn(state, batch, key) -> (state, metrics)`` of one budget
        bucket (see :class:`BudgetSchedule`); with ``execution.resilience``
        set, ``step_fn(state, batch, key, fault_scale)``.

        Cached on ``(runtime, cfg, opt, budget)``: the same Runtime gives the
        same step function, one build per schedule bucket, as JAX gives one
        compile. Without a policy every budget is the same exact step, so
        the budget leaves the key. With ``execution.obs`` ledgers on, a
        build and its first call are recorded in the compile and memory
        ledgers, and a cache hit in the compile ledger."""
        from repro_torch.obs import ledgers, observability

        if self.policy is None:
            budget = 1.0
        ob = observability(self.execution.obs)
        ledger_on = ob.compile_ledger is not None or ob.memory_ledger is not None
        global_on = ledgers.global_active()
        lkey = _ledger_key(self, cfg, budget) if (ledger_on or global_on) else None
        key = (self, cfg, opt, budget)
        try:
            hash(key)
        except TypeError:  # a field built from a list: build, uncached
            key = None
        fn = _cache_get(key) if key is not None else None
        if fn is not None:
            if lkey is not None:
                _ledger_hit(ob if ledger_on else None, lkey)
            return fn
        from repro_torch.train.train_step import make_train_step

        fn = make_train_step(cfg, opt, self.policy_at(budget), execution=self.execution,
                             device=self.device)
        if lkey is not None:
            fn = _with_ledger(fn, ob if ledger_on else None, lkey, self.device)
        if key is not None:
            _cache_put(key, fn)
        return fn

    def train(self, cfg, opt, data: Iterable, tcfg=None, *, state=None,
              on_metrics: Optional[Callable] = None):
        """Run the training loop; returns ``(final_state, history)``.

        ``tcfg`` is a :class:`repro_torch.train.trainer.TrainerConfig` (steps,
        logging, checkpointing, seed); the policy, execution and budget
        schedule come from this Runtime."""
        from repro_torch.train import trainer

        return trainer.train_loop(self, cfg, opt, data, tcfg, state=state,
                                  on_metrics=on_metrics)

    # -- observability ------------------------------------------------------

    def observability(self):
        """The shared :class:`repro_torch.obs.Observability` of
        ``execution.obs``: tracer, metrics registries, compile and memory
        ledgers (``.report()`` gives the JSON-ready rollup). The disabled
        singleton when ``obs`` is None."""
        from repro_torch.obs import observability

        return observability(self.execution.obs)

    # -- serving ------------------------------------------------------------

    def prefill_step(self, cfg, max_len: int) -> Callable:
        """``prefill_fn(params, batch) -> (logits, caches)`` on this runtime's
        device."""
        from repro_torch.serve.serve_step import make_prefill

        return make_prefill(cfg, max_len, execution=self.execution, device=self.device)

    def decode_step(self, cfg) -> Callable:
        """``decode_fn(params, caches, tokens, pos) -> (logits, caches)`` on
        this runtime's device."""
        from repro_torch.serve.serve_step import make_decode_step

        return make_decode_step(cfg, execution=self.execution, device=self.device)

    def serve(self, params, cfg, *, serve=None, batch: int = 4, max_len: int = 256):
        """A continuous-batching :class:`~repro_torch.serve.engine.Engine`
        whose prefill and decode steps run under this runtime's execution
        config, on its device.

        ``serve`` is a :class:`~repro_torch.serve.config.ServeConfig` (slot
        count, KV budget, paged-cache geometry, prefill buckets and packing,
        stop token); ``batch`` and ``max_len`` are the legacy spelling and
        build one."""
        from repro_torch.serve.engine import Engine

        return Engine(params, cfg, serve=serve, batch=batch, max_len=max_len, runtime=self)

    # -- migration ----------------------------------------------------------

    @classmethod
    def from_legacy_kwargs(cls, policy=None, *, compact_grads: bool = False, accum: int = 1,
                           straggler_budgets: Tuple[float, ...] = (),
                           schedule: Optional[BudgetSchedule] = None,
                           device="cuda") -> "Runtime":
        """The Runtime of the pre-Runtime keyword spelling (the JAX method's,
        without its mesh arguments): ``straggler_budgets`` becomes a reactive
        :class:`BudgetSchedule`."""
        if schedule is None:
            schedule = (BudgetSchedule.straggler(tuple(straggler_budgets))
                        if straggler_budgets else BudgetSchedule())
        return cls(policy=policy,
                   execution=ExecutionConfig(compact_grads=compact_grads, accum=accum),
                   schedule=schedule, device=device)
