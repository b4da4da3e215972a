"""The Runtime: the front door for sketched training and serving steps
(port of ``repro/api/runtime.py``).

A :class:`Runtime` bundles what to estimate (``policy``), how
(``execution``: compact gradients, accumulation, telemetry), when at which
budget (``schedule``, a :class:`~repro_torch.api.schedule.BudgetSchedule`)
and where (``device``, the card by default; without a card ``"cuda"`` raises
``RuntimeError`` when the Runtime is built).
``Runtime(policy, schedule=..., execution=...).train(cfg, opt, data,
TrainerConfig(...))`` runs the training loop (``train/trainer.py``);
``train_step(cfg, opt, budget=b)`` gives one bucket's step function;
``prefill_step`` and ``decode_step`` give the serving steps; ``ctx`` gives a
hand-driven loop its context (``budget=None``: exact, for evaluation), as the
paper's vision models take it. The serving engines (``Runtime.serve``) are
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import torch

from repro_torch.api.execution import ExecutionConfig
from repro_torch.api.schedule import BudgetSchedule
from repro_torch.core import SketchPolicy
from repro_torch.device import resolve_device

__all__ = ["Runtime"]


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
        bucket (see :class:`BudgetSchedule`): a new step function per call,
        so the trainer builds one per bucket before its loop."""
        from repro_torch.train.train_step import make_train_step

        return make_train_step(cfg, opt, self.policy_at(budget), execution=self.execution,
                               device=self.device)

    def train(self, cfg, opt, data: Iterable, tcfg=None, *, state=None,
              on_metrics: Optional[Callable] = None):
        """Run the training loop; returns ``(final_state, history)``.

        ``tcfg`` is a :class:`repro_torch.train.trainer.TrainerConfig` (steps,
        logging, checkpointing, seed); the policy, execution and budget
        schedule come from this Runtime."""
        from repro_torch.train import trainer

        return trainer.train_loop(self, cfg, opt, data, tcfg, state=state,
                                  on_metrics=on_metrics)

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
