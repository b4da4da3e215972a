"""The Runtime: the front door for sketched training (port of
``repro/api/runtime.py``, training under a constant budget).

``Runtime(policy=..., device="cuda").train(cfg, opt, data, steps=...)`` runs
the sketched training loop on the card. The device resolves when the Runtime
is built: without a card, ``device="cuda"`` raises ``RuntimeError``.
Budget schedules and serving are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from repro_torch.api.execution import ExecutionConfig
from repro_torch.core import SketchPolicy
from repro_torch.device import resolve_device

__all__ = ["Runtime"]


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Sketched-backprop runtime: what to estimate (``policy``), how
    (``execution``) and where (``device``, default the card)."""

    policy: Optional[SketchPolicy] = None
    execution: ExecutionConfig = dataclasses.field(default_factory=ExecutionConfig)
    device: torch.device | str = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def ctx(self, key=None, *, n_layers: int = 1):
        """A :class:`~repro_torch.nn.common.Ctx` for hand-driven model calls
        (``key``: the step's integer seed)."""
        return self.execution.make_ctx(policy=self.policy, key=key, n_layers=n_layers)

    def init_state(self, seed: int, cfg, opt, *, params=None):
        from repro_torch.train.train_step import init_state

        return init_state(seed, cfg, opt, params=params, device=self.device)

    def train_step(self, cfg, opt) -> Callable:
        """``step_fn(state, batch, key) -> (state, metrics)`` for this runtime."""
        from repro_torch.train.train_step import make_train_step

        return make_train_step(cfg, opt, self.policy, execution=self.execution,
                               device=self.device)

    def train(self, cfg, opt, data: Iterable, *, steps: int, log_every: int = 10,
              seed: int = 0, state=None, on_metrics: Optional[Callable] = None):
        """Run the training loop; returns ``(final_state, history)``."""
        from repro_torch.train import trainer

        return trainer.train_loop(self, cfg, opt, data, steps=steps,
                                  log_every=log_every, seed=seed, state=state,
                                  on_metrics=on_metrics)
