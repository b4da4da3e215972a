"""Training loop (port of ``repro/train/trainer.py::train_loop``, under a
constant budget). Checkpointing, budget schedules, telemetry sinks and
resilience are not ported yet."""
from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

from repro_torch import rng
from repro_torch.configs.base import ArchConfig
from repro_torch.optim import Optimizer
from repro_torch.train.train_step import TrainState

__all__ = ["train_loop"]


def train_loop(runtime, cfg: ArchConfig, opt: Optimizer, data: Iterable, *,
               steps: int, log_every: int = 10, seed: int = 0,
               state: Optional[TrainState] = None,
               on_metrics: Optional[Callable] = None):
    """Run ``steps`` steps under ``runtime``; returns (final_state, history).

    Seeds follow the JAX loop: the state from ``fold_in(seed, 0)``, step ``s``
    from ``fold_in(seed, s + 1)``. Every ``log_every`` steps (and at the last)
    the metrics are fetched to the host — which waits for the card — and one
    record ``{step, loss, grad_norm, step_s}`` is appended to the history;
    ``step_s`` is the wall time from that step's call to its fetched metrics.
    """
    if state is None:
        state = runtime.init_state(rng.fold_in(seed, 0), cfg, opt)
    fn = runtime.train_step(cfg, opt)
    history = []
    data_it = iter(data)
    for step in range(state.step, steps):
        batch = next(data_it)
        t0 = time.perf_counter()
        state, metrics = fn(state, batch, rng.fold_in(seed, step + 1))
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=step, step_s=time.perf_counter() - t0)
            history.append(m)
            if on_metrics is not None:
                on_metrics(m)
            else:
                print(f"[trainer] step {step:6d} loss {m['loss']:.4f} "
                      f"({m['step_s'] * 1e3:.1f} ms)")
    return state, history
