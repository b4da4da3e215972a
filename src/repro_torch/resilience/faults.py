"""Seeded, declarative fault injection for the training loop (a copy of
``repro/resilience/faults.py``: numpy and plain Python).

A :class:`FaultPlan` maps step indices to :class:`FaultSpec` s; the trainer
consumes it through a :class:`FaultInjector`, which marks each fault as
fired exactly once — so a retried trajectory (after a rollback restores an
earlier step) does not re-trip the same injected fault forever.

Fault kinds (JAX's docs/resilience.md has the taxonomy):

  * ``nonfinite``   — the step's ``fault_scale`` becomes NaN, poisoning the
    loss and every cotangent (the non-finite-gradient class).
  * ``spike``       — ``fault_scale = scale`` (large, finite): a loss spike
    with exploding-but-finite gradients.
  * ``slow``        — host-side sleep before the step (straggler class; the
    reactive Controller is the mitigation, not the sentinel).
  * ``ckpt_io``     — the next async checkpoint write raises in the writer
    thread (surfaces as CheckpointError on the next wait).
  * ``device_loss`` — raise :class:`DeviceLossFault` before the step. JAX's
    supervisor re-shards onto the surviving ``mesh_shape``; the port has no
    mesh yet, and its supervisor re-raises the fault (docs/port.md).

Both the declarative spelling (``FaultPlan(faults=(...,))``) and a seeded
random generator (:meth:`FaultPlan.random`) are deterministic: the same
plan yields the same drill on every run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["FaultSpec", "FaultPlan", "FaultInjector", "DeviceLossFault",
           "KINDS"]

KINDS = ("nonfinite", "spike", "slow", "ckpt_io", "device_loss")

#: fault kinds that perturb the step numerically via ``fault_scale``
SOFT_KINDS = ("nonfinite", "spike")


class DeviceLossFault(RuntimeError):
    """Simulated loss of devices mid-run (a mesh-shrink trigger).

    Carries everything the supervisor needs to recover: the step it fired
    at, the surviving mesh shape, the history accumulated so far, and the
    (structurally intact) last state as a restore template.
    """

    def __init__(self, step: int, mesh_shape: Tuple[int, ...], *,
                 history=None, state=None):
        super().__init__(f"device loss at step {step} "
                         f"(surviving mesh shape {mesh_shape})")
        self.step = int(step)
        self.mesh_shape = tuple(int(s) for s in mesh_shape)
        self.history = list(history or [])
        self.state = state


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected fault: what happens at ``step``."""

    step: int
    kind: str
    scale: float = 1e4          # spike: fault_scale multiplier on the loss
    sleep_s: float = 0.05       # slow: host-side stall duration
    mesh_shape: Tuple[int, ...] = ()  # device_loss: surviving mesh shape

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.kind == "spike" and not (np.isfinite(self.scale)
                                         and self.scale > 1.0):
            raise ValueError(f"spike scale must be finite and > 1, "
                             f"got {self.scale}")
        if self.kind == "device_loss" and not self.mesh_shape:
            raise ValueError("device_loss fault needs the surviving "
                             "mesh_shape")
        object.__setattr__(self, "mesh_shape",
                           tuple(int(s) for s in self.mesh_shape))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative step -> fault mapping (at most one fault per step)."""

    faults: Tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        specs = tuple(sorted(self.faults, key=lambda f: f.step))
        steps = [f.step for f in specs]
        if len(set(steps)) != len(steps):
            dupes = sorted({s for s in steps if steps.count(s) > 1})
            raise ValueError(f"multiple faults on step(s) {dupes}; "
                             "one fault per step")
        object.__setattr__(self, "faults", specs)

    def at(self, step: int) -> Optional[FaultSpec]:
        for f in self.faults:
            if f.step == step:
                return f
        return None

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(f.kind for f in self.faults))

    @classmethod
    def random(cls, seed: int, steps: int, *, kinds: Tuple[str, ...] = SOFT_KINDS,
               n: int = 3, min_step: int = 1) -> "FaultPlan":
        """``n`` faults at seeded-random distinct steps in
        ``[min_step, steps)``, kinds cycling through ``kinds``."""
        if steps - min_step < n:
            raise ValueError(f"cannot place {n} faults in "
                             f"[{min_step}, {steps})")
        rng = np.random.default_rng(seed)
        where = rng.choice(np.arange(min_step, steps), size=n, replace=False)
        return cls(faults=tuple(
            FaultSpec(step=int(s), kind=kinds[i % len(kinds)])
            for i, s in enumerate(sorted(where))))

    @classmethod
    def drill(cls, *, ckpt_every: int = 5, mesh_shape: Tuple[int, ...] = ()
              ) -> "FaultPlan":
        """The canned acceptance drill: one fault of every soft/IO kind (plus
        ``device_loss`` when a surviving ``mesh_shape`` is given), laid out
        so each recovery path fires — a lone non-finite step (escalation), a
        loss spike, an injected checkpoint-write failure on a save step, and
        a non-finite burst long enough to force a rollback."""
        k = int(ckpt_every)
        faults = [
            FaultSpec(step=2 * k - 1, kind="ckpt_io"),      # arms save(2k)
            FaultSpec(step=2 * k + 1, kind="nonfinite"),    # 1 trip -> escalate
            FaultSpec(step=3 * k + 1, kind="spike"),
            # M=3 consecutive trips -> RollbackRequired -> restore
            FaultSpec(step=4 * k + 0, kind="nonfinite"),
            FaultSpec(step=4 * k + 1, kind="nonfinite"),
            FaultSpec(step=4 * k + 2, kind="nonfinite"),
        ]
        if mesh_shape:
            faults.append(FaultSpec(step=6 * k, kind="device_loss",
                                    mesh_shape=tuple(mesh_shape)))
        return cls(faults=tuple(faults))


class FaultInjector:
    """Stateful, fire-once view of a :class:`FaultPlan`.

    The supervisor owns one injector across retry attempts: after a
    rollback replays steps the plan already faulted, ``take`` returns None
    for the spent entries and the retried trajectory runs clean.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._armed: Dict[int, FaultSpec] = {f.step: f for f in plan.faults}
        self.fired: list = []

    @classmethod
    def wrap(cls, faults) -> Optional["FaultInjector"]:
        if faults is None or isinstance(faults, cls):
            return faults
        return cls(faults)

    def take(self, step: int) -> Optional[FaultSpec]:
        f = self._armed.pop(step, None)
        if f is not None:
            self.fired.append(f)
        return f

    @property
    def pending(self) -> int:
        return len(self._armed)
