"""Execution configuration (port of ``repro/api/execution.py``).

The JAX config carries the mesh, shardings, compact gradients, accumulation,
telemetry, resilience and observability; none of those is ported yet, so
this one holds no fields. It is still the one factory for
:class:`~repro_torch.nn.common.Ctx` outside the nn substrate.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ExecutionConfig"]


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Static execution environment of one Runtime (single device, local plan)."""

    def make_ctx(self, *, policy=None, key=None, n_layers: int = 1):
        """The per-call :class:`~repro_torch.nn.common.Ctx` (``key``: the
        integer seed sketched sites derive their generators from)."""
        from repro_torch.nn.common import Ctx

        return Ctx(policy=policy, key=key, n_layers=n_layers)
