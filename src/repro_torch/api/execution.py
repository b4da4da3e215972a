"""Execution configuration (port of ``repro/api/execution.py``).

The JAX config also carries the mesh, shardings, telemetry, resilience and
observability; none of those is ported yet. This one holds compact
gradients and the accumulation count, and is the one factory for
:class:`~repro_torch.nn.common.Ctx` outside the nn substrate.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ExecutionConfig"]


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Static execution environment of one Runtime (single device, local plan).

    Attributes:
      compact_grads: keep sketched dW compact (rows + indices) from the
        backward through clipping into row-sparse optimizer updates
        (``core/compact_grad.py``; requires ``accum == 1``).
      accum: gradient-accumulation microbatch count. Only 1 is ported;
        above 1 raises ``NotImplementedError``.
    """

    compact_grads: bool = False
    accum: int = 1

    def __post_init__(self):
        if self.accum < 1:
            raise ValueError(f"accum must be >= 1, got {self.accum}")
        if self.compact_grads and self.accum != 1:
            raise ValueError("compact_grads requires accum == 1 (compact index "
                             "sets differ per microbatch; accumulate densely)")
        if self.accum != 1:
            raise NotImplementedError("gradient accumulation (accum > 1) is not ported yet")

    def make_ctx(self, *, policy=None, key=None, layer_index: int = 0, n_layers: int = 1):
        """The per-call :class:`~repro_torch.nn.common.Ctx` (``key``: the
        integer seed sketched sites derive their generators from)."""
        from repro_torch.nn.common import Ctx

        return Ctx(policy=policy, key=key, layer_index=layer_index, n_layers=n_layers)
