"""The G-reader ceilings per estimator backend (the port's copy of
``repro/analysis/invariants.py``'s ``G_READER_CEILINGS``).

JAX counts the instructions of the optimized HLO that read the ``[N, n]``
output gradient G (``g_reader_passes``): the compact backward must stream G
from HBM at most twice (score pass + fused dX/dW/db pass), a plan-carry
backward once. The port has no HLO; its count of G's readers comes from a
profiler trace with the backward-fusion benchmark (ROADMAP Queue 1 item 6).
JAX's ``involuntary_remat_count`` and ``donated_input_bytes`` read XLA's
compiler log and executables, which eager PyTorch does not have
(``docs/port.md``).
"""
from __future__ import annotations

__all__ = ["g_reader_ceiling", "G_READER_CEILINGS"]

# The legacy compact/pallas backward reads G at most twice (a score pass
# plus the fused dX/dW/db pass); the plan-carry estimators sample from the
# previous step's carried scores, so their ONLY read of G is the backward
# kernel itself — exactly one pass.
G_READER_CEILINGS = {
    "mask": 2,       # score pass + masked-G matmuls (dense, no gather)
    "compact": 2,    # score pass + one-gather fused backward
    "pallas": 2,     # score kernel + fused kernel
    "onepass": 1,    # streaming selection: score/plan inside the one sweep
    "stale": 1,      # carried plan: kept-only fused sweep w/ score refresh
}


def g_reader_ceiling(backend: str) -> int:
    """The G-reader ceiling for an estimator backend (unknown/third-party
    backends get the legacy two-pass ceiling)."""
    return G_READER_CEILINGS.get(backend, 2)
