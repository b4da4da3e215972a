"""ServeConfig: the serving counterpart of ``ExecutionConfig`` (port of
``repro/serve/config.py``).

One frozen, hashable object holds every engine knob: slot count, KV budget,
paged-cache geometry, prefill bucketing and packing, the stop token. So
``Runtime.serve(params, cfg, serve=ServeConfig(...))`` fixes the engine's
built surface: one prefill per bucket, one decode step, one insert.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ServeConfig"]


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching engine configuration (hashable, compare by value).

    * ``n_slots`` — decode batch width: the number of concurrently decoding
      requests. Finished slots are refilled from the queue between steps.
    * ``max_len`` — per-slot KV budget (prompt + generated tokens).
    * ``page_size`` — KV-cache page length in tokens. ``None`` = contiguous
      slot-major caches. Paged mode additionally requires the arch's cache
      tree to be pure full-length attention KV (no SSM/ring-buffer state) —
      the engine falls back to contiguous otherwise and records the choice
      in ``Engine.telemetry()["layout"]``.
    * ``n_pages`` — physical page-pool size (``None`` = enough for every
      slot at ``max_len`` plus the reserved trash page 0). Smaller pools
      make admission wait for evictions to free pages.
    * ``pack_prefill`` — pack several queued prompts into one prefill call
      (page-aligned segments + segment-masked attention). Paged mode only.
    * ``prefill_buckets`` — prompt-length buckets (one built prefill each).
      Empty = powers of two from ``max(8, page_size)`` up to ``max_len``.
    * ``eos`` — engine-default stop token (per-request ``Request.eos`` wins).
    """

    n_slots: int = 4
    max_len: int = 256
    page_size: Optional[int] = 16
    n_pages: Optional[int] = None
    pack_prefill: bool = True
    prefill_buckets: Tuple[int, ...] = ()
    eos: Optional[int] = None
    ring_capacity: int = 256

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {self.max_len}")
        if self.page_size is not None:
            if self.page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {self.page_size}")
            if self.max_len % self.page_size != 0:
                raise ValueError(
                    f"max_len={self.max_len} must be a multiple of "
                    f"page_size={self.page_size} (whole pages per slot)")
        for b in self.prefill_buckets:
            if not (0 < b <= self.max_len):
                raise ValueError(f"prefill bucket {b} outside (0, max_len]")

    # -- derived geometry ---------------------------------------------------

    @property
    def pages_per_slot(self) -> int:
        assert self.page_size is not None
        return self.max_len // self.page_size

    @property
    def pool_pages(self) -> int:
        """Physical pages incl. the reserved trash page 0."""
        assert self.page_size is not None
        if self.n_pages is not None:
            return self.n_pages
        return self.n_slots * self.pages_per_slot + 1

    def buckets(self) -> Tuple[int, ...]:
        """Ascending prefill buckets (prefill shapes), ending at max_len."""
        if self.prefill_buckets:
            bs = sorted(set(self.prefill_buckets))
            if bs[-1] != self.max_len:
                bs.append(self.max_len)
            return tuple(bs)
        lo = max(8, self.page_size or 1)
        bs, b = [], _pow2_ceil(lo)
        while b < self.max_len:
            bs.append(b)
            b *= 2
        bs.append(self.max_len)
        return tuple(bs)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (n must be <= max_len)."""
        for b in self.buckets():
            if n <= b:
                return b
        raise ValueError(f"length {n} exceeds max_len={self.max_len}")

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)
