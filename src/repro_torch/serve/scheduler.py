"""Request queue, slot table and page allocator of the continuous engine
(port of ``repro/serve/scheduler.py``).

The scheduler owns everything on the host: the FIFO admission queue, each
slot's state (its request, decode position, emitted tokens) and, in paged
mode, the physical page free list and the slot page map. It never touches
the device; the engine asks it what to run next and tells it what happened.
It is numpy host code and behaves as JAX's, step for step.

Admission is strict FIFO (no reordering): the head request is admitted as
soon as a slot is free and its worst-case page reservation
``ceil((prompt_len + max_new) / page_size)`` fits the free list. Reserving
the worst case up front means decode never waits for a page: a slot that
started always finishes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch.serve.config import ServeConfig

__all__ = ["Request", "Slot", "Scheduler"]


@dataclasses.dataclass
class Request:
    """One generation request. ``out`` is filled on completion; the stamps
    (seconds, ``repro_torch.obs.clock``) feed the per-request latency
    records on the engine's ring."""

    prompt: np.ndarray  # int32 [len]
    max_new: int = 16
    eos: Optional[int] = None  # per-request stop token (None = engine default)
    out: Optional[np.ndarray] = None
    stop: Optional[str] = None  # "eos" | "length"
    truncated: int = 0
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None


class Slot:
    """Decode-batch lane state. ``req is None`` marks a free lane (its decode
    work is wasted — counted by the engine)."""

    __slots__ = ("idx", "req", "pos", "outs", "pages")

    def __init__(self, idx: int):
        self.idx = idx
        self.req: Optional[Request] = None
        self.pos = 0          # next KV write position (= prompt_len + emitted - 1)
        self.outs: List[int] = []
        self.pages: Optional[np.ndarray] = None  # physical pages (paged mode)


class Scheduler:
    def __init__(self, serve: ServeConfig, *, paged: bool):
        self.serve = serve
        self.paged = paged
        self.queue: deque = deque()
        self.slots = [Slot(i) for i in range(serve.n_slots)]
        if paged:
            self.free_pages: List[int] = list(range(1, serve.pool_pages))
            self.page_map = np.zeros((serve.n_slots, serve.pages_per_slot),
                                     np.int32)
        else:
            self.free_pages = []
            self.page_map = None

    # -- admission ----------------------------------------------------------

    def submit(self, requests: List[Request], now: float) -> int:
        """Validate, left-truncate over-long prompts, enqueue. Returns the
        total truncated-token count. Raises before any request is enqueued
        (all-or-nothing, and always before any device work)."""
        serve = self.serve
        for i, r in enumerate(requests):
            if len(r.prompt) == 0:
                raise ValueError(f"request {i}: empty prompt")
            if r.max_new <= 0:
                raise ValueError(f"request {i}: max_new must be >= 1, "
                                 f"got {r.max_new}")
            if r.max_new >= serve.max_len:
                raise ValueError(
                    f"request {i}: max_new={r.max_new} leaves no room for "
                    f"any prompt token within max_len={serve.max_len}")
            if self.paged:
                worst = self._pages_needed(
                    min(len(r.prompt), serve.max_len - r.max_new), r.max_new)
                if worst > serve.pool_pages - 1:
                    raise ValueError(
                        f"request {i}: needs {worst} pages but the pool has "
                        f"{serve.pool_pages - 1} (raise n_pages)")
        truncated = 0
        for r in requests:
            p = np.asarray(r.prompt, np.int32)
            keep = serve.max_len - r.max_new
            if len(p) > keep:
                r.truncated = len(p) - keep
                truncated += r.truncated
                p = p[-keep:]  # keep the most recent context
            r.prompt = p
            r.t_submit = now
            self.queue.append(r)
        return truncated

    def _pages_needed(self, plen: int, max_new: int) -> int:
        P = self.serve.page_size
        return -(-(plen + max_new) // P)

    # -- wave selection -----------------------------------------------------

    def free_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.req is None]

    def live_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.req is not None]

    def pending(self) -> int:
        return len(self.queue)

    def take_wave(self, *, pack: bool, align: int) -> List[Request]:
        """Pop the FIFO head requests runnable right now.

        ``pack=True``: take as many consecutive requests as fit one packed
        prefill row of ``max_len`` tokens (each prompt rounded up to
        ``align``), bounded by free slots and the page free list.
        ``pack=False``: at most one request per wave. FIFO is strict — a
        head request that does not fit blocks the queue until evictions
        free its resources (worst-case reservation makes that inevitable).
        """
        wave: List[Request] = []
        used_tokens = 0
        pages_left = len(self.free_pages)
        n_free = len(self.free_slots())
        while self.queue and len(wave) < n_free:
            r = self.queue[0]
            plen = len(r.prompt)
            aligned = -(-plen // align) * align
            if wave and (not pack or used_tokens + aligned > self.serve.max_len):
                break
            if self.paged:
                need = self._pages_needed(plen, r.max_new)
                if need > pages_left:
                    break
                pages_left -= need
            wave.append(self.queue.popleft())
            used_tokens += aligned
        return wave

    # -- slot lifecycle -----------------------------------------------------

    def place(self, req: Request, first_tok: int, now: float) -> Slot:
        """Bind an admitted request to a free slot (allocating its full page
        reservation in paged mode) and record the prefill-produced first
        token."""
        slot = self.free_slots()[0]
        slot.req = req
        slot.outs = [first_tok]
        slot.pos = len(req.prompt)
        if self.paged:
            need = self._pages_needed(len(req.prompt), req.max_new)
            pages = np.asarray([self.free_pages.pop() for _ in range(need)],
                               np.int32)
            slot.pages = pages
            row = np.zeros(self.serve.pages_per_slot, np.int32)
            row[:need] = pages
            self.page_map[slot.idx] = row
        req.t_admit = now
        req.t_first = now
        return slot

    def finish(self, slot: Slot, reason: str, now: float) -> Request:
        """Evict: release pages back to the free list, point the slot's page
        map at the trash page, finalize the request."""
        req = slot.req
        req.out = np.asarray(slot.outs, np.int32)
        req.stop = reason
        req.t_done = now
        if self.paged:
            self.free_pages.extend(int(p) for p in slot.pages)
            self.page_map[slot.idx] = 0
            slot.pages = None
        slot.req = None
        slot.outs = []
        slot.pos = 0
        return req
