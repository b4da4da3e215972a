"""Spans: nestable wall-clock intervals with Chrome-trace export (port of
``repro/obs/tracing.py``).

* a span is a named interval ``[t0, t1)`` on the shared monotonic clock
  (:mod:`repro_torch.obs.clock`), with an integer ``sid``, an optional
  ``parent`` sid, the opening thread's id and free-form scalar ``attrs``;
* ``with tracer.span("train_step", step=i):`` opens a child of the innermost
  open span on the current thread (one stack per thread: the checkpoint
  writer thread records its I/O spans concurrently);
* :meth:`Tracer.add_span` records a span from explicit timestamps after the
  fact: the serving engine turns each finished request's stamps (submit,
  admit, first token, done) into a request span with queued, prefill and
  decode children without touching its loop;
* completed spans land in a bounded ring (oldest dropped), exported as
  Chrome-trace / Perfetto JSON (:meth:`Tracer.to_chrome`) or as JSONL through
  the port's :class:`~repro_torch.telemetry.sinks.JsonlSink`.

With ``annotate=True`` each context-manager span also opens a
``torch.profiler.record_function`` range (JAX opens a
``jax.profiler.TraceAnnotation``), so the span shows on the host timeline of
a ``torch.profiler`` trace. A span times the host: work queued on the card
inside it may finish after it closes unless the code inside synchronizes.

Off costs nothing: callers hold :data:`NULL_TRACER`, whose ``span()`` returns
one shared no-op context manager (no allocation, no clock read), and the hot
loops also test ``tracer.enabled`` before building an attrs dict.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

import torch

from repro_torch.obs import clock

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER"]


class Span:
    """One completed (or open) interval. ``t1 < 0`` marks still-open spans
    in flight-recorder dumps taken mid-crash."""

    __slots__ = ("sid", "parent", "name", "t0", "t1", "tid", "attrs")

    def __init__(self, sid: int, parent: Optional[int], name: str,
                 t0: float, t1: float, tid: int, attrs: Optional[dict]):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.attrs = attrs

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def to_record(self) -> dict:
        rec = {"sid": self.sid, "parent": self.parent, "name": self.name,
               "t0": self.t0, "t1": self.t1, "dur_s": self.duration_s,
               "tid": self.tid}
        if self.attrs:
            rec.update(self.attrs)
        return rec


class _SpanCtx:
    """Context manager for one live span (a small class, not a generator:
    the trainer opens one per step)."""

    __slots__ = ("_tracer", "_span", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: Optional[dict]):
        self._tracer = tracer
        self._span = Span(next(tracer._ids), None, name, 0.0, -1.0,
                          threading.get_ident(), attrs)
        self._range = None

    def __enter__(self) -> Span:
        tr = self._tracer
        stack = tr._stack()
        if stack:
            self._span.parent = stack[-1].sid
        stack.append(self._span)
        if tr._annotate:
            self._range = torch.profiler.record_function(self._span.name)
            self._range.__enter__()
        self._span.t0 = clock.now()
        return self._span

    def __exit__(self, exc_type, exc, tb):
        self._span.t1 = clock.now()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] is self._span:
            stack.pop()
        elif self._span in stack:  # pragma: no cover - unbalanced exit
            stack.remove(self._span)
        if exc_type is not None and self._span.attrs is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        elif exc_type is not None:
            self._span.attrs = {"error": exc_type.__name__}
        tr._buf.append(self._span)
        return False


class Tracer:
    """Bounded ring of completed spans + per-thread open-span stacks.

    Thread-safe by construction: span ids come from an atomic counter, the
    ring is a ``deque(maxlen=...)``, and nesting state is ``threading.local``
    — the trainer's main loop and the checkpoint writer thread trace
    concurrently without locks.
    """

    enabled = True

    def __init__(self, capacity: int = 4096, *, annotate: bool = False):
        self._buf: deque = deque(maxlen=int(capacity))
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._annotate = bool(annotate)
        self.origin = clock.now()

    # -- recording ----------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, **attrs) -> _SpanCtx:
        """Open a nested span: ``with tracer.span("train_step", step=i):``."""
        return _SpanCtx(self, name, attrs or None)

    def add_span(self, name: str, t0: float, t1: float, *,
                 parent: Optional[int] = None, tid: int = 0,
                 **attrs) -> int:
        """Record a span from explicit ``clock.now()`` stamps (post-hoc —
        per-request lifecycles reconstructed at finish time). Returns the
        span id, so callers can join it onto other records (the serve ring)
        and parent further sub-spans under it."""
        sid = next(self._ids)
        self._buf.append(Span(sid, parent, name, t0, t1, tid, attrs or None))
        return sid

    def current_id(self) -> Optional[int]:
        """sid of the innermost open span on this thread (None outside)."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1].sid if stack else None

    def clear(self) -> None:
        self._buf.clear()

    # -- reading / export ---------------------------------------------------

    def spans(self, name: Optional[str] = None) -> List[Span]:
        out = list(self._buf)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def records(self) -> List[dict]:
        return [s.to_record() for s in self.spans()]

    def to_chrome(self) -> dict:
        """Chrome-trace JSON object (the format Perfetto / chrome://tracing
        load): complete-events (``ph: "X"``), microsecond timestamps
        relative to the tracer origin, span id/parent under ``args``."""
        events = []
        for s in self.spans():
            t1 = s.t1 if s.t1 >= s.t0 else s.t0  # still-open: zero width
            args: Dict[str, object] = {"span_id": s.sid}
            if s.parent is not None:
                args["parent_id"] = s.parent
            if s.attrs:
                args.update(s.attrs)
            events.append({
                "name": s.name, "ph": "X", "pid": 1, "tid": s.tid,
                "ts": (s.t0 - self.origin) * 1e6,
                "dur": (t1 - s.t0) * 1e6,
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, default=str)
        return path

    def export_jsonl(self, path: str) -> str:
        """One JSON object per completed span, through the telemetry
        :class:`~repro_torch.telemetry.sinks.JsonlSink` (the port's one JSONL
        writer)."""
        from repro_torch.telemetry.sinks import JsonlSink

        sink = JsonlSink(path)
        try:
            for rec in self.records():
                sink.write(rec)
        finally:
            sink.close()
        return path


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_CTX = _NullCtx()


class NullTracer:
    """Tracing disabled: one shared no-op context, no clock reads, no
    allocation. ``bool(NULL_TRACER)`` is False so hot paths can guard with
    ``if tracer:``."""

    enabled = False
    origin = 0.0

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, **attrs) -> _NullCtx:
        return _NULL_CTX

    def add_span(self, name: str, t0: float, t1: float, *, parent=None,
                 tid: int = 0, **attrs) -> None:
        return None

    def current_id(self) -> None:
        return None

    def clear(self) -> None:
        pass

    def spans(self, name: Optional[str] = None) -> list:
        return []

    def records(self) -> list:
        return []

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_TRACER = NullTracer()
