"""Flight recorder: bounded recent history, dumped as a crash bundle (port of
``repro/obs/flight.py``).

The recorder holds the run's tracer and metrics registry and two small rings
of its own: metrics snapshots (the trainer takes one at every logged step)
and notable events. :meth:`FlightRecorder.dump` writes a crash bundle, one
JSON directory under the configured ``crash_dir``::

    <crash_dir>/crash_<seq>_<reason>/
        meta.json     # reason, wall time, counts, extra context
        spans.json    # recent spans, Chrome-trace form (Perfetto-loadable)
        metrics.json  # latest registry snapshot + the snapshot ring
        events.json   # noted events, oldest first

Bundle names are deterministic (a per-recorder sequence number, no
timestamps in paths). The trainer dumps a ``ckpt_io`` bundle when a
checkpoint write fails, the resilience supervisor ``rollback``,
``device_loss`` and ``checkpoint_error`` bundles.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import List, Optional

from repro_torch.obs import clock

__all__ = ["FlightRecorder"]


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)


class FlightRecorder:
    def __init__(self, tracer, registry, *, capacity: int = 256):
        self.tracer = tracer
        self.registry = registry
        self._snaps: deque = deque(maxlen=64)
        self._events: deque = deque(maxlen=int(capacity))
        self.dumps: List[str] = []

    # -- feeding ------------------------------------------------------------

    def note(self, record: dict) -> None:
        """Remember one notable event (a dict, the shape of
        ``telemetry.sinks.recovery_record``)."""
        self._events.append(dict(record))

    def snapshot(self, step: Optional[int] = None) -> None:
        """Snapshot the metrics registry (cheap: one flat dict copy)."""
        if self.registry is None:
            return
        snap = {"step": step, "at": clock.now()}
        snap.update(self.registry.snapshot())
        self._snaps.append(snap)

    # -- dumping ------------------------------------------------------------

    def dump(self, crash_dir: str, reason: str, extra: Optional[dict] = None) -> str:
        """Write one crash bundle; returns its directory path."""
        seq = len(self.dumps)
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
        path = os.path.join(crash_dir, f"crash_{seq:03d}_{safe}")
        os.makedirs(path, exist_ok=True)
        spans = self.tracer.to_chrome() if self.tracer is not None else None
        _write_json(os.path.join(path, "meta.json"), {
            "reason": reason,
            "wall_time": clock.wall(),
            "n_spans": len(spans["traceEvents"]) if spans else 0,
            "n_metric_snapshots": len(self._snaps),
            "n_events": len(self._events),
            "extra": extra or {},
        })
        if spans is not None:
            _write_json(os.path.join(path, "spans.json"), spans)
        _write_json(os.path.join(path, "metrics.json"), {
            "latest": self.registry.snapshot() if self.registry else {},
            "snapshots": list(self._snaps),
        })
        _write_json(os.path.join(path, "events.json"), list(self._events))
        self.dumps.append(path)
        return path
