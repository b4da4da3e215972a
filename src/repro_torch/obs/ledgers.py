"""Compile and memory ledgers (port of ``repro/obs/ledgers.py``).

**Compile ledger**: one entry per step function built through
``Runtime.train_step`` (keyed by a readable spelling of the step-cache key
``(runtime, arch, opt, budget)``), and the cache hits after it. Eager PyTorch
has no ahead-of-time lower and compile, so an entry always takes JAX's own
fallback spelling: ``first_call_s``, the synced wall time of the built step's
first call (building the plan, the first launches, and on the card the
first use of each kernel library's handles), with ``trace_s`` and
``compile_s`` None. The first call runs under one ``first_call`` span.

**Memory ledger**: per built step, the allocator's view of that first call
on the card (:func:`first_call_memory`, in :func:`memory_summary`'s fields),
and live samples of :func:`device_memory_stats`. On the CPU there is no
device allocator: the entry's ``peak_GB_per_dev`` is None and its ``reason``
says why; no number is made up.

Both are host code with bounded cost: entries are appended when a step is
built or sampled, never per step.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs import clock

__all__ = ["AllocatorAnalysis", "CompileLedger", "MemoryLedger", "memory_summary",
           "first_call_memory", "device_memory_stats", "GLOBAL_COMPILE_LEDGER",
           "global_active", "GLOBAL_ENV"]

GLOBAL_ENV = "REPRO_COMPILE_LEDGER"

NO_ALLOCATOR = "no CUDA allocator on the CPU: device memory not measured"


@dataclasses.dataclass(frozen=True)
class AllocatorAnalysis:
    """The four sizes of JAX's ``memory_analysis()``, read from the CUDA
    caching allocator around one call: ``argument`` is every byte allocated
    on the device before the call (the arguments and anything else live),
    ``output`` what the call left allocated beyond that, ``temp`` the peak
    during the call above what it left, ``alias`` 0 (an in-place update
    shows as no output). Their :func:`memory_summary` peak is the call's
    ``torch.cuda.max_memory_allocated``."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int = 0


def memory_summary(ma, hbm_bytes: Optional[int] = None) -> dict:
    """A ``memory_analysis()``-shaped result (:class:`AllocatorAnalysis`, or
    any object with the four ``*_size_in_bytes`` fields) as the GB-per-device
    dict JAX records; ``fits_hbm`` only when a device size is given."""
    peak = (ma.argument_size_in_bytes + ma.output_size_in_bytes
            + ma.temp_size_in_bytes - ma.alias_size_in_bytes)
    out = {
        "argument_GB_per_dev": ma.argument_size_in_bytes / 1e9,
        "output_GB_per_dev": ma.output_size_in_bytes / 1e9,
        "temp_GB_per_dev": ma.temp_size_in_bytes / 1e9,
        "alias_GB_per_dev": ma.alias_size_in_bytes / 1e9,
        "peak_GB_per_dev": peak / 1e9,
    }
    if hbm_bytes is not None:
        out["fits_hbm"] = peak < hbm_bytes
    return out


def first_call_memory(fn, device):
    """Call ``fn()`` once and read the allocator around it: ``(result,
    summary)``, the summary :func:`memory_summary`'s dict on a CUDA device
    (synchronized before and after), or ``{"peak_GB_per_dev": None,
    "reason": ...}`` on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return fn(), {"peak_GB_per_dev": None, "reason": NO_ALLOCATOR}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    after = torch.cuda.memory_allocated(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    ma = AllocatorAnalysis(argument_size_in_bytes=before,
                           output_size_in_bytes=max(after - before, 0),
                           temp_size_in_bytes=peak - max(after, before))
    summ = memory_summary(ma, hbm_bytes=torch.cuda.get_device_properties(dev).total_memory)
    return out, summ


def device_memory_stats() -> List[dict]:
    """Live allocator stats per CUDA device, from ``torch.cuda.memory_stats``
    under JAX's names (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_reserved``, ``bytes_limit``); ``[]`` without a card."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({"device": f"cuda:{i}",
                    "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                    "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                    "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
                    "bytes_limit": torch.cuda.get_device_properties(i).total_memory})
    return out


class CompileLedger:
    """Append-only record of step builds and step-cache hits."""

    def __init__(self):
        self._lock = threading.Lock()
        self.entries: List[dict] = []
        self._hits: Dict[str, int] = {}

    def record_compile(self, key: str, *, trace_s: Optional[float] = None,
                       compile_s: Optional[float] = None,
                       first_call_s: Optional[float] = None,
                       **extra) -> dict:
        entry = {"key": key, "event": "compile", "at": clock.now(),
                 "trace_s": trace_s, "compile_s": compile_s,
                 "first_call_s": first_call_s}
        entry.update(extra)
        with self._lock:
            self.entries.append(entry)
        return entry

    def record_hit(self, key: str) -> None:
        with self._lock:
            self._hits[key] = self._hits.get(key, 0) + 1

    def summary(self) -> dict:
        with self._lock:
            entries = list(self.entries)
            hits = dict(self._hits)
        compile_s = sum(e["compile_s"] or 0.0 for e in entries)
        first_s = sum(e["first_call_s"] or 0.0 for e in entries)
        return {"compiles": len(entries), "hits": sum(hits.values()),
                "distinct_keys": len({e["key"] for e in entries} | set(hits)),
                "total_compile_s": compile_s,
                "total_first_call_s": first_s}

    def to_json(self) -> dict:
        summary = self.summary()  # takes the lock itself
        with self._lock:
            return {"summary": summary,
                    "hits_by_key": dict(self._hits),
                    "entries": [dict(e) for e in self.entries]}

    def write(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, default=str)
        return path


class MemoryLedger:
    """Per-step memory summaries and on-demand live device samples."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_key: Dict[str, dict] = {}
        self.samples: List[dict] = []

    def record(self, key: str, ma_or_summary: Any) -> dict:
        summ = (ma_or_summary if isinstance(ma_or_summary, dict)
                else memory_summary(ma_or_summary))
        with self._lock:
            self.by_key[key] = summ
        return summ

    def sample(self, label: str = "") -> List[dict]:
        stats = device_memory_stats()
        if stats:
            with self._lock:
                self.samples.append({"label": label, "at": clock.now(),
                                     "devices": stats})
        return stats

    def to_json(self) -> dict:
        with self._lock:
            return {"by_key": {k: dict(v) for k, v in self.by_key.items()},
                    "live_samples": [dict(s) for s in self.samples]}


# Process-global compile ledger, on when the REPRO_COMPILE_LEDGER environment
# variable is set (as in the JAX package).
GLOBAL_COMPILE_LEDGER = CompileLedger()


def global_active() -> bool:
    return bool(os.environ.get(GLOBAL_ENV))
