"""Metrics registry: Counter, Gauge, Histogram (port of ``repro/obs/metrics.py``).

Host code only: the same operations give the same :meth:`MetricsRegistry.snapshot`
and the same :meth:`MetricsRegistry.to_prometheus` text as the JAX package.
Each serving engine keeps its counters in a registry of its own and reads and
writes them through :class:`CounterView`, a mutable mapping over one name
prefix (``engine.counters["decode_steps"] += 1`` stores the registry counter
``serve.decode_steps``); the trainer counts ``train.steps`` and sets the
``train.budget`` gauge in the shared root registry.

Names are dotted lowercase paths, ``<component>.<name>``. Prometheus names turn
dots and dashes into underscores.
"""
from __future__ import annotations

import bisect
from collections.abc import MutableMapping
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "CounterView",
           "DEFAULT_BUCKETS"]

# Exponential latency-ish buckets (seconds): 1 µs .. ~67 s, doubling.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(1e-6 * 2 ** i for i in range(27))


class Counter:
    """Monotonically *intended* counter (floats allowed: the serve views
    accumulate seconds into ``prefill_s``/``decode_s``). ``set`` exists for
    the dict-compatible views; prefer ``inc``."""

    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set(self, v: float) -> None:
        self.value = float(v)


class Gauge:
    """Point-in-time value (queue depth, live slots, budget)."""

    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram (bounded memory — no sample retention).

    ``buckets`` are upper bounds (``le``); an implicit +inf bucket catches
    the tail. ``observe`` is O(log n) via bisection on the static bounds.
    """

    __slots__ = ("name", "buckets", "counts", "count", "total", "min", "max")
    kind = "histogram"

    def __init__(self, name: str, buckets: Optional[Iterable[float]] = None):
        self.name = name
        self.buckets = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None or v < self.min else self.min
        self.max = v if self.max is None or v > self.max else self.max

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "mean": (self.total / self.count) if self.count else None,
                "min": self.min, "max": self.max}


class MetricsRegistry:
    """Name → metric map with idempotent constructors (asking twice for the
    same name returns the same instance; a kind mismatch is a bug)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, factory, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = factory(name, *args)
        elif not isinstance(m, factory):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {factory.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets=None) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(name, buckets)
        elif not isinstance(m, Histogram):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not Histogram")
        return m

    def view(self, prefix: str, keys: Iterable[str]) -> "CounterView":
        """Dict-shaped view over ``{prefix}.{key}`` counters (the engines'
        ``counters``)."""
        return CounterView(self, prefix, keys)

    def snapshot(self) -> dict:
        """Flat scalar dict (histograms expand to ``name.count`` etc.) —
        sink-ready: feed it to a telemetry ``JsonlSink`` as one record."""
        out: Dict[str, object] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                for k, v in m.summary().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = m.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (metric names: dots → underscores)."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            pname = name.replace(".", "_").replace("-", "_")
            if isinstance(m, Histogram):
                lines.append(f"# TYPE {pname} histogram")
                acc = 0
                for le, c in zip(m.buckets, m.counts):
                    acc += c
                    lines.append(f'{pname}_bucket{{le="{le:g}"}} {acc}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pname}_sum {m.total:g}")
                lines.append(f"{pname}_count {m.count}")
            else:
                lines.append(f"# TYPE {pname} {m.kind}")
                lines.append(f"{pname} {m.value:g}")
        return "\n".join(lines) + ("\n" if lines else "")


class CounterView(MutableMapping):
    """MutableMapping over the registry counters under one prefix.

    Reads like a dict (``c["tokens_out"] += n``, ``dict(c)``, ``c.update``)
    while the values live as ``{prefix}.{key}`` counters in the registry. New
    keys may be added by assignment; keys cannot be deleted. A value reads
    back as an int when it is whole.
    """

    __slots__ = ("_reg", "_prefix", "_keys")

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 keys: Iterable[str] = ()):
        self._reg = registry
        self._prefix = prefix
        self._keys = []
        for k in keys:
            self[k] = 0.0

    def _name(self, key: str) -> str:
        return f"{self._prefix}.{key}"

    def __getitem__(self, key: str) -> float:
        if key not in self._keys:
            raise KeyError(key)
        v = self._reg.counter(self._name(key)).value
        return int(v) if float(v).is_integer() else v

    def __setitem__(self, key: str, value: float) -> None:
        if key not in self._keys:
            self._keys.append(key)
        self._reg.counter(self._name(key)).set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("CounterView keys cannot be deleted — registry "
                        "metrics persist for exporters")

    def __iter__(self):
        return iter(list(self._keys))

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return f"CounterView({dict(self)!r})"
