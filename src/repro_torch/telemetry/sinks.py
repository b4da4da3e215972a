"""Telemetry sinks and per-site cost attribution (port of
``repro/telemetry/sinks.py``).

Sinks take one record per step, a flat dict of scalars (step, budget, loss,
the probe summary) and optionally the nested ``probe_sites`` map, and keep
it: :class:`JsonlSink` (one JSON object per line, the lossless format),
:class:`CsvSink` (scalar columns only) and :class:`RingSink` (a bounded
in-memory buffer). The trainer builds them from
:class:`repro_torch.telemetry.TelemetryConfig` with :func:`build_sinks`. The
files are byte for byte what the JAX package writes for the same records.

Cost attribution: :func:`site_cost_table` models each sketched site's
backward FLOPs, exact and sketched, from the same rank math the estimators
use, under the JAX site paths of ``telemetry/probes.py`` (a stacked JAX site
sums the port's layers), so cost rows and probe rows share keys.
:func:`join_hlo_cost` distributes a measured program total over the sites;
the port has no HLO, so the total is a plain dict (``{"flops": ...}``).
"""
from __future__ import annotations

import csv
import json
import os
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.compact_grad import compact_rank
from repro_torch.core.site import site_role
from repro_torch.core.sketching import COLUMN_METHODS
from repro_torch.telemetry.probes import site_key

__all__ = ["Sink", "JsonlSink", "CsvSink", "RingSink", "MultiSink",
           "build_sinks", "percentiles", "recovery_record", "site_cost_table",
           "table_totals", "join_hlo_cost"]


def percentiles(records, field: str, qs=(50, 99)) -> dict:
    """Percentiles of one numeric field across sink records: ``{q: value}``,
    ``None`` values when no record carries the field."""
    vals = [float(r[field]) for r in records
            if isinstance(r.get(field), (int, float, np.integer, np.floating))]
    if not vals:
        return {q: None for q in qs}
    arr = np.percentile(np.asarray(vals), list(qs))
    return {q: float(v) for q, v in zip(qs, arr)}


def recovery_record(event: str, **fields) -> dict:
    """One resilience event as a sink record: ``{"event": <kind>, ...}``.

    Resilience events take this shape so offline analysis can filter the
    JSONL stream on the ``event`` key alone; step records never carry one.
    """
    return dict({"event": str(event)}, **fields)


def _scalars(record: dict) -> dict:
    return {k: v for k, v in record.items()
            if isinstance(v, (int, float, np.integer, np.floating)) or v is None}


class Sink:
    """Protocol: ``write(record)`` once per step, ``close()`` at loop end."""

    def write(self, record: dict):  # noqa: B027 — protocol default
        pass

    def close(self):  # noqa: B027
        pass


class JsonlSink(Sink):
    """One JSON object per line (full record, nested ``probe_sites`` kept)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")

    def write(self, record: dict):
        self._f.write(json.dumps(record, default=float) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class CsvSink(Sink):
    """Scalar columns only; the header is fixed by the first record (later
    records fill missing columns with empty cells, extra keys are dropped —
    CSV is the quick-look format, JSONL is the lossless one)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", newline="")
        self._writer: Optional[csv.DictWriter] = None

    def write(self, record: dict):
        row = _scalars(record)
        if self._writer is None:
            self._writer = csv.DictWriter(self._f, fieldnames=sorted(row),
                                          extrasaction="ignore", restval="")
            self._writer.writeheader()
        self._writer.writerow(row)
        self._f.flush()

    def close(self):
        self._f.close()


class RingSink(Sink):
    """Bounded in-memory buffer of the most recent records."""

    def __init__(self, capacity: int = 256):
        self._buf = deque(maxlen=int(capacity))

    def write(self, record: dict):
        self._buf.append(record)

    @property
    def records(self) -> List[dict]:
        return list(self._buf)

    def __len__(self):
        return len(self._buf)


class MultiSink(Sink):
    def __init__(self, sinks):
        self.sinks = list(sinks)

    def write(self, record: dict):
        for s in self.sinks:
            s.write(record)

    def close(self):
        for s in self.sinks:
            s.close()


def build_sinks(tcfg) -> Optional[MultiSink]:
    """Sinks for a :class:`~repro_torch.telemetry.TelemetryConfig` (None if the
    config names no outputs — the probe summary still rides the metrics)."""
    if tcfg is None:
        return None
    sinks: List[Sink] = []
    if tcfg.jsonl:
        sinks.append(JsonlSink(tcfg.jsonl))
    if tcfg.csv:
        sinks.append(CsvSink(tcfg.csv))
    return MultiSink(sinks) if sinks else None


# ---------------------------------------------------------------------------
# Static per-site cost attribution
# ---------------------------------------------------------------------------


def site_cost_table(params, policy, n_tokens: int, *, n_layers: int = 1) -> Dict[str, dict]:
    """Analytic per-site backward-FLOP attribution for one train step.

    Walks ``params`` with the slot builders' path matching; rows are keyed by
    the JAX site path (:func:`~repro_torch.telemetry.probes.site_key`), so a
    site of the dense stack sums its ``layers`` as JAX's stacked leaf does.
    Per linear site ``w: [n, d]`` the backward is two matmuls:

      * exact:    ``4 · T · n · d`` FLOPs per layer (dX + dW),
      * sketched: ``4 · T · r · d + T · n`` — reduced-shape matmuls over the
        ``r`` kept columns plus one score pass over G (column-family
        methods; other methods keep dense-shaped masked matmuls, ``r = n``).
    """
    if policy is None:
        return {}
    table: Dict[str, dict] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            role = None if "shared" in path else site_role(path)
            w = node.get("w")
            if role is None or w is None or len(getattr(w, "shape", ())) < 2:
                return
            cfg = policy.config_for(role, 0, n_layers)
            if cfg is None or cfg.is_noop:
                return
            n, d = int(w.shape[-2]), int(w.shape[-1])
            r = compact_rank(cfg, n) if cfg.method in COLUMN_METHODS else n
            exact = 4.0 * n_tokens * n * d
            sketched = 4.0 * n_tokens * r * d
            if cfg.method in COLUMN_METHODS and cfg.method != "per_column":
                sketched += float(n_tokens) * n  # score pass over G
            key = site_key("/".join(map(str, path)))
            row = table.get(key)
            if row is None:
                table[key] = {"role": role, "n": n, "d": d, "layers": 1, "r": r,
                              "budget": cfg.budget, "bwd_exact_flops": exact,
                              "bwd_sketched_flops": sketched}
            else:
                row["layers"] += 1
                row["bwd_exact_flops"] += exact
                row["bwd_sketched_flops"] += sketched
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(params, ())
    for row in table.values():
        row["savings_frac"] = 1.0 - row["bwd_sketched_flops"] / row["bwd_exact_flops"]
    return table


def table_totals(table: Dict[str, dict]) -> dict:
    exact = sum(v["bwd_exact_flops"] for v in table.values())
    sketched = sum(v["bwd_sketched_flops"] for v in table.values())
    return {"bwd_exact_flops": exact, "bwd_sketched_flops": sketched,
            "savings_frac": (1.0 - sketched / exact) if exact else 0.0,
            "n_sites": len(table)}


def join_hlo_cost(table: Dict[str, dict], hlo_cost: dict) -> Dict[str, dict]:
    """Join the modelled table with measured program totals (a dict with a
    ``"flops"`` entry; the JAX package passes its HLO cost summary): each
    site gains ``hlo_flops_share``, its modelled exact-backward fraction of
    the measured FLOPs, under JAX's key name."""
    total = sum(v["bwd_exact_flops"] for v in table.values())
    measured = float(hlo_cost.get("flops", 0.0))
    out = {}
    for k, v in table.items():
        share = (v["bwd_exact_flops"] / total) if total else 0.0
        out[k] = dict(v, hlo_flops_share=share * measured)
    return out
