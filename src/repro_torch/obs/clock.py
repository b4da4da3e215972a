"""The one wall clock of the port (port of ``repro/obs/clock.py``).

Host-side timings in ``src/repro_torch`` read this module, so that spans,
metrics, ledgers, the serving engines' request stamps and the straggler
controller share one monotonic timebase. ``now()`` is that timestamp;
``wall()`` is epoch time, only for labelling artifacts (crash-bundle
metadata). A time read here measures the host: a device time needs a
synchronize first (the engines and the ledgers do it where they time the
card).
"""
from __future__ import annotations

import time

__all__ = ["now", "wall"]

now = time.perf_counter
wall = time.time
