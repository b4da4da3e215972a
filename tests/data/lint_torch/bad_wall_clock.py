"""Fixture: wall-clock reads outside repro_torch/obs (wall-clock-outside-obs)."""
from time import perf_counter
import time


def measure(fn):
    t0 = time.perf_counter()
    fn()
    started_at = time.time()
    return perf_counter() - t0, started_at
