"""Fixture: the sanctioned clock — and time.sleep, which is not a clock
read (prose like "time.perf_counter" in a docstring is not a finding)."""
import time

from repro_torch.obs import clock


def measure(fn):
    t0 = clock.now()
    fn()
    time.sleep(0.0)  # pacing, not timing — allowed
    return clock.now() - t0, clock.wall()
