"""Fixture: an inline waiver suppresses (but records) the finding."""
import time


def stamp():
    return time.perf_counter()  # lint: waive=wall-clock-outside-obs
