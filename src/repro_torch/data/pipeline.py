"""Host data pipeline: background prefetch and device placement (port of
``repro/data/pipeline.py``, one device)."""
from __future__ import annotations

import queue
import threading

from repro_torch.train.train_step import batch_to_device

__all__ = ["prefetch", "shard_batch"]


def shard_batch(batch: dict, device=None) -> dict:
    """``batch`` on ``device`` (``None``: unchanged), as the train step takes
    it (``train_step.batch_to_device``: int64 token ids and labels; a host
    array pinned and copied ``non_blocking``, which the card runs in stream
    order before the step that reads it)."""
    return batch if device is None else batch_to_device(batch, device)


def prefetch(it, size: int = 2, device=None):
    """Iterate ``it`` in a background thread, ``size`` batches ahead, each
    placed on ``device`` by :func:`shard_batch`. An exception raised by
    ``it`` in the worker is raised again here, in the consumer. Closing
    this generator (or dropping it) stops the worker and joins it, so an
    endless ``it`` leaves no thread behind."""
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(shard_batch(item, device)):
                    return
        except BaseException as e:  # forwarded: the consumer re-raises below
            put(e)
        else:
            put(end)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=10.0)
