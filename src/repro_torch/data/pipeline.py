"""Host data pipeline: background prefetch and device placement (port of
``repro/data/pipeline.py``). Under a mesh every rank reads the same global
batch and keeps its own rows (``launch.sharding.batch_row_specs``: rows over
the data axes), which is what the train step under a mesh takes."""
from __future__ import annotations

import queue
import threading

from repro_torch.train.train_step import batch_to_device

__all__ = ["prefetch", "shard_batch"]


def shard_batch(batch: dict, device=None, *, mesh=None, shardings=None) -> dict:
    """``batch`` on ``device`` (``None``: unchanged), as the train step takes
    it (``train_step.batch_to_device``: int64 token ids and labels; a host
    array pinned and copied ``non_blocking``, which the card runs in stream
    order before the step that reads it). With ``mesh``: this rank's rows of
    the global batch, by ``shardings`` (a dict of specs; default
    ``batch_row_specs``)."""
    if mesh is not None:
        import numpy as np
        import torch

        from repro_torch.launch import sharding

        specs = shardings or sharding.batch_row_specs(batch, mesh)
        batch = {k: sharding.shard_tensor(torch.as_tensor(np.asarray(v)) if not isinstance(
            v, torch.Tensor) else v, specs.get(k), mesh) for k, v in batch.items()}
    return batch if device is None else batch_to_device(batch, device)


def prefetch(it, size: int = 2, device=None, *, mesh=None, shardings=None):
    """Iterate ``it`` in a background thread, ``size`` batches ahead, each
    placed on ``device`` by :func:`shard_batch` (this rank's rows under
    ``mesh``). An exception raised by
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
                if not put(shard_batch(item, device, mesh=mesh, shardings=shardings)):
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
