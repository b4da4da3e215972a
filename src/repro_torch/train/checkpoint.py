"""Checkpoints: atomic, async, verified, in the JAX package's on-disk format
(port of ``repro/train/checkpoint.py``). Under a mesh, rank 0 writes the
whole leaves, gathered from the shards one leaf at a time into its host
memory (``save(..., mesh=)``, ``CheckpointManager(mesh=...)``), and every
rank restores its own shard, cut from each ``.npy`` on the host before it
reaches the device (``restore(shardings=...)``): the whole state never sits
on a card. A failed write of rank 0 raises on every rank at the same
``wait()``, so a retry's gathers run on all of them.

Format, as JAX writes it: a directory ``step_<012d>/`` holding one ``.npy``
per leaf, named by the leaf's path with ``__`` between its parts (``k:<key>``
for a dict key, ``i:<index>`` for a list or tuple index, ``x:.<name>`` for a
dataclass field such as ``TrainState.params``), and ``manifest.json``
(version 2: the step, the sorted keys and a CRC32 of each leaf's ``.npy``
bytes). Either package's :func:`verify` accepts the other's checkpoints;
a port tree and a JAX tree name their leaves alike wherever their layouts
agree (the port keeps one dict per layer, JAX stacks them).

* atomic: written to ``step_<n>.tmp/``, then renamed; a crash mid-save never
  leaves a half checkpoint that :func:`latest_step` would pick.
* async: :func:`save_async` takes owned host copies of every leaf first and
  writes them in a background thread. The port's optimizers update tensors
  in place, and ``tensor.cpu()`` of a CPU tensor is the tensor itself, so
  the snapshot clones CPU tensors and copies CUDA tensors into pinned host
  memory, synchronising before the thread starts: the writer never sees a
  later step's values. The writer's exception surfaces on
  :meth:`CheckpointManager.wait` as :class:`CheckpointError`.
* verified: :func:`verify` re-hashes every leaf; :func:`restore` refuses a
  corrupt checkpoint, falling back to the newest verified step when picking
  the step itself and raising when the step was asked for.

Leaves are tensors (restored onto the requested device), numpy arrays and
Python numbers (``TrainState.step``); ``None`` holds no leaf.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import shutil
import threading
import warnings
import zlib
from typing import Optional

import numpy as np
import torch

__all__ = ["CheckpointError", "save", "save_async", "restore", "latest_step",
           "latest_verified_step", "verify", "inject_fault_once", "CheckpointManager"]

_SEP = "__"


class CheckpointError(RuntimeError):
    """A checkpoint write failed (sync, or async surfaced on ``wait()``) or a
    requested checkpoint failed CRC verification."""


# -- fault injection hook: arm once; the next write raises before touching
# the disk (a deterministic stand-in for a failing file system in tests)

_fault_lock = threading.Lock()
_fault_armed = [False]


def inject_fault_once():
    """Arm a one-shot IO failure for the next checkpoint write."""
    with _fault_lock:
        _fault_armed[0] = True


def _take_fault() -> bool:
    with _fault_lock:
        armed = _fault_armed[0]
        _fault_armed[0] = False
        return armed


def _items(node):
    """(path part, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"k:{k}", v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(f"i:{i}", v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f"x:.{f.name}", getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def _flatten(tree, prefix=()) -> dict:
    """``{key: leaf}`` with JAX's ``__``-joined path keys."""
    if tree is None:
        return {}
    items = _items(tree)
    if items is None:
        return {_SEP.join(prefix): tree}
    out = {}
    for part, child in items:
        out.update(_flatten(child, prefix + (part,)))
    return out


def _rebuild(like, load, device, shardings=None, prefix=()):
    """A tree of ``like``'s structure with the leaves ``load(key, sharding)``
    gives (``shardings``: None, or a tree of ``like``'s structure whose
    leaves are ``NamedSharding`` or None)."""
    from repro_torch.launch.sharding import NamedSharding, set_spec

    if like is None:
        return None
    items = _items(like)
    sharding = shardings if isinstance(shardings, NamedSharding) else None
    if items is None:
        arr = load(_SEP.join(prefix), sharding)
        if isinstance(like, torch.Tensor):
            t = torch.from_numpy(arr).to(device if device is not None else like.device)
            if sharding is not None:
                set_spec(t, sharding.spec, sharding.mesh)
            return t.requires_grad_(like.requires_grad) if t.is_floating_point() else t
        if isinstance(like, (bool, int, float)):
            return type(like)(arr)
        return arr
    sub = dict(_items(shardings) or ()) if shardings is not None and sharding is None else {}
    children = [_rebuild(child, load, device, sub.get(part), prefix + (part,))
                for part, child in items]
    if isinstance(like, dict):
        return dict(zip(like.keys(), children))
    if isinstance(like, (list, tuple)):
        return type(like)(children)
    return dataclasses.replace(like, **{f.name: c
                                        for f, c in zip(dataclasses.fields(like), children)})


def _snapshot(tree) -> dict:
    """Owned host copies of every leaf, keyed by path: CPU tensors cloned,
    CUDA tensors copied into pinned host memory (then one synchronise),
    everything else through ``np.array(copy=True)``."""
    flat = _flatten(tree)
    out, synced = {}, set()
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            t = v.detach()
            if t.device.type == "cuda":
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                synced.add(t.device)
                out[k] = buf
            else:
                out[k] = t.clone()
        else:
            out[k] = np.array(v, copy=True)
    for dev in synced:
        torch.cuda.synchronize(dev)
    return out


def _gathered_snapshot(tree, mesh):
    """Rank 0's owned host copies of the whole leaves of a sharded ``tree``
    (each leaf gathered from its shards by its mark, copied to the host and
    dropped before the next: never the whole tree on a device); None on the
    other ranks, which join the gathers."""
    from repro_torch.launch.sharding import gather_tensor, spec_of

    out = {}
    for k, v in _flatten(tree).items():
        if isinstance(v, torch.Tensor):
            whole = gather_tensor(v, spec_of(v), mesh)
            if mesh.rank == 0:
                out[k] = whole.to("cpu", copy=True)
            del whole
        else:
            out[k] = np.array(v, copy=True)
    return out if mesh.rank == 0 else None


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3, mesh=None):
    """Synchronous atomic save. Under ``mesh`` every rank calls it with its
    shards and rank 0 writes the whole leaves."""
    host = _snapshot(tree) if mesh is None else _gathered_snapshot(tree, mesh)
    if host is not None:
        _write(ckpt_dir, step, host, keep)


class _Writer(threading.Thread):
    """Async checkpoint writer. A raised exception is kept on ``self.error``
    and re-raised as :class:`CheckpointError` by
    :meth:`CheckpointManager.wait`. With an enabled ``tracer`` the write runs
    under a ``ckpt_io_write`` span on this thread (the tracer's nesting is
    per thread; its ring is shared)."""

    def __init__(self, ckpt_dir, step, host_flat, keep, tracer=None):
        super().__init__(daemon=True)
        self.error: BaseException | None = None
        self._job = (ckpt_dir, step, host_flat, keep)
        self._tracer = tracer

    def run(self):
        try:
            if self._tracer is not None and self._tracer.enabled:
                with self._tracer.span("ckpt_io_write", step=self._job[1]):
                    _write(*self._job)
            else:
                _write(*self._job)
        except BaseException as e:  # kept for wait(); never swallowed
            self.error = e


def save_async(ckpt_dir: str, step: int, tree, *, keep: int = 3, tracer=None) -> _Writer:
    """Snapshot to host, write in the background. Returns the writer thread;
    check ``.error`` after ``.join()`` (:class:`CheckpointManager` does
    both)."""
    t = _Writer(ckpt_dir, step, _snapshot(tree), keep, tracer)
    t.start()
    return t


def _to_numpy(v) -> np.ndarray:
    return v.numpy() if isinstance(v, torch.Tensor) else v


def _write(ckpt_dir, step, host_flat, keep):
    if _take_fault():
        raise CheckpointError(f"injected IO fault writing step {step} (inject_fault_once)")
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:012d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    crc = {}
    for k, v in host_flat.items():
        # hash the exact bytes that reach the disk, so verify() is a re-read
        buf = io.BytesIO()
        np.save(buf, _to_numpy(v))
        data = buf.getvalue()
        crc[k] = zlib.crc32(data) & 0xFFFFFFFF
        with open(os.path.join(tmp, k + ".npy"), "wb") as f:
            f.write(data)
    manifest = {"step": int(step), "keys": sorted(host_flat.keys()), "version": 2, "crc": crc}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)


def _gc(ckpt_dir, keep):
    steps = sorted(_all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:012d}"), ignore_errors=True)


def _all_steps(ckpt_dir):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str):
    steps = _all_steps(ckpt_dir)
    return max(steps) if steps else None


def verify(ckpt_dir: str, step: int) -> bool:
    """CRC-check every leaf of ``step`` against its manifest. A version-1
    manifest (no CRCs) verifies trivially; a missing, truncated or changed
    ``.npy`` fails."""
    d = os.path.join(ckpt_dir, f"step_{step:012d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    crc = manifest.get("crc")
    if crc is None:
        return True
    for k in manifest.get("keys", []):
        try:
            with open(os.path.join(d, k + ".npy"), "rb") as f:
                data = f.read()
        except OSError:
            return False
        if (zlib.crc32(data) & 0xFFFFFFFF) != crc.get(k):
            return False
    return True


def latest_verified_step(ckpt_dir: str):
    """Newest step whose every leaf passes its CRC; None if no step does."""
    for s in sorted(_all_steps(ckpt_dir), reverse=True):
        if verify(ckpt_dir, s):
            return s
    return None


def restore(ckpt_dir: str, tree_like, *, step=None, device=None, shardings=None):
    """Restore into the structure of ``tree_like``; returns ``(tree, step)``.

    Tensor leaves come back on ``device`` (default: the device of
    ``tree_like``'s leaf), with its ``requires_grad``. ``shardings`` (a tree
    of ``tree_like``'s structure whose leaves are
    ``launch.sharding.NamedSharding`` or None, e.g.
    ``train.elastic.state_shardings``): each rank keeps its shard of every
    leaf, on a mesh of any shape (checkpoints hold whole arrays, so a
    different mesh than the one that saved restores unchanged). With ``step=None``
    the newest checkpoint is verified first; a corrupt newest falls back to
    the newest verified step (with a warning), and :class:`CheckpointError`
    is raised only when no step verifies. An explicit ``step`` that fails
    verification raises."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        if not verify(ckpt_dir, step):
            fallback = latest_verified_step(ckpt_dir)
            if fallback is None:
                raise CheckpointError(f"no verified checkpoint in {ckpt_dir} "
                                      f"(newest step {step} failed CRC)")
            warnings.warn(f"checkpoint step {step} in {ckpt_dir} failed CRC verification; "
                          f"falling back to verified step {fallback}", stacklevel=2)
            step = fallback
    elif not verify(ckpt_dir, step):
        raise CheckpointError(f"checkpoint step {step} in {ckpt_dir} failed CRC verification")
    d = os.path.join(ckpt_dir, f"step_{step:012d}")

    def load(key, sharding):
        path = os.path.join(d, key + ".npy")
        if sharding is None or all(e is None for e in sharding.spec):
            return np.load(path)
        from repro_torch.launch.sharding import shard_slices

        # this rank's shard, read from the mapped file on the host
        arr = np.load(path, mmap_mode="r")
        return np.array(arr[shard_slices(arr.shape, sharding.spec, sharding.mesh)])

    tree = _rebuild(tree_like, load, None if device is None else torch.device(device),
                    shardings)
    return tree, step


class CheckpointManager:
    """Trainer-facing manager: periodic async saves and resume."""

    def __init__(self, ckpt_dir: str, every: int = 100, keep: int = 3, tracer=None,
                 mesh=None):
        self.dir = ckpt_dir
        self.every = every
        self.keep = keep
        self.tracer = tracer  # a repro_torch.obs tracer: async writes record I/O spans
        self.mesh = mesh  # under a mesh: gather the shards, rank 0 writes
        self._pending: Optional[_Writer] = None

    def maybe_save(self, step: int, tree):
        if step % self.every != 0:
            return False
        self.wait()
        if self.mesh is None:
            self._pending = save_async(self.dir, step, tree, keep=self.keep, tracer=self.tracer)
            return True
        host = _gathered_snapshot(tree, self.mesh)
        if host is not None:
            self._pending = _Writer(self.dir, step, host, self.keep, self.tracer)
            self._pending.start()
        return True

    def wait(self):
        """Join the pending write; re-raise its failure as CheckpointError.
        Under a mesh of several ranks every rank raises when rank 0's write
        failed (one all-reduce of a flag), so the ranks take the same path."""
        t, self._pending = self._pending, None
        err = None
        if t is not None:
            t.join()
            # taken off the writer: the error's traceback holds the writer's
            # frame, so a writer still holding the error would make a cycle
            # that keeps every frame the re-raise passes through (the train
            # loop's, with its state on the device) alive until the cyclic
            # collector runs
            err, t.error = t.error, None
        if self.mesh is not None and self.mesh.size > 1:
            import torch.distributed as dist

            flag = torch.tensor([0 if err is None else 1], device=self.mesh.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            if err is None and int(flag.item()):
                raise CheckpointError("rank 0's async checkpoint write failed")
        if err is not None:
            try:
                if isinstance(err, CheckpointError):
                    raise err
                raise CheckpointError(f"async checkpoint write failed: {err!r}") from err
            finally:
                # this frame, which the raised error's traceback holds, must
                # not hold the error in turn (a cycle, as above)
                del err

    def restore_or_none(self, tree_like, device=None, shardings=None):
        if latest_step(self.dir) is None:
            return None
        return restore(self.dir, tree_like, device=device, shardings=shardings)
