"""Elastic restart: re-shard a checkpoint onto a mesh of another shape.

Port of ``repro/train/elastic.py``. Parameter specs are derived from the
rules (``launch/sharding.py``), not stored, and checkpoints hold whole
arrays, so a resize is::

    mesh        = make_mesh(new_shape, axes)
    shardings   = state_shardings(state_like, mesh)
    state, step = checkpoint.restore(ckpt_dir, state_like, shardings=shardings)

:func:`resume_on_mesh` wraps exactly that. ``state_like`` may hold whole
tensors or another mesh's shards (their marks give the whole shapes).
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding as shardlib
from repro_torch.train import checkpoint as ckptlib
from repro_torch.train.train_step import TrainState

__all__ = ["resume_on_mesh", "state_shardings", "surviving_mesh", "gather_state"]


def surviving_mesh(old_mesh, shape, *, axes=None, device=None):
    """A mesh of ``shape`` over the process group, axis names from
    ``old_mesh`` (default ``("data", "model")`` cut to ``len(shape)``).
    The port's ranks are processes: a mesh on fewer ranks than the group
    needs the group re-initialised on the survivors, which comes with the
    supervisor's ``device_loss`` re-shard (ROADMAP.md), so ``shape`` must
    cover every rank."""
    import torch.distributed as dist

    shape = tuple(int(s) for s in shape)
    if old_mesh is not None and axes is None:
        axes = tuple(old_mesh.axis_names)
    if axes is None or len(axes) != len(shape):
        axes = ("data", "model")[:len(shape)] if len(shape) <= 2 else \
            tuple(f"ax{i}" for i in range(len(shape)))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise NotImplementedError(
            f"surviving mesh {shape} on {world} ranks: a mesh on fewer ranks than the "
            "process group is not ported (ROADMAP.md, Queue 1 item 2b)")
    if device is None:
        device = old_mesh.device if old_mesh is not None else "cuda"
    return meshlib.make_mesh(shape, tuple(axes), device=device)


def _whole_shapes(tree):
    """``tree`` with every tensor replaced by a meta tensor of its whole
    shape (a marked shard's global shape)."""
    def whole(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        m = shardlib.mesh_of(t)
        shape = shardlib.global_shape(t, m) if m is not None else tuple(t.shape)
        return torch.empty(shape, dtype=t.dtype, device="meta")

    return shardlib._walk(tree, whole)


def state_shardings(state_like: TrainState, mesh):
    """:class:`~repro_torch.launch.sharding.NamedSharding` s of a train state
    on ``mesh``: the parameter rules, the optimizer moments as their
    parameters, the step replicated."""
    pspecs = shardlib.param_shardings(_whole_shapes(state_like.params), mesh)
    return TrainState(params=pspecs, opt_state={k: pspecs for k in state_like.opt_state},
                      step=None)


def gather_state(state: TrainState, mesh) -> TrainState:
    """The whole state on every rank's device, from the shards (an
    all-gather per sharded leaf, by its mark): what a checkpoint holds, for
    comparisons at sizes that fit a card. Checkpoints themselves gather one
    leaf at a time into rank 0's host memory (``checkpoint.save(...,
    mesh=)``)."""
    return TrainState(params=shardlib.gather_tree(state.params, mesh),
                      opt_state={k: shardlib.gather_tree(v, mesh)
                                 for k, v in state.opt_state.items()},
                      step=state.step)


def resume_on_mesh(ckpt_dir: str, state_like: TrainState, mesh, *, device=None):
    """Restore the newest checkpoint, each rank its shard on ``mesh`` (any
    shape). Returns ``(state, step)``."""
    shardings = state_shardings(state_like, mesh)
    device = device if device is not None else mesh.device
    state, step = ckptlib.restore(ckpt_dir, state_like, shardings=shardings, device=device)
    for k in state.opt_state:
        shardlib.mark_like(state.opt_state[k], state.params)
    return state, step
