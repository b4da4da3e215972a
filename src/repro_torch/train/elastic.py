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

__all__ = ["resume_on_mesh", "state_shardings", "surviving_mesh", "regroup",
           "gather_state"]


def surviving_mesh(old_mesh, shape, *, axes=None, device=None):
    """A mesh of ``shape`` over the process group, axis names from
    ``old_mesh`` (default ``("data", "model")`` cut to ``len(shape)``).
    The port's ranks are processes: ``shape`` covers the whole group, so a
    mesh on fewer ranks than the old one is built after :func:`regroup`
    has re-formed the group on the survivors. Raises ``ValueError`` where
    ``shape`` needs another number of ranks than the group has."""
    import torch.distributed as dist

    shape = tuple(int(s) for s in shape)
    if old_mesh is not None and axes is None:
        axes = tuple(old_mesh.axis_names)
    if axes is None or len(axes) != len(shape):
        axes = ("data", "model")[:len(shape)] if len(shape) <= 2 else \
            tuple(f"ax{i}" for i in range(len(shape)))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"surviving mesh {shape} needs {math.prod(shape)} ranks, the process "
                         f"group has {world} (re-form it on the survivors first: regroup)")
    if device is None:
        device = old_mesh.device if old_mesh is not None else "cuda"
    return meshlib.make_mesh(shape, tuple(axes), device=device)


def regroup(n_ranks: int) -> bool:
    """Re-form the default process group on its first ``n_ranks`` ranks
    (JAX's survivors: a prefix of the old device order), on a fresh
    rendezvous under the old group's store; returns whether this rank is
    one of them. Every rank destroys the old group (and with it every
    mesh's groups); the others leave with no group. The survivors keep
    their ranks, so ``make_mesh``'s rule (the mesh covers the group) holds
    on the new group unchanged. The identity where the group already has
    ``n_ranks`` ranks."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    world, rank = dist.get_world_size(), dist.get_rank()
    if n_ranks == world:
        return True
    if not 0 < n_ranks < world:
        raise ValueError(f"regroup onto {n_ranks} of {world} ranks")
    backend, store = dist.get_backend(), c10d._get_default_store()
    generation = _REGROUPS[0] = _REGROUPS[0] + 1
    dist.destroy_process_group()
    if rank >= n_ranks:
        return False
    dist.init_process_group(backend, store=dist.PrefixStore(f"regroup/{generation}", store),
                            rank=rank, world_size=n_ranks)
    return True


_REGROUPS = [0]  # the group's generations: each regroup rendezvous under its own prefix


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
