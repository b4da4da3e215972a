"""Sharding rules: parameter, batch and cache specs; sharding and gathering
trees.

Port of ``repro/launch/sharding.py``. The strategy is JAX's: the batch over
the data axes (``pod``, ``data``); tensor parallelism over ``model`` (heads,
d_ff, vocab); FSDP: the other dimension of every large weight over the data
axes, and the optimizer state the same. A rule matches a parameter's path
and covers its TRAILING dimensions; a dimension that does not divide by its
axes' size falls back to replication.

A spec is a tuple with one entry per dimension: ``None`` (replicated), an
axis name, or a tuple of axis names, the entries JAX's ``PartitionSpec``
holds (the data axes as a tuple, the model axis as a name). Specs are
computed from the mesh's shape and axis names alone (``launch.mesh.layout``
gives one without a process group). The port keeps one dict per layer, so
its paths read ``/layers/<i>/attn/q/w`` where JAX's read
``/segments/0/0/attn/q/w``: the rules match both by their trailing parts.

:func:`shard_tree` cuts a full tree into this rank's shards and marks each
sharded tensor with its spec (:func:`spec_of`), which the sites, the train
step, the optimizer and the checkpoints read; :func:`gather_tree` is its
inverse. :func:`shard_params`, :func:`shard_caches` and :func:`shard_pools`
cut a parameter, decode-cache or page-pool tree by :func:`param_specs`,
:func:`cache_specs` and :func:`paged_cache_specs`; :func:`zeros_shards`
allocates this rank's zero shards of a tree of shapes without the whole.
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import dp_axes, mp_axes

__all__ = ["NamedSharding", "param_specs", "param_shardings", "batch_specs", "batch_row_specs",
           "cache_specs", "paged_cache_specs", "logical_rules", "spec_for_path", "shard_tree", "gather_tree", "shard_slices", "shard_tensor", "gather_tensor",
           "spec_of", "set_spec", "mesh_of", "mark_like", "global_shape", "dim_axes", "spec_axes",
           "rows_axes", "shard_params", "shard_caches", "shard_pools", "zeros_shards"]

# (path regex, spec for trailing dims); "dp"/"mp" resolve against the mesh
_RULES = [
    # embed: vocab replicated, d over model (a vocab-sharded table would turn
    # the token gather's backward into a scatter across shards); lm_head keeps
    # the vocab-parallel layout
    (r"(^|/)embed$", (None, "mp")),
    (r"/lm_head/w$", ("mp", "dp")),
    (r"/(attn|cross)/(q|k|v)/w$", ("mp", "dp")),
    (r"/(attn|cross)/o/w$", ("dp", "mp")),
    (r"/mlp/(in|gate)/w$", ("mp", "dp")),
    (r"/mlp/out/w$", ("dp", "mp")),
    (r"/moe/router/w$", (None, None)),
    (r"/moe/(wi|wg)$", ("mp", None, "dp")),
    (r"/moe/wo$", ("mp", "dp", None)),
    (r"/mamba/(in_x|in_z)/w$", ("mp", "dp")),
    (r"/mamba/(in_B|in_C|in_dt)/w$", (None, "dp")),
    (r"/mamba/out/w$", ("dp", "mp")),
    (r"/mamba/conv$", (None, "mp")),
    (r"/rwkv/(r|k|v|g|cm_k|cm_r)/w$", ("mp", "dp")),
    (r"/rwkv/(out|cm_v)/w$", ("dp", "mp")),
    (r"/rwkv/(w1|w2)/w$", (None, None)),
]

_MOE_TPX = {  # experts that do not divide the model axis: shard the hidden dim
    r"/moe/(wi|wg)$": (None, "mp", "dp"),
    r"/moe/wo$": (None, "dp", "mp"),
}


def _resolve(tag, mesh):
    if tag == "dp":
        return dp_axes(mesh)
    if tag == "mp":
        ax = mp_axes(mesh)
        return ax[0] if len(ax) == 1 else ax
    return tag


def _axis_size(mesh, tag) -> int:
    ax = _resolve(tag, mesh)
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        return math.prod(mesh.shape[a] for a in ax) if ax else 1
    return mesh.shape[ax]


def spec_for_path(path_s: str, shape, mesh) -> tuple:
    """The spec of the leaf at ``path_s`` (``/``-joined) of shape ``shape``."""
    shape = tuple(shape)
    for pat, trailing in _RULES:
        if re.search(pat, path_s):
            for tpat, ttrail in _MOE_TPX.items():
                if re.search(tpat, path_s):
                    if shape[-3] % _axis_size(mesh, "mp") != 0:
                        trailing = ttrail
                    break
            spec = [None] * (len(shape) - len(trailing)) + list(trailing)
            out = []
            for dim, tag in zip(shape, spec):
                if tag is None:
                    out.append(None)
                    continue
                out.append(_resolve(tag, mesh) if dim % _axis_size(mesh, tag) == 0 else None)
            return tuple(out)
    return (None,) * len(shape)  # small leaves (norms, biases, carries) replicate


def _walk(tree, fn, path=()):
    """Map ``fn(path, leaf)`` over a tree of dicts and lists (a tuple is a
    leaf: specs are tuples)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _path_str(path) -> str:
    return "/" + "/".join(str(p) for p in path)


def _has_shape(x) -> bool:
    return hasattr(x, "shape") and not isinstance(x, (int, float))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``): how one leaf is cut."""

    mesh: object
    spec: tuple


def param_shardings(params_shape, mesh):
    """:func:`param_specs` as :class:`NamedSharding` leaves."""
    return _walk(param_specs(params_shape, mesh),
                 lambda path, s: None if s is None else NamedSharding(mesh, s))


def param_specs(params_shape, mesh):
    """Specs for a parameter tree (tensors, ``meta`` tensors, or anything
    with a ``shape``); non-array leaves map to None."""
    return _walk(params_shape, lambda path, leaf: spec_for_path(_path_str(path), leaf.shape,
                                                                mesh)
                 if _has_shape(leaf) else None)


def batch_specs(cfg: ArchConfig, cell: ShapeCell, mesh) -> dict:
    """Specs of a shape cell's input batch: rows over the data axes where
    the global batch divides them."""
    dp = dp_axes(mesh)
    n_dp = math.prod(mesh.shape[a] for a in dp)
    bspec = dp if cell.global_batch % n_dp == 0 else None
    row = (bspec, None)
    specs = {"labels": row}
    if cfg.frontend == "vision":
        specs["embeds"] = (bspec, None, None)
        specs["positions"] = (None, bspec, None)
    else:
        specs["tokens"] = row
    if cfg.is_encdec:
        specs["src_embeds"] = (bspec, None, None)
    return specs


def batch_row_specs(batch: dict, mesh) -> dict:
    """Specs of a host batch by :func:`batch_specs`' rule, read from the
    batch itself: rows over the data axes where its batch size divides them
    (axis 1 of M-RoPE's ``[3, B, S]`` positions)."""
    dp = dp_axes(mesh)
    n_dp = math.prod(mesh.shape[a] for a in dp)
    out = {}
    for k, v in batch.items():
        nd = len(v.shape)
        axis = 1 if k == "positions" and nd == 3 else 0
        spec = [None] * nd
        if v.shape[axis] % n_dp == 0:
            spec[axis] = dp
        out[k] = tuple(spec)
    return out


def rows_axes(n_rows: int, mesh) -> tuple:
    """The data axes a batch of ``n_rows`` rows is split over
    (:func:`batch_specs`' rule): all of them where the rows divide them,
    else none (every data rank holds every row)."""
    dp = dp_axes(mesh)
    return dp if n_rows % math.prod(mesh.shape[a] for a in dp) == 0 else ()


def cache_specs(cfg: ArchConfig, cache_shape, mesh, global_batch: int):
    """Decode-cache specs (the port's list of per-layer dicts), the layout
    the serving steps keep their caches in: KV leaves [B, S, kv, hd] (a
    cross-attention memory's too) batch over the data axes where it divides
    and the sequence over model where it divides (flash-decoding: each model
    rank holds a chunk of every row's positions, for all kv heads, and
    decode combines the chunks' softmax statistics); recurrent states
    (``ssm``, ``wkv``, ``conv``, ``shift_*``) batch only. ``cfg`` is unread,
    as in JAX."""
    bax = rows_axes(global_batch, mesh) or None
    mp = mp_axes(mesh)
    mp1 = mp[0] if mp else None

    def spec(path, leaf):
        if not _has_shape(leaf):
            return None
        s = _path_str(path)
        shape = tuple(leaf.shape)
        if s.endswith("/k") or s.endswith("/v"):
            seq_ok = mp1 is not None and shape[-3] % mesh.shape[mp1] == 0
            lead = (None,) * (len(shape) - 4)
            return lead + (bax, mp1 if seq_ok else None, None, None)
        if s.endswith("/ssm") or s.endswith("/wkv"):
            return (None,) * (len(shape) - 4) + (bax, None, None, None)
        if s.endswith("/conv") or "shift" in s:
            return (None,) * (len(shape) - 3) + (bax, None, None)
        return (None,) * len(shape)

    return _walk(cache_shape, spec)


def paged_cache_specs(pool_shape, mesh, n_pages: int):
    """Specs of a paged KV pool tree (``serve/kv_cache.py``): the page
    dimension over the data axes where ``n_pages`` divides them; a page's
    interior and the page map replicated (a page is too short to split its
    positions over model)."""
    pax = rows_axes(n_pages, mesh) or None

    def spec(path, leaf):
        if not _has_shape(leaf):
            return None
        shape = tuple(leaf.shape)
        if len(shape) >= 4 and shape[-4] == n_pages:
            return (None,) * (len(shape) - 4) + (pax, None, None, None)
        return (None,) * len(shape)

    return _walk(pool_shape, spec)


def shard_params(params, mesh, *, copy: bool = True):
    """This rank's shards of a whole parameter tree, by :func:`param_specs`
    (``copy=False``: views where they can be, for serving, which never
    writes them)."""
    return shard_tree(params, param_specs(params, mesh), mesh, copy=copy)


def shard_caches(caches, mesh, global_batch: int):
    """This rank's shards of whole decode caches of ``global_batch`` rows, by
    :func:`cache_specs`."""
    return shard_tree(caches, cache_specs(None, caches, mesh, global_batch), mesh)


def shard_pools(pools, mesh, n_pages: int):
    """This rank's shards of whole page pools of ``n_pages`` pages, by
    :func:`paged_cache_specs`."""
    return shard_tree(pools, paged_cache_specs(pools, mesh, n_pages), mesh)


def zeros_shards(shape_tree, specs, mesh, device):
    """This rank's zero shard of every leaf of ``shape_tree`` (tensors, e.g.
    ``meta``, whose shapes and dtypes count) under ``specs`` (a tree of the
    same structure), on ``device``, marked; the whole is never allocated."""
    flat_specs = {}
    _walk(specs, lambda path, sp: flat_specs.__setitem__(path, sp))

    def zero(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = flat_specs.get(path)
        shape = tuple(sl.stop - sl.start for sl in shard_slices(leaf.shape, spec, mesh))
        return set_spec(torch.zeros(shape, dtype=leaf.dtype, device=device), spec, mesh)

    return _walk(shape_tree, zero)


def logical_rules(mesh) -> dict:
    """Activation specs of the train and serve steps."""
    dp = dp_axes(mesh)
    mp = mp_axes(mesh)
    mp1 = mp[0] if mp else None
    return {"activations": (dp, None, None), "logits": (dp, None, mp1)}


# -- shards of tensors and trees ----------------------------------------------

_SPEC_ATTR = "_mesh_spec"
_MESH_ATTR = "_mesh"


def dim_axes(entry) -> tuple:
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple:
    """Every axis a spec shards over, in its order."""
    return tuple(a for e in (spec or ()) for a in dim_axes(e))


def spec_of(t):
    """The spec :func:`shard_tree` marked ``t`` with, or None (replicated)."""
    return getattr(t, _SPEC_ATTR, None)


def mesh_of(t):
    """The mesh a marked shard belongs to, or None."""
    return getattr(t, _MESH_ATTR, None)


def set_spec(t, spec, mesh):
    """Mark ``t`` as a shard of ``spec`` on ``mesh`` (None or
    all-replicated: unmarked)."""
    if spec is not None and any(e is not None for e in spec):
        setattr(t, _SPEC_ATTR, tuple(spec))
        setattr(t, _MESH_ATTR, mesh)
    else:
        for a in (_SPEC_ATTR, _MESH_ATTR):
            if hasattr(t, a):
                delattr(t, a)
    return t


def mark_like(tree, like):
    """Mark every tensor of ``tree`` (e.g. optimizer moments) as its
    counterpart in ``like`` (same structure) is marked."""
    flat = {}
    _walk(like, lambda path, leaf: flat.__setitem__(path, leaf))

    def mark(path, leaf):
        src = flat.get(path)
        if isinstance(leaf, torch.Tensor) and isinstance(src, torch.Tensor):
            set_spec(leaf, spec_of(src), mesh_of(src))
        return leaf

    return _walk(tree, mark)


def global_shape(t, mesh) -> tuple:
    """The full shape of the shard ``t`` (its own shape when unmarked)."""
    spec = spec_of(t)
    if spec is None:
        return tuple(t.shape)
    return tuple(s * mesh.axis_size(dim_axes(e)) for s, e in zip(t.shape, spec))


def shard_slices(shape, spec, mesh) -> tuple:
    """The index of this rank's shard in a whole array of ``shape`` under
    ``spec`` (one slice per dim): the same cut for tensors on any device and
    for arrays on the host."""
    out = []
    for d, n in enumerate(shape):
        axes = dim_axes(spec[d]) if spec is not None and d < len(spec) else ()
        size = n // mesh.axis_size(axes)
        i = meshlib.axis_index(mesh, axes)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def shard_tensor(t: torch.Tensor, spec, mesh, *, copy: bool = True) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under ``spec`` (a new,
    contiguous tensor, marked with its spec). ``copy=False``: a view of
    ``t``'s storage where the shard is contiguous in it (all of ``t`` on one
    rank), for a reader that never writes it (the serving steps)."""
    out = t[shard_slices(t.shape, spec, mesh)] if t.dim() else t
    out = out.detach().clone().contiguous() if copy else out.detach().contiguous()
    if t.requires_grad and copy:
        out.requires_grad_(True)
    return set_spec(out, spec, mesh)


def gather_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor from this rank's shard ``t`` (an all-gather over each
    sharded dimension's axes)."""
    out = t.detach()
    for d, e in enumerate(spec or ()):
        axes = dim_axes(e)
        if axes:
            out = meshlib.all_gather(out, axes, mesh, axis=d)
    return out.contiguous()


def shard_tree(full_tree, specs, mesh, *, copy: bool = True):
    """This rank's shard of every tensor leaf of ``full_tree`` (``specs``:
    a tree of the same structure, e.g. :func:`param_specs`; None leaves and
    non-tensors pass through); ``copy``: :func:`shard_tensor`'s."""
    flat_specs = {}
    _walk(specs, lambda path, s: flat_specs.__setitem__(path, s))

    def cut(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return shard_tensor(leaf, flat_specs.get(path), mesh, copy=copy)

    return _walk(full_tree, cut)


def gather_tree(local_tree, mesh, specs=None):
    """The full tree from this rank's shards (``specs`` default: each leaf's
    mark). Every rank gets every leaf."""
    flat_specs = {}
    if specs is not None:
        _walk(specs, lambda path, s: flat_specs.__setitem__(path, s))

    def grow(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = flat_specs.get(path) if specs is not None else spec_of(leaf)
        return gather_tensor(leaf, spec, mesh)

    return _walk(local_tree, grow)
