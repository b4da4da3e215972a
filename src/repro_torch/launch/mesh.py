"""Named-axis meshes over ``torch.distributed``, and their collectives.

Port of ``repro/launch/mesh.py``. JAX builds global programs and places them
on a ``Mesh``; the port runs SPMD on explicit shards: every rank holds its
local shard of each leaf, and the bodies that JAX runs inside ``shard_map``
are plain functions on local tensors whose collectives run over the process
groups of the mesh's axes. :class:`Mesh` keeps JAX's reading (``mesh.shape``
maps an axis name to its size, ``mesh.axis_names``) and adds one process
group per axis and per tuple of axes.

The collectives keep ``jax.lax``'s names, so a body reads like its JAX
counterpart:

========================  ==========================================
JAX                       here
========================  ==========================================
``psum(x, axes)``         :func:`psum`: ``all_reduce`` (sum)
``pmax(x, axes)``         :func:`pmax`: ``all_reduce`` (max)
``psum_scatter(tiled)``   :func:`psum_scatter`: ``reduce_scatter_tensor``
``all_gather(tiled)``     :func:`all_gather`: ``all_gather_into_tensor``
``axis_index(axes)``      :func:`axis_index` (``get_local_rank`` per axis)
========================  ==========================================

Several axes act as one, row-major over the mesh's axis order, as in JAX.
On an axis (or tuple) of one rank a collective is the identity and is not
called. Each wrapper counts the bytes of the payload a rank hands it
(:func:`collective_bytes`) whenever it is given at least one axis, whether
or not the axes have other ranks (so a one-rank mesh still shows what a
step would move: :func:`gather_replicated` and :func:`slice_replicated`
too, in their forward and backward), as
``kernels/ops.launch_counts()`` counts launches: that counter is how the
tests and the card see the compressed DP gradient collective. Beside the
payload it counts the WIRE bytes of each call under its HLO kind, JAX's
ring model at the call's group size (``launch.hlo_analysis.wire_bytes``:
all-reduce 2(n-1)/n of the buffer, ``pmax`` included; all-gather (n-1)/n
of the gathered output; reduce-scatter (n-1) x the scattered output); a
call on a one-rank group puts nothing on the wire.

Defined as functions: importing this module touches no process group.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["Mesh", "Axes", "layout", "make_mesh", "make_production_mesh", "dp_axes", "mp_axes",
           "psum", "pmax", "psum_scatter", "all_gather", "axis_index", "chunk_of", "collective_bytes",
           "reset_collective_bytes", "gather_replicated",
           "slice_replicated", "copy_to", "reduce_from", "psum_partial", "pmean_shared",
           "split_partial", "gather_partial", "scatter_partial"]

_BYTES: Dict[str, int] = {"psum": 0, "pmax": 0, "psum_scatter": 0, "all_gather": 0}
# the HLO kind each wrapper is, for its wire bytes
_KIND = {"psum": "all-reduce", "pmax": "all-reduce", "psum_scatter": "reduce-scatter",
         "all_gather": "all-gather"}
_WIRE: Dict[str, float] = {k: 0.0 for k in set(_KIND.values())}
_CALLS: Dict[str, int] = {k: 0 for k in _WIRE}


def collective_bytes() -> dict:
    """Payload bytes handed to each collective on this rank since the last
    reset and their ``total``; ``wire``: the wire bytes per HLO kind
    (module docstring) with their ``total``; ``calls``: the calls per kind
    on groups of more than one rank."""
    return dict(_BYTES, total=sum(_BYTES.values()),
                wire=dict(_WIRE, total=sum(_WIRE.values())), calls=dict(_CALLS))


def reset_collective_bytes() -> None:
    for k in _BYTES:
        _BYTES[k] = 0
    for k in _WIRE:
        _WIRE[k] = 0.0
        _CALLS[k] = 0


class Mesh:
    """A named-axis mesh: ``shape`` (axis name -> size), ``axis_names``, and,
    when built by :func:`make_mesh`, this rank's coordinates and the process
    groups. A mesh from :func:`layout` has no groups: sharding specs are
    computed from it without a process group."""

    def __init__(self, shape, axes, *, device=None, device_mesh=None, rank: int = 0):
        shape = tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.devices_shape = shape
        self.size = math.prod(shape)
        self.device = device
        self.device_mesh = device_mesh
        self.rank = rank
        # row-major coordinates of this rank (the DeviceMesh is arange(size))
        self.coords = dict(zip(axes, _unravel(rank, shape)))
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self):
        return f"Mesh({self.shape})"

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name, a tuple of names or None) as a tuple in mesh order."""
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not in the mesh's axes {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def group(self, axes):
        axes = self.axes(axes)
        if self.device_mesh is None:
            raise RuntimeError("a mesh from layout() has no process groups; build it with "
                               "make_mesh() after torch.distributed.init_process_group")
        return self._groups[axes]


class Axes:
    """Some of a mesh's axes, as a body names them in JAX (``psum(x,
    ("data",))``): what ``score_psum_axes`` carries into the sketch."""

    def __init__(self, mesh: Mesh, names):
        self.mesh = mesh
        self.names = mesh.axes(names)
        self.size = mesh.axis_size(self.names)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return psum(x, self.names, self.mesh)

    def __repr__(self):
        return f"Axes({self.names})"


def _unravel(i: int, shape) -> tuple:
    out = []
    for s in reversed(shape):
        out.append(i % s)
        i //= s
    return tuple(reversed(out))


def layout(shape, axes) -> Mesh:
    """A mesh's shape and axis names without process groups: what the
    sharding rules read."""
    return Mesh(shape, axes)


def make_mesh(shape, axes, *, device="cuda") -> Mesh:
    """A mesh over the initialised default process group, whose world size
    must be the product of ``shape``. Ranks are laid out row-major. The
    device type comes from :func:`~repro_torch.device.resolve_device`
    (``"cuda"`` by default; the tests pass ``"cpu"`` with the gloo backend).
    Raises without an initialised process group: there is no one-process
    fallback."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group "
                           "(init_process_group with its address, world size and rank)")
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the process group "
                         f"has {world}")
    dev = resolve_device(device)
    from torch.distributed.device_mesh import init_device_mesh

    dmesh = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    mesh = Mesh(shape, axes, device=dev, device_mesh=dmesh, rank=dist.get_rank())
    for a in axes:
        if dmesh.get_local_rank(a) != mesh.coords[a]:
            raise RuntimeError(f"DeviceMesh coordinate of axis {a!r} is not row-major")
        mesh._groups[(a,)] = dmesh.get_group(a)
    # groups over several axes, created in the same order on every rank
    for k in range(2, len(axes) + 1):
        for sub in itertools.combinations(axes, k):
            rest = [a for a in axes if a not in sub]
            mine = None
            for fixed in itertools.product(*(range(mesh.shape[a]) for a in rest)):
                pin = dict(zip(rest, fixed))
                ranks = []
                for free in itertools.product(*(range(mesh.shape[a]) for a in sub)):
                    c = dict(pin, **dict(zip(sub, free)))
                    ranks.append(_ravel([c[a] for a in axes], shape))
                g = dist.new_group(ranks)
                if all(mesh.coords[a] == pin[a] for a in rest):
                    mine = g
            mesh._groups[sub] = mine
    return mesh


def _ravel(coords, shape) -> int:
    i = 0
    for c, s in zip(coords, shape):
        i = i * s + c
    return i


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """JAX's production meshes: (16, 16) ``("data", "model")``, or (2, 16,
    16) ``("pod", "data", "model")``; raises unless the world size is theirs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def dp_axes(mesh) -> tuple:
    """Axes that carry data parallelism (pod folds into DP by default)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a == "model")


# -- collectives under JAX's names ------------------------------------------


def _count(op: str, t: torch.Tensor, n: int = 1) -> None:
    """Count ``t``, the payload handed to ``op`` over a group of ``n``
    ranks: its bytes, and its wire bytes under the op's HLO kind."""
    size = t.numel() * t.element_size()
    _BYTES[op] += size
    if n > 1:
        from repro_torch.launch.hlo_analysis import wire_bytes

        kind = _KIND[op]
        result = {"psum_scatter": size // n, "all_gather": size * n}.get(op, size)
        _WIRE[kind] += wire_bytes(kind, result, n)
        _CALLS[kind] += 1


def axis_index(mesh: Mesh, axes) -> int:
    """This rank's index along ``axes`` (row-major over several)."""
    idx = 0
    for a in mesh.axes(axes):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def psum(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (a new tensor; ``x`` itself on one rank)."""
    if not mesh.axes(axes):
        return x
    _count("psum", x, mesh.axis_size(axes))
    if mesh.axis_size(axes) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.group(axes))
    return out


def pmax(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``axes`` (``x`` itself on one rank)."""
    if not mesh.axes(axes):
        return x
    _count("pmax", x, mesh.axis_size(axes))
    if mesh.axis_size(axes) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return out


def psum_scatter(x: torch.Tensor, axes, mesh: Mesh, *, scatter_dimension: int = 0,
                 tiled: bool = True) -> torch.Tensor:
    """Sum over ``axes``, then keep this rank's chunk of ``scatter_dimension``."""
    if not tiled:
        raise NotImplementedError("psum_scatter is ported with tiled=True only")
    if not mesh.axes(axes):
        return x
    n = mesh.axis_size(axes)
    _count("psum_scatter", x, n)
    if n == 1:
        return x
    d = scatter_dimension % x.dim()
    src = x.movedim(d, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"psum_scatter: dim {d} of {tuple(x.shape)} does not split {n} ways")
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, src, group=mesh.group(axes))
    return out.movedim(0, d)


def all_gather(x: torch.Tensor, axes, mesh: Mesh, *, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """The chunks of ``axes``' ranks concatenated along ``axis`` (tiled)."""
    if not tiled:
        raise NotImplementedError("all_gather is ported with tiled=True only")
    if not mesh.axes(axes):
        return x
    n = mesh.axis_size(axes)
    _count("all_gather", x, n)
    if n == 1:
        return x
    d = axis % x.dim()
    src = x.movedim(d, 0).contiguous()
    out = torch.empty((src.shape[0] * n,) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, src, group=mesh.group(axes))
    # contiguous in the input's layout, so what reads it reduces in the
    # single-device order
    return out.movedim(0, d).contiguous()


def chunk_of(x: torch.Tensor, axes, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` over ``axes`` (no collective)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axes) * size, size)


# -- differentiable movement between layouts ---------------------------------
#
# The port's convention for autograd across ranks: a tensor replicated over
# an axis holds the same values on every rank of it, and every rank holds its
# full cotangent (not a partial sum). Then gathering a sharded tensor into a
# replicated one has a slice as its backward, and slicing a replicated one
# has a gather. (A weight gathered over the data axes, whose cotangents ARE
# partial sums, is core.site.gather_param: its backward reduce-scatters.)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return all_gather(x, axes, mesh, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return chunk_of(g, ctx.axes, ctx.mesh, ctx.dim), None, None, None


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        if mesh.axis_size(axes) == 1:
            return x.view_as(x)
        return chunk_of(x, axes, mesh, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axes, ctx.mesh, axis=ctx.dim), None, None, None


def gather_replicated(x, axes, mesh: Mesh, dim: int):
    """All-gather ``x`` over ``axes`` along ``dim`` into a tensor the ranks of
    ``axes`` compute with alike; backward: this rank's slice."""
    if not mesh.axes(axes):
        return x
    return _GatherReplicated.apply(x, mesh.axes(axes), mesh, dim)


def slice_replicated(x, axes, mesh: Mesh, dim: int):
    """This rank's chunk of a tensor replicated over ``axes``; backward: the
    all-gather of the chunks' cotangents."""
    if not mesh.axes(axes):
        return x
    return _SliceReplicated.apply(x, mesh.axes(axes), mesh, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axes, ctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        out = psum(x, axes, mesh)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x, axes, mesh: Mesh):
    """``x`` (replicated over ``axes``) entering work that each rank of
    ``axes`` does a part of: identity forward; backward: the all-reduce of
    the ranks' partial cotangents (Megatron's ``f``)."""
    if not mesh.axes(axes):
        return x
    return _CopyTo.apply(x, mesh.axes(axes), mesh)


def reduce_from(x, axes, mesh: Mesh):
    """The sum over ``axes`` of the ranks' partial results, replicated over
    them; identity backward: every rank holds the full cotangent of the sum
    (Megatron's ``g``)."""
    if not mesh.axes(axes):
        return x
    return _ReduceFrom.apply(x, mesh.axes(axes), mesh)


# -- tensors whose cotangents are partial sums ----------------------------------
#
# Over the data axes each rank's loss is its share of the global one, so the
# cotangents there are partial sums that the train step completes by summing
# the gradients over the data axes. The functions below move such tensors.


class _PsumPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        out = psum(x, axes, mesh)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axes, ctx.mesh), None, None


class _PmeanShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return psum(x, axes, mesh) / mesh.axis_size(axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SplitPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim, ctx.n = axes, mesh, dim, x.shape[dim]
        return chunk_of(x, axes, mesh, dim).clone()

    @staticmethod
    def backward(ctx, g):
        size = g.shape[ctx.dim]
        shape = list(g.shape)
        shape[ctx.dim] = ctx.n
        out = g.new_zeros(shape)
        out.narrow(ctx.dim, axis_index(ctx.mesh, ctx.axes) * size, size).copy_(g)
        return out, None, None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return all_gather(x, axes, mesh, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return psum_scatter(g, ctx.axes, ctx.mesh, scatter_dimension=ctx.dim), None, None, None


class _ScatterPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        out = psum_scatter(x, axes, mesh, scatter_dimension=dim)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axes, ctx.mesh, axis=ctx.dim), None, None, None


def psum_partial(x, axes, mesh: Mesh):
    """The sum over ``axes`` replicated on their ranks, each of which reads
    it for its own part of the work (a norm's sum of squares over a model
    chunk of channels): all-reduce forward and backward."""
    if not mesh.axes(axes):
        return x
    return _PsumPartial.apply(x, mesh.axes(axes), mesh)


def pmean_shared(x, axes, mesh: Mesh):
    """The mean over ``axes`` of the ranks' values (statistics of their own
    rows, as JAX's ``pmean``), with an identity backward: each rank's loss
    carries its share of what reads the mean, so the ranks' gradients sum
    to the gradient of the whole."""
    if not mesh.axes(axes):
        return x
    return _PmeanShared.apply(x, mesh.axes(axes), mesh)


def split_partial(x, axes, mesh: Mesh, dim: int = 0):
    """This rank's chunk along ``dim`` of a tensor every rank of ``axes``
    holds whole; backward: the chunk's cotangent in place and zeros
    elsewhere (this rank's share, which the ranks' sum completes)."""
    if not mesh.axes(axes):
        return x
    return _SplitPartial.apply(x, mesh.axes(axes), mesh, dim)


def gather_partial(x, axes, mesh: Mesh, dim: int = 0):
    """The chunks of ``axes``' ranks all-gathered along ``dim``; backward:
    the ranks' partial cotangents summed and this rank's chunk kept
    (a reduce-scatter). The inverse of :func:`split_partial`, and the
    sequence-parallel layout's entry into a tensor-parallel block (the
    sequence all-gathered over model; Megatron-SP's ``g``)."""
    if not mesh.axes(axes):
        return x
    return _GatherPartial.apply(x, mesh.axes(axes), mesh, dim)


def scatter_partial(x, axes, mesh: Mesh, dim: int = 1):
    """The ranks' partial results summed over ``axes``, this rank keeping
    its chunk along ``dim`` (a reduce-scatter); backward: the chunks'
    cotangents all-gathered. The sequence-parallel layout's exit from a
    tensor-parallel block (Megatron-SP's ``g-bar``), where
    :func:`reduce_from` all-reduces in the fixed layout."""
    if not mesh.axes(axes):
        return x
    return _ScatterPartial.apply(x, mesh.axes(axes), mesh, dim)
