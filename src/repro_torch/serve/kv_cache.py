"""Paged KV cache: fixed-size pages, a per-slot page map and a trash page
(port of ``repro/serve/kv_cache.py``).

The port's decode caches are a list with one dict per layer
(``lm.init_cache``), batch first: ``{"k", "v"}`` of ``[n_slots, size, n_kv,
d_head]`` for attention, a Mamba or RWKV layer's recurrent state. Paged
mode replaces each full-length leaf with a physical page pool
``[pool_pages, page_size, n_kv, d_head]`` (same list, same keys) plus one
shared int page map ``[n_slots, pages_per_slot]`` of physical page ids.
Page 0 is the **trash page**: a freed slot points every map entry at it,
so its decode writes land in storage nothing reads back unmasked.

A decode step composes the three operations below: :func:`gather_slots`
builds the slot-major caches ``lm.decode_step`` takes, the step writes the
new token's key and value into them, and :func:`scatter_token` copies that
one column back into the pools. JAX's operations are functional; the port's
write into their first argument in place (as the port's ``decode_step``
writes into its caches) and return it. So :func:`gather_slots` returns a
**copy**: the decode step's in-place write must not reach the pools except
through the scatter.

Under a mesh (the Runtime's ``ExecutionConfig(mesh=...)``) every rank holds
its shard of the pools by ``launch.sharding.paged_cache_specs``: the pages
over the data axes where ``pool_pages`` divides them, a page's interior and
the page map whole. The operations then take ``mesh``:
:func:`gather_slots` all-gathers the pools' pages over data and builds the
caches of this rank's slots (over data where ``n_slots`` divides them,
``launch.sharding.rows_axes``) with the sequence whole; :func:`scatter_token`
all-gathers the slots' new columns over data and each rank writes those
whose page it holds; :func:`insert_prompt_pages` gathers the prefilled
row's positions over model (the prefill cache's layout splits them) and
writes the pages this rank holds. The slot-major caches of the contiguous
layout keep ``cache_specs``' layout, and :func:`insert_prompt_rows` moves a
prefilled row to the data rank that holds its slot. Every move is a
counted collective (``launch.mesh.collective_bytes``).

Layout selection is shape-driven (:func:`plan_layout`), as in JAX: every
cache leaf is ``"kv_full"`` (attention K/V of ``max_len`` positions),
``"kv_ring"`` (a window shorter than ``max_len``: ``nn/attention.py``'s
ring), ``"state"`` (a recurrent layer's) or ``"cross"`` (an
encoder-decoder's cross-attention memory, which the engines refuse). Paging
needs every leaf ``kv_full``; rings and states fall back to the contiguous
slot-major layout, and states also forbid padding (``pad_ok``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.config import ServeConfig

__all__ = ["CacheLayout", "plan_layout", "init_pools", "gather_slots",
           "scatter_token", "insert_prompt_pages", "insert_prompt_rows"]


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """Resolved cache layout for one (arch, ServeConfig) pair.

    * ``paged`` — pool + page-map storage (requires ``pack_ok``).
    * ``pack_ok`` — every leaf is full-length attention K/V, so several
      prompts may share one segment-masked prefill row and be inserted
      page-wise.
    * ``pad_ok`` — no recurrent state: prompts may be right-padded to a
      prefill bucket (pad keys are segment-masked out of attention, a full
      cache's garbage beyond the prompt is hidden by the ``idx <= pos``
      decode mask until overwritten, and a ring is filled from the row's
      valid tokens alone). A recurrent state integrates pads irreversibly,
      so ``pad_ok=False`` layouts prefill at each prompt's exact length.
    * ``leaf_kinds`` — ``"kv_full"``, ``"kv_ring"``, ``"state"`` or
      ``"cross"`` per cache leaf, layer by layer in each layer dict's order
      (JAX lists one per stacked leaf, so the two agree as sets).
    """

    paged: bool
    pack_ok: bool
    pad_ok: bool
    leaf_kinds: tuple


def _meta_caches(cfg: ArchConfig, max_len: int):
    """``lm.init_cache(cfg, 1, max_len)`` as meta tensors: shapes and dtypes,
    no storage."""
    lm.check_decoder(cfg)
    meta = torch.device("meta")
    return [lm.layer_cache(cfg, kind, 1, max_len, device=meta) for kind in lm.layer_kinds(cfg)]


def _leaf_kind(path: str, shape, max_len: int) -> str:
    """JAX's ``_leaf_kind``: a cross-attention memory, attention K/V (full or
    ring by its length) or recurrent state."""
    if "cross" in path:
        return "cross"
    if path.endswith("/k") or path.endswith("/v"):
        return "kv_full" if shape[1] == max_len else "kv_ring"
    return "state"


def _paths(tree, prefix=""):
    """(path, leaf) of a nested dict's tensors, in key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def plan_layout(cfg: ArchConfig, serve: ServeConfig) -> CacheLayout:
    """Classify the arch's cache leaves and pick paged or contiguous."""
    kinds = tuple(_leaf_kind(path, leaf.shape, serve.max_len)
                  for layer in _meta_caches(cfg, serve.max_len) for path, leaf in _paths(layer))
    pack_ok = bool(kinds) and all(k == "kv_full" for k in kinds)
    pad_ok = bool(kinds) and all(k in ("kv_full", "kv_ring") for k in kinds)
    paged = serve.page_size is not None and pack_ok
    return CacheLayout(paged=paged, pack_ok=pack_ok, pad_ok=pad_ok, leaf_kinds=kinds)


def init_pools(cfg: ArchConfig, serve: ServeConfig, *, device="cuda", mesh=None):
    """Zero page pools mirroring the caches: each layer's ``[1, max_len, n_kv,
    d_head]`` leaf becomes ``[pool_pages, page_size, n_kv, d_head]``, on
    ``device``; with ``mesh``, this rank's shards (``paged_cache_specs``)."""
    dev = resolve_device(device)
    P = serve.page_size
    meta = torch.device("meta")
    shapes = [{k: torch.zeros((serve.pool_pages, P) + tuple(leaf.shape[2:]), dtype=leaf.dtype,
                              device=meta) for k, leaf in layer.items()}
              for layer in _meta_caches(cfg, serve.max_len)]
    if mesh is not None:
        from repro_torch.launch import sharding

        return sharding.zeros_shards(
            shapes, sharding.paged_cache_specs(shapes, mesh, serve.pool_pages), mesh, dev)
    return [{k: torch.zeros(v.shape, dtype=v.dtype, device=dev) for k, v in layer.items()}
            for layer in shapes]


def _page_axes(pool, mesh) -> tuple:
    """The data axes a pool shard's pages are split over (none off a mesh)."""
    from repro_torch.launch.sharding import dim_axes, spec_of

    spec = spec_of(pool) if mesh is not None else None
    return dim_axes(spec[0]) if spec is not None else ()


def _owned(pages, pool, mesh):
    """(local page ids, selection) of the global page ids ``pages`` in this
    rank's pool shard: the selection is None where the shard holds every
    page, else the boolean mask of the ids it holds."""
    from repro_torch.launch.mesh import axis_index

    axes = _page_axes(pool, mesh)
    if not axes or mesh.axis_size(axes) == 1:
        return pages, None
    lo = axis_index(mesh, axes) * pool.shape[0]
    local = pages - lo
    return local, (local >= 0) & (local < pool.shape[0])


def gather_slots(pools, page_map, serve: ServeConfig, mesh=None):
    """The contiguous slot-major caches ``lm.decode_step`` takes, as a new
    tensor per leaf: slot ``b`` holds ``pool[page_map[b]]`` concatenated
    along the sequence. ``page_map``: int tensor ``[B, pages_per_slot]`` on
    the pools' device. With ``mesh``: the caches of this rank's slots, their
    pages gathered from every data rank, marked (rows over data where they
    divide it, the sequence whole)."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding
    from repro_torch.serve.serve_step import own_rows

    P, pp = serve.page_size, serve.pages_per_slot
    B = page_map.shape[0]
    if mesh is not None:
        page_map = own_rows(page_map, mesh, B)
    n = page_map.shape[0]
    flat = page_map.reshape(-1).long()

    def gather(pool):
        if mesh is not None and _page_axes(pool, mesh):
            pool = meshlib.all_gather(pool, _page_axes(pool, mesh), mesh, axis=0)
        x = pool.index_select(0, flat)  # [n * pp, P, ...], a copy
        x = x.reshape((n, pp * P) + tuple(pool.shape[2:]))[:, :serve.max_len]
        if mesh is None:
            return x
        return sharding.set_spec(x, (sharding.rows_axes(B, mesh) or None, None, None, None),
                                 mesh)

    return [{k: gather(v) for k, v in layer.items()} for layer in pools]


def scatter_token(pools, new_caches, page_map, pos, serve: ServeConfig, mesh=None):
    """Write the one K/V column decode wrote at ``pos`` (int tensor ``[B]``,
    one position per slot) from ``new_caches`` back into ``pools``, in place;
    returns ``pools``. A freed slot's map row is all trash page 0, which
    absorbs its write (several freed slots may write the same trash row).
    With ``mesh``: ``new_caches`` hold this rank's slots (:func:`gather_slots`);
    their columns are all-gathered over data, and each rank writes those
    whose page its shard holds."""
    from repro_torch.serve.serve_step import own_rows, whole_rows

    P = serve.page_size
    B = page_map.shape[0]
    pos = pos.long()
    phys = page_map.long().gather(1, (pos // P)[:, None])[:, 0]  # [B]
    off = pos % P
    mine_pos = pos if mesh is None else own_rows(pos, mesh, B)
    rows = torch.arange(mine_pos.shape[0], device=pos.device)
    for pool_l, new_l in zip(pools, new_caches):
        for k, pool in pool_l.items():
            col = new_l[k][rows, mine_pos].to(pool.dtype)
            if mesh is None:
                pool[phys, off] = col
                continue
            col = whole_rows(col, mesh, B)
            local, sel = _owned(phys, pool, mesh)
            if sel is None:
                pool[local, off] = col
            else:
                pool[local[sel], off[sel]] = col[sel]
    return pools


def insert_prompt_pages(pools, pref_caches, phys_pages, src_page0: int, serve: ServeConfig,
                        mesh=None):
    """Copy one prefilled segment into its slot's pages, in place; returns
    ``pools``.

    ``pref_caches`` are prefill caches (batch 1, ``max_len`` positions)
    holding a packed row; the segment's tokens start at the page-aligned
    offset ``src_page0 * page_size``. ``phys_pages`` (int tensor
    ``[pages_per_slot]``) names the destination: the slot's physical pages
    for the prompt span, then trash page 0, so the pages beyond the prompt
    (other segments' data, or padding) land in the trash page and the copy
    keeps one shape for every bucket. Source pages past the row's end clip
    to its last page, as JAX's do. With ``mesh``: the row's positions are
    all-gathered over model where the prefill cache splits them, and each
    rank writes the pages its shard holds.
    """
    P, pp = serve.page_size, serve.pages_per_slot
    n_src = serve.max_len // P
    phys = phys_pages.long()
    src_idx = (int(src_page0) + torch.arange(pp, device=phys.device)).clamp(0, n_src - 1)
    for pool_l, pref_l in zip(pools, pref_caches):
        for k, pool in pool_l.items():
            pref = _whole_positions(pref_l[k], mesh)
            src = pref[0].reshape((n_src, P) + tuple(pref.shape[2:]))
            pages = src.index_select(0, src_idx).to(pool.dtype)
            local, sel = _owned(phys, pool, mesh)
            if sel is None:
                pool[local] = pages
            else:
                pool[local[sel]] = pages[sel]
    return pools


def _whole_positions(leaf, mesh):
    """A cache leaf with every position: all-gathered over the axes its
    spec splits them over (dim 1)."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.sharding import dim_axes, spec_of

    spec = spec_of(leaf) if mesh is not None else None
    axes = dim_axes(spec[1]) if spec is not None else ()
    return meshlib.all_gather(leaf, axes, mesh, axis=1) if axes else leaf


def insert_prompt_rows(dec_caches, pref_caches, slot: int, row: int = 0, mesh=None):
    """Contiguous-layout insert, in place: copy row ``row`` of every
    prefill-cache leaf (nested dicts included) into slot ``slot``; returns
    ``dec_caches``. A whole-row copy is exact for full-length caches, rings
    and recurrent state alike, because prefill builds its caches at the
    engine's own ``max_len``. With ``mesh`` (both trees in ``cache_specs``'
    layout, their positions split alike): the prefill's rows are
    all-gathered over data where they are split, and the data rank that
    holds slot ``slot`` writes it."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.sharding import dim_axes, spec_of

    def rows_of(t):
        spec = spec_of(t) if mesh is not None else None
        axes = dim_axes(spec[0]) if spec is not None else ()
        return axes if axes and mesh.axis_size(axes) > 1 else ()

    def copy(dec, pref):
        for k, d in dec.items():
            if isinstance(d, dict):
                copy(d, pref[k])
                continue
            src = pref[k]
            if rows_of(src):
                src = meshlib.all_gather(src, rows_of(src), mesh, axis=0)
            at = slot
            if rows_of(d):
                at = slot - meshlib.axis_index(mesh, rows_of(d)) * d.shape[0]
                if not 0 <= at < d.shape[0]:
                    continue
            d[at] = src[row].to(d.dtype)

    for dec_l, pref_l in zip(dec_caches, pref_caches):
        copy(dec_l, pref_l)
    return dec_caches
