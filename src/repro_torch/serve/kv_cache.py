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


def init_pools(cfg: ArchConfig, serve: ServeConfig, *, device="cuda"):
    """Zero page pools mirroring the caches: each layer's ``[1, max_len, n_kv,
    d_head]`` leaf becomes ``[pool_pages, page_size, n_kv, d_head]``, on
    ``device``."""
    dev = resolve_device(device)
    P = serve.page_size
    return [{k: torch.zeros((serve.pool_pages, P) + tuple(leaf.shape[2:]), dtype=leaf.dtype,
                            device=dev) for k, leaf in layer.items()}
            for layer in _meta_caches(cfg, serve.max_len)]


def gather_slots(pools, page_map, serve: ServeConfig):
    """The contiguous slot-major caches ``lm.decode_step`` takes, as a new
    tensor per leaf: slot ``b`` holds ``pool[page_map[b]]`` concatenated
    along the sequence. ``page_map``: int tensor ``[B, pages_per_slot]`` on
    the pools' device."""
    P, pp = serve.page_size, serve.pages_per_slot
    B = page_map.shape[0]
    flat = page_map.reshape(-1).long()

    def gather(pool):
        x = pool.index_select(0, flat)  # [B * pp, P, ...], a copy
        return x.reshape((B, pp * P) + tuple(pool.shape[2:]))[:, :serve.max_len]

    return [{k: gather(v) for k, v in layer.items()} for layer in pools]


def scatter_token(pools, new_caches, page_map, pos, serve: ServeConfig):
    """Write the one K/V column decode wrote at ``pos`` (int tensor ``[B]``,
    one position per slot) from ``new_caches`` back into ``pools``, in place;
    returns ``pools``. A freed slot's map row is all trash page 0, which
    absorbs its write (several freed slots may write the same trash row)."""
    P = serve.page_size
    B = page_map.shape[0]
    pos = pos.long()
    phys = page_map.long().gather(1, (pos // P)[:, None])[:, 0]  # [B]
    off = pos % P
    rows = torch.arange(B, device=pos.device)
    for pool_l, new_l in zip(pools, new_caches):
        for k, pool in pool_l.items():
            pool[phys, off] = new_l[k][rows, pos].to(pool.dtype)
    return pools


def insert_prompt_pages(pools, pref_caches, phys_pages, src_page0: int, serve: ServeConfig):
    """Copy one prefilled segment into its slot's pages, in place; returns
    ``pools``.

    ``pref_caches`` are prefill caches (batch 1, ``max_len`` positions)
    holding a packed row; the segment's tokens start at the page-aligned
    offset ``src_page0 * page_size``. ``phys_pages`` (int tensor
    ``[pages_per_slot]``) names the destination: the slot's physical pages
    for the prompt span, then trash page 0, so the pages beyond the prompt
    (other segments' data, or padding) land in the trash page and the copy
    keeps one shape for every bucket. Source pages past the row's end clip
    to its last page, as JAX's do.
    """
    P, pp = serve.page_size, serve.pages_per_slot
    n_src = serve.max_len // P
    phys = phys_pages.long()
    src_idx = (int(src_page0) + torch.arange(pp, device=phys.device)).clamp(0, n_src - 1)
    for pool_l, pref_l in zip(pools, pref_caches):
        for k, pool in pool_l.items():
            pref = pref_l[k]
            src = pref[0].reshape((n_src, P) + tuple(pref.shape[2:]))
            pool[phys] = src.index_select(0, src_idx).to(pool.dtype)
    return pools


def insert_prompt_rows(dec_caches, pref_caches, slot: int, row: int = 0):
    """Contiguous-layout insert, in place: copy row ``row`` of every
    prefill-cache leaf (nested dicts included) into slot ``slot``; returns
    ``dec_caches``. A whole-row copy is exact for full-length caches, rings
    and recurrent state alike, because prefill builds its caches at the
    engine's own ``max_len``."""

    def copy(dec, pref):
        for k, d in dec.items():
            if isinstance(d, dict):
                copy(d, pref[k])
            else:
                d[slot] = pref[k][row].to(d.dtype)

    for dec_l, pref_l in zip(dec_caches, pref_caches):
        copy(dec_l, pref_l)
    return dec_caches
