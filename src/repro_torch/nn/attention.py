"""GQA attention: causal or bidirectional self-attention and cross-attention;
training, prefill and decode.

Port of ``repro/nn/attention.py``: sketched q/k/v/o projections, RoPE or
M-RoPE, and the attention core, in JAX's three impls:

* ``chunked`` (every config's default): JAX's double-chunked online
  softmax. Queries go in chunks of ``q_chunk``, keys in tiles of
  ``kv_chunk``; each tile's scores ``[B, H, Cq, ck]`` are masked, reduced
  to a running max, denominator and weighted sum of values, and merged with
  the tiles before it in order. No ``[B, H, Sq, Skv]`` tensor is built, and
  each query chunk runs under ``torch.utils.checkpoint`` (JAX's
  ``jax.checkpoint(one_chunk)``), so the backward keeps each chunk's inputs
  and recomputes its tiles. The full path computes every tile, masked ones
  included, so its FLOPs equal the einsum's; a causal sliding-window layer
  whose keys outrun ``window + Cq`` slices only those keys per query chunk
  (``(window + Cq) / Skv`` of the FLOPs).
* ``einsum``: the plain float32 scores and softmax over the whole
  ``[B, H, Sq, Skv]``.
* ``pallas``: a call without segment ids launches the flash-attention
  kernel (``kernels/ops.py``); a call with segments takes the chunked path,
  as JAX's does.

JAX's ``cost_mode`` tile enlargement has no counterpart (``docs/port.md``).
Decode attends one query per row against the KV cache with a masked einsum
on the unrepeated cache.

Cross-attention (``memory=``, the encoder's output): k and v project the
memory, q the decoder's stream; no rotation of k, no segment mask, and no
causal mask (its config has ``causal=False``), so the flash kernel runs it
with Sq (the decoder's length) beside Skv (the encoder's).

Caches are written in place (JAX returns new arrays): a decode step writes
one position of each layer's cache instead of copying it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.nn.common import MODEL_SHARDED_IN, MODEL_SHARDED_OUT, Ctx, dense, dense_init
from repro_torch.nn.rope import apply_mrope, apply_rope

__all__ = ["AttnCfg", "attn_init", "attention", "decode_attention", "init_kv_cache",
           "multi_head_attention"]


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv: int
    d_head: int
    causal: bool = True
    window: Optional[int] = None  # sliding window (None = full)
    rope: str = "default"  # default | mrope | none
    theta: float = 10000.0
    q_chunk: int = 512
    kv_chunk: int = 512
    impl: str = "chunked"  # chunked | einsum | pallas
    cross: bool = False  # cross-attention (no rope on the kv side, bidirectional)

    @property
    def groups(self) -> int:
        return self.n_heads // self.n_kv


def attn_init(gen, d_model: int, cfg: AttnCfg, dtype=torch.float32, device="cpu"):
    dh, H, Kv = cfg.d_head, cfg.n_heads, cfg.n_kv
    return {
        "q": dense_init(gen, d_model, H * dh, dtype, device=device),
        "k": dense_init(gen, d_model, Kv * dh, dtype, device=device),
        "v": dense_init(gen, d_model, Kv * dh, dtype, device=device),
        "o": dense_init(gen, H * dh, d_model, dtype, device=device, scale=(H * dh) ** -0.5),
    }


def _repeat_kv(q, k, v):
    """k, v repeated to q's heads (GQA's flat-head layout; the group size
    from the shapes, so a rank's local heads repeat alike)."""
    G = q.shape[2] // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    return k, v


def _f32(t):
    return t if t.dtype == torch.float32 else t.to(torch.float32)


# The chunked impl keeps JAX's algorithm in a head-major layout: q, k, v as
# [B, H, S, dh] (one transpose each up front), so each tile is two batched
# matmuls with no per-tile permutes; the running statistics are [B, H, Cq]
# and the weighted sums [B, H, Cq, dh] (JAX: [B, Cq, H, dh]).


def _tile(q, k, v, scale, mask, v_dtype):
    """One attention tile (JAX's ``_tile``): q [B, H, Cq, dh], k/v [B, H,
    Ck, dh] float32, mask [Cq, Ck] or [B, Cq, Ck] or None. Returns the
    running max and denominator [B, H, Cq] and the weighted sum of values
    [B, H, Cq, dh], float32; p is rounded to ``v_dtype``, v's own type, as
    JAX feeds its second matmul."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask if mask.dim() == 2 else mask[:, None], s, -1e30)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(-1), torch.matmul(_f32(p.to(v_dtype)), v)


def _merge(m1, l1, a1, m2, l2, a2):
    """Two tiles' statistics combined (JAX's ``_merge``): a tile whose max
    is -1e30 (every key masked) is scaled by exp(-1e30 - m) = 0 once a later
    tile has a valid key."""
    m = torch.maximum(m1, m2)
    e1 = torch.exp(m1 - m)
    e2 = torch.exp(m2 - m)
    return m, l1 * e1 + l2 * e2, a1 * e1[..., None] + a2 * e2[..., None]


def _q_chunk_full(qi, k, v, qpos, seg_qi, seg_k, scale, causal, window, ck, kv_valid,
                  v_dtype):
    """All keys for one query chunk, tile by tile (JAX's ``_q_chunk_full``):
    ``k``/``v`` [B, H, Skv_pad, dh], ``qpos`` [Cq] the chunk's positions,
    ``seg_qi`` [B, Cq] / ``seg_k`` [B, Skv_pad] per-row segment ids (0 =
    padding) or None; keys at or past ``kv_valid`` (an int or None) are
    padding. The chunk's mask over every key is built once and each tile
    reads its columns. JAX merges the first tile into a zero start (max
    -1e30, sums 0), which returns that tile's statistics unchanged (exp(0)
    = 1, 0 + x = x), so the merges start from the first tile."""
    kp = torch.arange(k.shape[2], device=qi.device)
    mask = None
    if causal:
        d = qpos[:, None] - kp[None, :]
        mask = d >= 0
        if window is not None:
            mask &= d < window
    if kv_valid is not None:
        vmask = (kp < kv_valid)[None, :]
        mask = vmask if mask is None else mask & vmask
    if seg_qi is not None:
        smask = (seg_qi[:, :, None] == seg_k[:, None, :]) & (seg_k[:, None, :] > 0)
        mask = smask if mask is None else mask[None] & smask
    stats = None
    for j in range(k.shape[2] // ck):
        cols = slice(j * ck, (j + 1) * ck)
        tile = _tile(qi, k[:, :, cols], v[:, :, cols], scale,
                     None if mask is None else mask[..., cols], v_dtype)
        stats = tile if stats is None else _merge(*stats, *tile)
    return stats


def _q_chunk_window(qi, k_pad, v_pad, qpos, seg_qi, seg_k_pad, scale, window, start,
                    kv_valid, v_dtype):
    """Sliding-window attention for one query chunk (JAX's
    ``_q_chunk_window``): ``k_pad``/``v_pad`` are left-padded by ``window``,
    so the chunk's keys lie at padded offsets [start, start + window + Cq),
    ``start`` the chunk's first query position; ``seg_k_pad`` is padded
    alike (0 = padding)."""
    span = window + qi.shape[2]
    kp = start - window + torch.arange(span, device=qi.device)  # original positions
    valid = (kp >= 0) & (kp < kv_valid)
    d = qpos[:, None] - kp[None, :]
    mask = (d >= 0) & (d < window) & valid[None, :]
    if seg_qi is not None:
        sk = seg_k_pad[:, start:start + span]
        mask = mask[None] & (seg_qi[:, :, None] == sk[:, None, :]) & (sk[:, None, :] > 0)
    keys = slice(start, start + span)
    return _tile(qi, k_pad[:, :, keys], v_pad[:, :, keys], scale, mask, v_dtype)


def _chunked(q, k, v, cfg: AttnCfg, q_offset: int, segs):
    """JAX's chunked impl (module docstring): k/v already on q's heads."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    scale = dh ** -0.5
    Cq = min(cfg.q_chunk, Sq)
    Sq_pad = -(-Sq // Cq) * Cq
    ck = min(cfg.kv_chunk, Skv)
    Skv_pad = -(-Skv // ck) * ck
    use_window = cfg.window is not None and cfg.causal and Skv > cfg.window + Cq
    qh = F.pad(_f32(q).transpose(1, 2), (0, 0, 0, Sq_pad - Sq))
    seg_q = None if segs is None else F.pad(segs, (0, Sq_pad - Sq))
    # left-pad by the window and right-pad to cover the padded query
    # chunks (the window path), or right-pad to whole tiles
    lo, hi = (cfg.window, max(0, Sq_pad - Skv)) if use_window else (0, Skv_pad - Skv)
    k_in = F.pad(_f32(k).transpose(1, 2), (0, 0, lo, hi))
    v_in = F.pad(_f32(v).transpose(1, 2), (0, 0, lo, hi))
    seg_k = None if segs is None else F.pad(segs, (lo, hi))
    kv_valid = Skv if (use_window or Skv_pad != Skv) else None
    window = cfg.window if cfg.causal else None

    def one_chunk(qi, k_in, v_in, i):
        start = i * Cq
        qpos = q_offset + torch.arange(start, start + Cq, device=qi.device)
        seg_qi = None if seg_q is None else seg_q[:, start:start + Cq]
        if use_window:
            m, l, acc = _q_chunk_window(qi, k_in, v_in, qpos, seg_qi, seg_k, scale, cfg.window,
                                        start, kv_valid, v.dtype)
        else:
            m, l, acc = _q_chunk_full(qi, k_in, v_in, qpos, seg_qi, seg_k, scale, cfg.causal,
                                      window, ck, kv_valid, v.dtype)
        return (acc / l[..., None].clamp_min(1e-30)).to(q.dtype)

    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for i in range(Sq_pad // Cq):
        qi = qh[:, :, i * Cq:(i + 1) * Cq]
        if remat:
            # JAX's jax.checkpoint(one_chunk): the backward recomputes the
            # chunk's tiles; no random numbers are drawn, so no RNG state
            outs.append(checkpoint(one_chunk, qi, k_in, v_in, i, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(one_chunk(qi, k_in, v_in, i))
    o = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    return o[:, :, :Sq].transpose(1, 2)


def multi_head_attention(q, k, v, cfg: AttnCfg, *, q_offset: int = 0, segs=None):
    """q [B, Sq, H, dh], k/v [B, Skv, Kv, dh] -> [B, Sq, H, dh].

    ``impl="pallas"`` without ``segs`` launches the flash kernel. Otherwise
    k/v are repeated to q's heads and ``impl="einsum"`` forms the float32
    scores and softmax whole, ``"chunked"`` (and ``"pallas"`` with
    ``segs``) runs :func:`_chunked`. Query ``i`` sits at position
    ``q_offset + i`` and key ``j`` at ``j`` for the causal and window masks
    (JAX's positions); with ``segs`` (int [B, S], self-attention, 0 =
    padding) query i sees key j only if ``segs[b, i] == segs[b, j] > 0``."""
    if cfg.impl == "pallas" and segs is None:
        return ops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
    if cfg.impl not in ("chunked", "einsum", "pallas"):
        raise ValueError(f"unknown attention impl {cfg.impl!r}: chunked | einsum | pallas")
    k, v = _repeat_kv(q, k, v)
    if cfg.impl != "einsum":
        return _chunked(q, k, v, cfg, q_offset, segs)
    Sq, dh = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    s = torch.einsum("bqhd,bchd->bhqc", q.to(torch.float32), k.to(torch.float32)) * dh ** -0.5
    mask = None
    if cfg.causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = qpos >= kpos
        if cfg.window:
            mask &= (qpos - kpos) < cfg.window
    if segs is not None:
        smask = (segs[:, :, None] == segs[:, None, :]) & (segs[:, None, :] > 0)
        mask = smask if mask is None else mask[None] & smask
    if mask is not None:
        s = s.masked_fill(~(mask if mask.dim() == 2 else mask[:, None]), -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqc,bchd->bqhd", p, v.to(torch.float32))
    return o.to(q.dtype)


def _rolling(cfg: AttnCfg, size: int) -> bool:
    """A window cache no longer than the window is a ring: position p lives
    at slot p % size."""
    return cfg.window is not None and size <= cfg.window


def decode_attention(q, k_cache, v_cache, pos, cfg: AttnCfg):
    """q [B, 1, H, dh]; caches [B, Smax, Kv, dh]; ``pos``: the new token's
    index, an int (the whole batch at one timestep) or an int tensor [B]
    (each row at its own). GQA by a grouped einsum on the unrepeated cache,
    float32 scores and softmax."""
    B, _, H, dh = q.shape
    Kv = k_cache.shape[2]
    qg = q.reshape(B, 1, Kv, H // Kv, dh).to(torch.float32)
    s = torch.einsum("bqkgh,bckh->bkgqc", qg, k_cache.to(torch.float32)) * dh ** -0.5
    idx = torch.arange(k_cache.shape[1], device=q.device)
    # [B, 1] per row, or an int that broadcasts over B
    posv = pos.to(q.device).reshape(-1, 1) if isinstance(pos, torch.Tensor) else int(pos)
    # a warm ring holds only valid entries; during warm-up only slots <= pos
    # have been written
    mask = idx[None, :] <= posv
    # init_kv_cache makes every window cache a ring; this branch serves a
    # longer window cache built by hand, as JAX's decode_attention does
    if cfg.window is not None and not _rolling(cfg, k_cache.shape[1]):
        mask &= idx[None, :] > posv - cfg.window
    s = s.masked_fill(~mask[:, None, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckh->bqkgh", p, v_cache.to(torch.float32))
    return o.reshape(B, 1, H, dh).to(q.dtype)


def init_kv_cache(batch: int, max_len: int, cfg: AttnCfg, dtype, device):
    size = min(max_len, cfg.window) if cfg.window is not None else max_len
    shape = (batch, size, cfg.n_kv, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_decode(cache, k, v, pos, cfg: AttnCfg):
    """Write the new token's k/v [B, 1, Kv, dh] at ``pos`` (mod the size for
    a ring), in place."""
    size = cache["k"].shape[1]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        at = pos.to(device=k.device, dtype=torch.long)
        rows = torch.arange(k.shape[0], device=k.device)
        if _rolling(cfg, size):
            at = at % size
        cache["k"][rows, at] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, at] = v[:, 0].to(cache["v"].dtype)
    else:
        at = int(pos) % size if _rolling(cfg, size) else int(pos)
        cache["k"][:, at] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, at] = v[:, 0].to(cache["v"].dtype)


def _fill_prefill(cache, k, v, cfg: AttnCfg, segs=None):
    """Fill the cache from the prompt's keys and values, in place.

    A full-length cache takes the row as it is: what lies past a prompt is
    hidden by decode's ``idx <= pos`` mask until decode overwrites it. A ring
    takes each row's last ``size`` valid tokens (``segs``, int [B, S], 0 =
    padding; without it every token is valid), token ``p`` (its index in the
    row) at slot ``p % size``, so the pads of a bucket or of a right-padded
    batch never overwrite a slot that decode reads (JAX writes the padded
    row's tail there)."""
    size = cache["k"].shape[1]
    if not _rolling(cfg, size):
        n = min(k.shape[1], size)
        cache["k"][:, :n] = k[:, -n:].to(cache["k"].dtype)
        cache["v"][:, :n] = v[:, -n:].to(cache["v"].dtype)
        return
    B, S = k.shape[:2]
    valid = (segs.to(k.device) > 0 if segs is not None
             else torch.ones((B, S), dtype=torch.bool, device=k.device))
    # the valid tokens at or after each index: keep the last `size`
    after = valid.flip(1).cumsum(1).flip(1)
    keep = valid & (after <= size)
    idx = torch.arange(S, device=k.device)
    # dropped tokens go to an extra slot past the ring, then cut off
    slot = torch.where(keep, idx % size, size)
    for name, x in (("k", k), ("v", v)):
        buf = torch.zeros((B, size + 1) + tuple(x.shape[2:]), dtype=cache[name].dtype,
                          device=x.device)
        buf.scatter_(1, slot[:, :, None, None].expand(x.shape), x.to(buf.dtype))
        cache[name].copy_(buf[:, :size])


def _mesh_heads(params, ctx: Ctx, cfg: AttnCfg, prefix: str, q, k, v, flat: bool = True):
    """q, k, v projections on a mesh, in one of three head layouts, as JAX
    pins each ``[B, S, heads, dh]`` tensor to its model chunk of heads
    where the heads divide the model axis (JAX's ``Ctx.constrain_heads``):

    * ``"local"``: all three ran column-parallel (``MODEL_SHARDED_OUT``) and
      the query and kv heads both divide the model axis: each holds this
      rank's heads;
    * ``"flat"`` (``flat``, a model axis of several ranks): q ran
      column-parallel and its heads divide the axis, the kv heads do not:
      q holds this rank's heads and k, v (all-gathered over model where
      their plans sharded them) every kv head; :func:`_flat_kv` gives this
      rank's queries their kv heads (JAX's flat-head layout, k/v repeated to
      the query heads);
    * ``"whole"``: every model-sharded one all-gathered over model, attention
      on all heads.

    Returns (q, k, v, layout)."""
    from repro_torch.launch.mesh import gather_replicated

    sharded = [ctx.plan_kind(f"{prefix}_{n}", params[n]) in MODEL_SHARDED_OUT
               for n in ("q", "k", "v")]
    if all(sharded) and ctx.heads_local(cfg.n_heads, cfg.n_kv):
        return q, k, v, "local"
    q_local = flat and sharded[0] and ctx.n_mp > 1 and cfg.n_heads % ctx.n_mp == 0
    out = [gather_replicated(t, ctx.model_axes, ctx.mesh, -1) if sh and not (i == 0 and q_local)
           else t for i, (t, sh) in enumerate(zip((q, k, v), sharded))]
    return out[0], out[1], out[2], "flat" if q_local else "whole"


def _flat_kv(k, v, cfg: AttnCfg, ctx: Ctx, n_local: int):
    """The kv heads of this rank's ``n_local`` query heads (the ``"flat"``
    layout of :func:`_mesh_heads`): k, v [B, S, n_kv, dh], whole and
    replicated over model, enter through ``launch.mesh.copy_to`` (the
    ranks' partial cotangents summed) and each query head takes its group's
    head: [B, S, n_local, dh]."""
    from repro_torch.launch.mesh import axis_index, copy_to

    first = axis_index(ctx.mesh, ctx.model_axes) * n_local
    idx = torch.div(torch.arange(first, first + n_local, device=k.device), cfg.groups,
                    rounding_mode="floor")
    return tuple(copy_to(t, ctx.model_axes, ctx.mesh).index_select(2, idx) for t in (k, v))


def _mesh_out_input(p, ctx: Ctx, role: str, h, local: bool):
    """The out-projection's input in the layout its plan reads: d_in's model
    chunk for a row-parallel plan (``MODEL_SHARDED_IN``), the whole otherwise
    (``local``: ``h`` holds this rank's chunk); ``h`` itself off a mesh."""
    from repro_torch.launch.mesh import gather_replicated, slice_replicated

    row = ctx.plan_kind(role, p) in MODEL_SHARDED_IN
    if row and not local:
        return slice_replicated(h, ctx.model_axes, ctx.mesh, -1)
    if local and not row:
        return gather_replicated(h, ctx.model_axes, ctx.mesh, -1)
    return h


# -- caches on a shard ----------------------------------------------------------
#
# Under a mesh the caches keep ``launch.sharding.cache_specs``' layout, read
# from the marks on their leaves: this rank's rows, and where the sequence is
# split over model, this rank's chunk of every row's positions for all kv
# heads. Off a mesh, or where one rank holds every position, the functions
# below are the single-device ones.


def _seq_split(cache_leaf, ctx: Ctx):
    """(model axes, ranks) the cache leaf's positions are split over: none
    off a mesh, on an unmarked leaf, or where the axes hold one rank (there
    the chunk is the whole, and decode is the single-device decode)."""
    from repro_torch.launch.sharding import dim_axes, spec_of

    spec = spec_of(cache_leaf) if ctx.mesh is not None else None
    axes = dim_axes(spec[1]) if spec is not None else ()
    n = ctx.mesh.axis_size(axes) if axes else 1
    return (axes, n) if n > 1 else ((), 1)


def _whole_heads(t, ctx: Ctx, local: bool):
    """[B, S, heads, dh] on all heads: this rank's heads all-gathered over
    model where ``local``."""
    from repro_torch.launch.mesh import all_gather

    return all_gather(t, ctx.model_axes, ctx.mesh, axis=2) if local else t


def _fill_shard(cache, k, v, cfg: AttnCfg, ctx: Ctx, local: bool, segs=None):
    """:func:`_fill_prefill` into this rank's shard: all kv heads (gathered
    over model where the projections left this rank's), and this rank's
    chunk of positions where the cache's sequence is split over model."""
    from repro_torch.launch.mesh import chunk_of

    k, v = _whole_heads(k, ctx, local), _whole_heads(v, ctx, local)
    axes, n = _seq_split(cache["k"], ctx)
    if n == 1:
        _fill_prefill(cache, k, v, cfg, segs)
        return
    size = cache["k"].shape[1] * n
    full = {name: cache[name].new_zeros((cache[name].shape[0], size) + cache[name].shape[2:])
            for name in ("k", "v")}
    _fill_prefill(full, k, v, cfg, segs)
    for name in ("k", "v"):
        cache[name].copy_(chunk_of(full[name], axes, ctx.mesh, 1))


def _write_shard(cache, k, v, pos, cfg: AttnCfg, ctx: Ctx):
    """:func:`_write_decode` into this rank's shard: the model rank whose
    chunk holds a row's slot ``pos`` (``pos % size`` for a ring) writes it,
    the others leave their chunk as it is."""
    from repro_torch.launch.mesh import axis_index

    axes, n = _seq_split(cache["k"], ctx)
    if n == 1:
        _write_decode(cache, k, v, pos, cfg)
        return
    c = cache["k"].shape[1]
    size = c * n
    B = k.shape[0]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        at = pos.to(device=k.device, dtype=torch.long)
    else:
        at = torch.full((B,), int(pos), dtype=torch.long, device=k.device)
    if _rolling(cfg, size):
        at = at % size
    at = at - axis_index(ctx.mesh, axes) * c
    mine = ((at >= 0) & (at < c))[:, None, None]
    # every row writes one slot of its chunk: its new token's where the slot
    # is this rank's, the value already there otherwise
    at = at.clamp(0, c - 1)
    rows = torch.arange(B, device=k.device)
    for name, x in (("k", k), ("v", v)):
        buf = cache[name]
        buf[rows, at] = torch.where(mine, x[:, 0].to(buf.dtype), buf[rows, at])


def _decode_shard(q, k_cache, v_cache, pos, cfg: AttnCfg, ctx: Ctx):
    """:func:`decode_attention` on this rank's shard of the caches (q on all
    heads). Where the positions are split over model, each rank forms the
    float32 softmax statistics of its chunk (the max, the sum of the
    exponentials, their weighted sum of values) and the chunks combine over
    model: the max by ``pmax``, the two sums rescaled to it by one ``psum``
    (flash-decoding). Otherwise the single-device decode."""
    from repro_torch.launch.mesh import axis_index, pmax, psum

    axes, n = _seq_split(k_cache, ctx)
    if n == 1:
        return decode_attention(q, k_cache, v_cache, pos, cfg)
    B, _, H, dh = q.shape
    c, Kv = k_cache.shape[1], k_cache.shape[2]
    G = H // Kv
    qg = q.reshape(B, 1, Kv, G, dh).to(torch.float32)
    s = torch.einsum("bqkgh,bckh->bkgqc", qg, k_cache.to(torch.float32)) * dh ** -0.5
    idx = axis_index(ctx.mesh, axes) * c + torch.arange(c, device=q.device)
    posv = pos.to(q.device).reshape(-1, 1) if isinstance(pos, torch.Tensor) else int(pos)
    mask = idx[None, :] <= posv
    if cfg.window is not None and not _rolling(cfg, c * n):
        mask &= idx[None, :] > posv - cfg.window
    s = s.masked_fill(~mask[:, None, None, None, :], -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    # a chunk with no valid position has m = -1e30; the combine scales it
    # by exp(-1e30 - max) = 0 (position 0 is valid on the first chunk)
    mg = pmax(m, axes, ctx.mesh)
    scale = torch.exp(m - mg)
    l = p.sum(-1, keepdim=True) * scale  # [B, Kv, G, 1, 1]
    acc = torch.einsum("bkgqc,bckh->bkgqh", p, v_cache.to(torch.float32)) * scale
    both = psum(torch.cat([acc, l], dim=-1), axes, ctx.mesh)
    o = both[..., :dh] / both[..., dh:]
    return o.permute(0, 3, 1, 2, 4).reshape(B, 1, H, dh).to(q.dtype)


def _decode(params, ctx: Ctx, cfg: AttnCfg, prefix: str, q, k, v, cache, pos, local):
    """A decode step's attention: q, k, v on all heads, the new token written
    by the rank that holds its slot, attention over the shard (combined over
    model where the positions are split), and the out-projection's input in
    the layout its plan reads."""
    B = q.shape[0]
    q, k, v = (_whole_heads(t, ctx, local) for t in (q, k, v))
    _write_shard(cache, k, v, pos, cfg, ctx)
    o = _decode_shard(q, cache["k"], cache["v"], pos, cfg, ctx).reshape(B, 1, -1)
    o = _mesh_out_input(params["o"], ctx, f"{prefix}_o", o, False)
    return dense(params["o"], o, ctx, f"{prefix}_o"), cache


def attention(params, x, ctx: Ctx, cfg: AttnCfg, positions, cache=None, pos=None,
              memory=None, role_prefix: str = "attn", segs=None):
    """Attention sublayer: sketched projections + core + sketched out-proj.

    * training: ``cache=None`` -> out;
    * prefill: a ``cache`` dict to fill (``init_kv_cache``) -> (out, cache);
    * decode: ``cache`` and ``pos`` (int, or int tensor [B]) -> (out, cache);
    * cross-attention: ``memory`` [B, S_mem, d], the encoder's output: k and
      v come from it, unrotated and never segment-masked (a prefill cache
      then takes all of the memory's keys and values);
    * packed prefill: ``segs`` (int [B, S], 0 = padding) segment-masks it.

    ``positions`` is [B, S], or [3, B, S] for ``rope="mrope"``. Under a mesh
    on this rank's rows, and on this rank's query heads where the plans and
    the heads allow (:func:`_mesh_heads`); the caches are this rank's shards of
    ``launch.sharding.cache_specs``' layout (prefill writes this rank's
    chunk, decode combines the chunks' softmax statistics over model).
    """
    B, S, _ = x.shape
    src = x if memory is None else memory
    Skv = src.shape[1]
    q = dense(params["q"], x, ctx, f"{role_prefix}_q")
    k = dense(params["k"], src, ctx, f"{role_prefix}_k")
    v = dense(params["v"], src, ctx, f"{role_prefix}_v")
    heads = "whole"
    if ctx.mesh is not None:
        # decode keeps q's heads with their kv heads (the caches hold every
        # kv head)
        q, k, v, heads = _mesh_heads(params, ctx, cfg, role_prefix, q, k, v, flat=pos is None)
    # under a mesh with local heads: this rank's model chunk of the heads
    q = q.reshape(B, S, -1, cfg.d_head)
    k = k.reshape(B, Skv, -1, cfg.d_head)
    v = v.reshape(B, Skv, -1, cfg.d_head)
    if cfg.rope in ("default", "mrope"):
        rotate = apply_rope if cfg.rope == "default" else apply_mrope
        q = rotate(q, positions, cfg.theta)
        if memory is None:
            k = rotate(k, positions, cfg.theta)
    elif cfg.rope != "none":
        raise ValueError(f"unknown rope {cfg.rope!r}")
    if cache is not None and pos is not None:
        return _decode(params, ctx, cfg, role_prefix, q, k, v, cache, pos, heads == "local")
    kh, vh = _flat_kv(k, v, cfg, ctx, q.shape[2]) if heads == "flat" else (k, v)
    o = multi_head_attention(q, kh, vh, cfg, segs=None if memory is not None else segs)
    o = o.reshape(B, S, -1)
    if ctx.mesh is not None:
        o = _mesh_out_input(params["o"], ctx, f"{role_prefix}_o", o, heads != "whole")
    out = dense(params["o"], o, ctx, f"{role_prefix}_o")
    if cache is not None:
        _fill_shard(cache, k, v, cfg, ctx, heads == "local",
                    None if memory is not None else segs)
        return out, cache
    return out
