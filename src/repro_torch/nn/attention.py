"""GQA attention: causal or bidirectional self-attention and cross-attention;
training, prefill and decode.

Port of ``repro/nn/attention.py``: sketched q/k/v/o projections, RoPE or
M-RoPE, and the attention core. ``impl="pallas"`` sends a call without
segment ids to the flash-attention kernel (``kernels/ops.py``), as JAX does;
every other call, and every call with segments, takes the plain float32
matmul and softmax (the JAX ``einsum`` impl; its ``chunked`` impl computes
the same function in another order). Decode attends one query per row
against the KV cache with a masked einsum on the unrepeated cache.

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

from repro_torch.kernels import ops
from repro_torch.nn.common import Ctx, dense, dense_init
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


def multi_head_attention(q, k, v, cfg: AttnCfg, *, segs=None):
    """q [B, Sq, H, dh], k/v [B, Skv, Kv, dh] -> [B, Sq, H, dh].

    ``impl="pallas"`` without ``segs`` launches the flash kernel. Otherwise:
    float32 scores and softmax, the causal mask right-aligned when Skv > Sq,
    and with ``segs`` (int [B, S], self-attention, 0 = padding) query i sees
    key j only if ``segs[b, i] == segs[b, j] > 0``."""
    if cfg.impl == "pallas" and segs is None:
        return ops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
    Sq, dh = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    if cfg.groups > 1:
        k = k.repeat_interleave(cfg.groups, dim=2)
        v = v.repeat_interleave(cfg.groups, dim=2)
    s = torch.einsum("bqhd,bchd->bhqc", q.to(torch.float32), k.to(torch.float32)) * dh ** -0.5
    mask = None
    if cfg.causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
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


# plans whose output is sharded over the model axis
_MODEL_SHARDED_OUT = ("tp_column", "tp_exact")


def _mesh_heads(params, ctx: Ctx, cfg: AttnCfg, prefix: str, q, k, v):
    """q, k, v projections on a mesh: kept on this rank's heads when all
    three ran column-parallel (``tp_column``, ``tp_exact``) and the query and kv heads
    both divide the model axis; otherwise each model-sharded one is
    all-gathered over model, and attention runs on all heads. Returns (q, k,
    v, local)."""
    from repro_torch.launch.mesh import gather_replicated

    sharded = [ctx.plan_kind(f"{prefix}_{n}", params[n]) in _MODEL_SHARDED_OUT
               for n in ("q", "k", "v")]
    if all(sharded) and ctx.heads_local(cfg.n_heads, cfg.n_kv):
        return q, k, v, True
    out = [gather_replicated(t, ctx.model_axes, ctx.mesh, -1) if sh else t
           for t, sh in zip((q, k, v), sharded)]
    return out[0], out[1], out[2], False


def _mesh_out_input(p, ctx: Ctx, role: str, h, local: bool):
    """The out-projection's input in the layout its plan reads: d_in's model
    chunk for ``tp_row``, the whole otherwise (``local``: ``h`` holds this
    rank's chunk); ``h`` itself off a mesh."""
    from repro_torch.launch.mesh import gather_replicated, slice_replicated

    row = ctx.plan_kind(role, p) == "tp_row"
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
    on this rank's rows, and on this rank's heads where the plans allow
    (:func:`_mesh_heads`); the caches are this rank's shards of
    ``launch.sharding.cache_specs``' layout (prefill writes this rank's
    chunk, decode combines the chunks' softmax statistics over model).
    """
    B, S, _ = x.shape
    src = x if memory is None else memory
    Skv = src.shape[1]
    q = dense(params["q"], x, ctx, f"{role_prefix}_q")
    k = dense(params["k"], src, ctx, f"{role_prefix}_k")
    v = dense(params["v"], src, ctx, f"{role_prefix}_v")
    local = False
    if ctx.mesh is not None:
        q, k, v, local = _mesh_heads(params, ctx, cfg, role_prefix, q, k, v)
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
        return _decode(params, ctx, cfg, role_prefix, q, k, v, cache, pos, local)
    o = multi_head_attention(q, k, v, cfg, segs=None if memory is not None else segs)
    o = o.reshape(B, S, -1)
    if ctx.mesh is not None:
        o = _mesh_out_input(params["o"], ctx, f"{role_prefix}_o", o, local)
    out = dense(params["o"], o, ctx, f"{role_prefix}_o")
    if cache is not None:
        _fill_shard(cache, k, v, cfg, ctx, local, None if memory is not None else segs)
        return out, cache
    return out
