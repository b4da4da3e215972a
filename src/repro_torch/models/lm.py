"""The LM stack (port of ``repro/models/lm.py``): the dense decoder, gemma3's
local/global interleave, the MoE family, the SSM (rwkv) and hybrid (zamba:
Mamba2 layers with one shared attention block) families, the VLM (M-RoPE
over a stub vision frontend) and the encoder-decoder audio family (a stub
speech frontend); the training forward, prefill and decode.
``init_params`` and ``lm_loss`` also dispatch the §5 MLP
(``family="mlp"``), as in JAX.

The JAX model compiles an architecture into segments of stacked, identical
periods (:func:`plan_segments`: gemma3's 5 local + 1 global layers are one
period, zamba's 6 Mamba layers + the shared block another) and scans them.
The port keeps one parameter dict per layer in ``params["layers"]`` and runs
a Python loop over :func:`layer_kinds`, the plan flattened in uid order:
layer ``i`` has uid ``i``, the uid JAX's segment runner gives it
(``_layer_uid``), so per-site seeds follow the same step → layer → role
structure. Each layer reads its :class:`LayerKind`: a window and a RoPE theta
of its own (gemma3's local and global layers), ``{"moe": ...}`` in place of
``{"mlp": ...}`` for an MoE layer, ``{"mamba": ...}`` or ``{"rwkv": ...}``
for a recurrent one. A ``shared_attn`` layer's dict is empty: every one of
them applies ``params["shared"]`` (JAX's ``params["shared"]``; its
``segments`` hold ``None`` there) under its own uid, so each application
draws its own seeds. The decode caches follow the same layout: a list with
one dict per layer, ``{"k", "v"}`` for attention (a ring of the window's
size for a windowed layer), the recurrent state for a Mamba (``{"ssm",
"conv"}``) or RWKV (``{"wkv", "shift_tm", "shift_cm"}``) layer, where JAX
stacks each segment's on a leading axis (``interop.caches_from_jax``
converts).

The stub frontends feed float ``embeds`` [B, S, d] in place of ``tokens``
(the VLM's patch and text embeddings) or ``src_embeds`` [B, S_enc, d] to
the encoder (the audio frames); neither frontend itself is modelled, as in
JAX. M-RoPE's ``positions`` are [3, B, S] (t, h, w); without them every
stream is the token index. An encoder-decoder config keeps its encoder in
``params["encoder"] = {"layers": [...], "final_norm": ...}``: bidirectional
attention layers under uids ``ENCODER_UID_BASE + i`` (JAX's ``seg_base``),
JAX's ``encoder/segments/0/0`` stacked. Each decoder layer then has a
``cross`` attention sub-block over the encoder's output after its
self-attention (``norm_c`` before it). Its cache dict gains ``"cross":
{"k", "v"}``, the memory's keys and values [B, S_enc, n_kv, d_head],
written by prefill and read whole by every decode step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import rng
from repro_torch.configs.base import ArchConfig
from repro_torch.core import linear
from repro_torch.device import resolve_device
from repro_torch.nn import ssm
from repro_torch.nn.attention import (_MODEL_SHARDED_OUT, AttnCfg, attention, attn_init,
                                      init_kv_cache)
from repro_torch.nn.common import Ctx, dense, dense_init, rmsnorm, rmsnorm_init, trunc_normal
from repro_torch.nn.mlp import mlp, mlp_init
from repro_torch.nn.moe import MoECfg, moe_ffn, moe_init
from repro_torch.tree import tree_leaves

__all__ = ["LayerKind", "plan_segments", "layer_kinds", "jax_layer_paths", "init_params",
           "forward", "forward_with_aux", "lm_loss", "num_params", "active_params_per_token",
           "check_supported", "attn_cfg", "cross_cfg", "check_decoder", "check_recurrent_segments",
           "init_cache", "layer_cache",
           "prefill", "decode_step", "encode", "encoder_kinds", "ENCODER_UID_BASE",
           "param_shapes"]

# the encoder's layer uids start here (JAX's seg_base), so its sites never
# share a seed with the decoder's
ENCODER_UID_BASE = 10_000


@dataclasses.dataclass(frozen=True)
class LayerKind:
    kind: str  # attn | mamba | rwkv | shared_attn
    window: Optional[int] = None
    moe: bool = False
    cross: bool = False  # decoder cross-attention after self-attention
    causal: bool = True
    theta: Optional[float] = None  # rope theta override (gemma3 global layers)


def plan_segments(cfg: ArchConfig, *, encoder: bool = False):
    """Return [(period: tuple[LayerKind, ...], n_rep: int), ...]."""
    L = cfg.enc_layers if encoder else cfg.n_layers
    if encoder:
        return [((LayerKind("attn", causal=False),), L)]
    if cfg.block_kind == "rwkv":
        return [((LayerKind("rwkv"),), L)]
    if cfg.block_kind == "zamba":
        k = cfg.shared_attn_every
        period = tuple([LayerKind("mamba")] * k + [LayerKind("shared_attn")])
        n_full = L // k
        rem = L - n_full * k
        segs = [(period, n_full)] if n_full else []
        if rem:
            segs.append(((LayerKind("mamba"),), rem))
        return segs
    if cfg.local_global > 0:
        k = cfg.local_global
        local = LayerKind("attn", window=cfg.window)
        glob = LayerKind("attn", theta=cfg.rope_theta_global)
        period = tuple([local] * k + [glob])
        n_full = L // (k + 1)
        rem = L - n_full * (k + 1)
        segs = [(period, n_full)] if n_full else []
        if rem:
            segs.append(((local,), rem))
        return segs
    base = LayerKind("attn", window=cfg.window, moe=cfg.n_experts > 0,
                     cross=cfg.is_encdec)
    return [((base,), L)]


def _layer_uid(seg_base: int, rep, period_len: int, sub_i: int):
    return seg_base + rep * period_len + sub_i


def _walk_plan(cfg: ArchConfig, encoder: bool = False):
    """(uid, segment, sub-block, kind) of every layer, in uid order (the
    encoder's uids counted from 0)."""
    base = 0
    for si, (period, n_rep) in enumerate(plan_segments(cfg, encoder=encoder)):
        for rep in range(n_rep):
            for i, kind in enumerate(period):
                yield _layer_uid(base, rep, len(period), i), si, i, kind
        base += n_rep * len(period)


def layer_kinds(cfg: ArchConfig) -> list:
    """One :class:`LayerKind` per layer, in uid order: the plan of
    :func:`plan_segments` flattened (layer ``i`` has uid ``i``)."""
    return [kind for _, _, _, kind in _walk_plan(cfg)]


def encoder_kinds(cfg: ArchConfig) -> list:
    """The encoder's :class:`LayerKind` per layer (bidirectional attention);
    empty for a decoder-only config."""
    return [kind for _, _, _, kind in _walk_plan(cfg, encoder=True)]


def jax_layer_paths(cfg: ArchConfig, encoder: bool = False) -> list:
    """The JAX tree path (``segments/<segment>/<sub-block>``) of each layer's
    stacked parameters, in uid order; ``shared`` for a ``shared_attn`` layer,
    whose weights JAX keeps once in ``params["shared"]``. With ``encoder``,
    the encoder's layers (``encoder/segments/0/0``)."""
    head = "encoder/" if encoder else ""
    return ["shared" if kind.kind == "shared_attn" else f"{head}segments/{si}/{i}"
            for _, si, i, kind in _walk_plan(cfg, encoder)]


def attn_cfg(cfg: ArchConfig, kind: LayerKind) -> AttnCfg:
    """The attention config of a layer of kind ``kind`` (JAX's ``_attn_cfg``),
    and its cache's geometry (``nn.attention.init_kv_cache``)."""
    return AttnCfg(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.head_dim,
                   causal=kind.causal, window=kind.window, rope=cfg.rope,
                   theta=kind.theta or cfg.rope_theta, impl=cfg.attn_impl)


def cross_cfg(cfg: ArchConfig) -> AttnCfg:
    """The decoder's cross-attention config (JAX's ``_cross_cfg``):
    bidirectional, no rotation."""
    return AttnCfg(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.head_dim, causal=False,
                   rope="none", impl=cfg.attn_impl, cross=True)


def _moe_cfg(cfg: ArchConfig) -> MoECfg:
    return MoECfg(cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.capacity_factor, cfg.mlp_type)


def _mamba_cfg(cfg: ArchConfig) -> ssm.MambaCfg:
    return ssm.MambaCfg(d_model=cfg.d_model, d_state=cfg.ssm_state,
                        head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk)


def _rwkv_cfg(cfg: ArchConfig) -> ssm.RWKVCfg:
    return ssm.RWKVCfg(d_model=cfg.d_model, head_dim=cfg.ssm_head_dim, d_ff=cfg.d_ff,
                       chunk=cfg.ssm_chunk)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for configurations outside the ported families: the decoders of
    :func:`check_decoder` and the §5 MLP (``family="mlp"``,
    :func:`models.mlp.mlp_arch`)."""
    if cfg.family != "mlp":
        check_decoder(cfg)


def check_decoder(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError``, naming the architecture, for a config
    outside the ported LM families: the dense decoder family, gemma3's
    local/global interleave, the MoE family, the SSM (rwkv) and hybrid
    (zamba) families, the VLM (M-RoPE, the vision stub) and the
    encoder-decoder audio family (the audio stub)."""
    what = None
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
        what = f"the {cfg.family} family"
    elif cfg.block_kind not in ("attn", "rwkv", "zamba"):
        what = f"block kind {cfg.block_kind!r}"
    elif cfg.is_encdec and cfg.block_kind != "attn":
        what = f"an encoder-decoder stack of block kind {cfg.block_kind!r}"
    elif cfg.rope not in ("default", "none", "mrope"):
        what = f"rope {cfg.rope!r}"
    elif cfg.frontend not in (None, "vision", "audio"):
        what = f"the {cfg.frontend} frontend"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported to repro_torch yet (ported: the dense decoder "
            "family, gemma3's local/global interleave, the MoE family, the SSM and hybrid "
            "families, the VLM and the encoder-decoder audio family)")


def _init_layer(gen, kind: LayerKind, cfg: ArchConfig, dtype, dev):
    d = cfg.d_model
    if kind.kind == "shared_attn":
        return {}  # the parameters live in params["shared"]
    p = {"norm1": rmsnorm_init(d, dtype, dev)}
    if kind.kind == "mamba":
        p["mamba"] = ssm.mamba_init(gen, _mamba_cfg(cfg), dtype, dev)
        return p
    if kind.kind == "rwkv":
        p["rwkv"] = ssm.rwkv_init(gen, _rwkv_cfg(cfg), dtype, dev)
        p["norm2"] = rmsnorm_init(d, dtype, dev)
        return p
    p["attn"] = attn_init(gen, d, attn_cfg(cfg, kind), dtype, dev)
    p["norm2"] = rmsnorm_init(d, dtype, dev)
    if kind.moe:
        p["moe"] = moe_init(gen, d, _moe_cfg(cfg), dtype, dev)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_type, dtype, dev)
    if kind.cross:
        p["cross"] = attn_init(gen, d, cross_cfg(cfg), dtype, dev)
        p["norm_c"] = rmsnorm_init(d, dtype, dev)
    return p


def init_params(seed: int, cfg: ArchConfig, *, device="cuda"):
    """Random parameters from ``seed``, on ``device`` (default the card);
    an ``mlp_arch`` config gives the §5 MLP's list of layers."""
    check_supported(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    if cfg.family == "mlp":
        from repro_torch.models import mlp as mlpmod

        return mlpmod.mlp_init(seed, mlpmod.mlp_sizes(cfg), dtype, device=device)
    meta = str(device) == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    gen = None if meta else rng.generator(seed, dev)
    d = cfg.d_model
    kinds = layer_kinds(cfg)
    params = {
        "embed": trunc_normal(gen, (cfg.vocab, d), d ** -0.5, dtype, dev),
        "final_norm": rmsnorm_init(d, dtype, dev),
        "layers": [_init_layer(gen, kind, cfg, dtype, dev) for kind in kinds],
    }
    if any(kind.kind == "shared_attn" for kind in kinds):
        params["shared"] = _init_layer(gen, LayerKind("attn"), cfg, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.vocab, dtype, device=dev, scale=d ** -0.5)
    if cfg.is_encdec:
        params["encoder"] = {
            "layers": [_init_layer(gen, kind, cfg, dtype, dev) for kind in encoder_kinds(cfg)],
            "final_norm": rmsnorm_init(d, dtype, dev)}
    return params


def param_shapes(cfg: ArchConfig):
    """The parameter tree of ``cfg`` as ``meta`` tensors: shapes and dtypes,
    no storage (what the sharding rules read for a config of any size)."""
    return init_params(0, cfg, device="meta")


def _default_positions(cfg: ArchConfig, B: int, S: int, device, offset=0):
    """[B, S] positions from ``offset``: an int, or an int tensor [B] of
    per-row start positions (decode); [3, B, S], the three streams equal,
    for M-RoPE."""
    pos = torch.arange(S, device=device)[None, :]
    if isinstance(offset, torch.Tensor):
        pos = offset.to(device=device, dtype=torch.long).reshape(-1, 1) + pos
    else:
        pos = pos + int(offset)
    pos = pos.expand(B, S)
    return pos.expand(3, B, S) if cfg.rope == "mrope" else pos


def _embed(params, tokens_or_embeds, cfg: ArchConfig):
    """Token ids [B, S] through the embedding table, or float embeddings
    [B, S, d] (a stub frontend's) cast to the parameter type; then the
    compute type, and gemma's sqrt(d) scale for either."""
    if tokens_or_embeds.is_floating_point():
        x = tokens_or_embeds.to(getattr(torch, cfg.param_dtype))
    else:
        x = params["embed"][tokens_or_embeds]
    x = x.to(getattr(torch, cfg.dtype))
    if cfg.embed_scale:
        x = x * cfg.d_model ** 0.5
    return x


def _mesh_embed(params, inp, ctx: Ctx, cfg: ArchConfig):
    """The embedding on a mesh: the table's d is sharded over model, so this
    rank looks up its chunk of d and the rows are all-gathered over model
    (the residual stream is replicated over model). A stub frontend's float
    embeddings arrive whole. The table's gradient (the lookup's, plus a tied
    head's) is this rank's partial sum over data; the train step sums it."""
    from repro_torch.launch.mesh import gather_replicated
    from repro_torch.launch.sharding import dim_axes, spec_of

    x = _embed(params, inp, cfg)
    spec = spec_of(params["embed"])
    if not inp.is_floating_point() and spec is not None and dim_axes(spec[1]):
        x = gather_replicated(x, dim_axes(spec[1]), ctx.mesh, -1)
    return x


def _inputs(batch):
    """The batch's ``tokens``, else its ``embeds`` (JAX's lookup order)."""
    return batch["tokens"] if "tokens" in batch else batch["embeds"]


def _head(params, x, ctx: Ctx, cfg: ArchConfig):
    x = rmsnorm(params["final_norm"], x)
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]["w"]
    hcfg = ctx.cfg_for("lm_head")
    if ctx.mesh is not None:
        return _mesh_head(w, x, ctx, hcfg, cfg.tie_embeddings)
    key = ctx.site_key("lm_head", x.device) if hcfg is not None else None
    return linear(x, w, key=key, cfg=hcfg)


def _mesh_head(w, x, ctx: Ctx, hcfg, tied: bool):
    """The head on a mesh: under ``tp_sketch`` an exact untied head whose
    vocabulary divides the model axis runs the Megatron column-parallel
    ``tp_exact`` plan (JAX's ``tp_exact_linear``, ``models/lm.py:403-414``),
    and its vocab-sharded logits are all-gathered over model for the loss
    (the numbers of a vocab-parallel softmax); otherwise the local plan on
    the gathered weight. A tied head (the embedding table: JAX's local plan
    on it) gathers the table over model only: its gradient stays this
    rank's partial sum over data, which the train step sums once with the
    lookup's."""
    from repro_torch.core import site
    from repro_torch.core.sharded_sketch import tp_exact_linear
    from repro_torch.launch.mesh import gather_replicated
    from repro_torch.launch.sharding import global_shape
    from repro_torch.nn.common import _mesh_dense

    if tied:
        seed = ctx.site_seed("lm_head") if hcfg is not None else None
        args = (ctx.mesh, ctx.data_axes, ctx.model_axes)
        if hcfg is None or hcfg.is_noop or seed is None:
            return site.mesh_site(None, x, w, None, None, *args, reduce_grad=False)
        spec = ctx.site_spec("lm_head", hcfg, w)
        return site.mesh_site(spec.cfg, x, w, None, rng.generator(seed, x.device), *args,
                              reduce_grad=False)
    if ctx.tp_sketch and hcfg is None and global_shape(w, ctx.mesh)[0] % ctx.n_mp == 0:
        return gather_replicated(tp_exact_linear(x, w, ctx), ctx.model_axes, ctx.mesh, -1)
    return _mesh_dense({"w": w}, x, ctx, "lm_head", hcfg)


def _cross(p, h, ctx: Ctx, cfg: ArchConfig, memory, cache, pos):
    """The decoder's cross-attention sub-block's output from its normed
    input ``h``. Training and prefill project the memory (prefill writes
    its keys and values into ``cache["cross"]``); decode attends to the
    whole of that cache."""
    ccfg = cross_cfg(cfg)
    if cache is not None and pos is not None:
        from repro_torch.launch.mesh import all_gather
        from repro_torch.nn import attention as attn

        B, S, _ = h.shape
        q = dense(p["cross"]["q"], h, ctx, "cross_q")
        # q on all heads; the memory's last position, the global one
        if ctx.plan_kind("cross_q", p["cross"]["q"]) in attn._MODEL_SHARDED_OUT:
            q = all_gather(q, ctx.model_axes, ctx.mesh, axis=-1)
        q = q.reshape(B, S, ccfg.n_heads, ccfg.d_head)
        kc, vc = cache["cross"]["k"], cache["cross"]["v"]
        n_mem = kc.shape[1] * attn._seq_split(kc, ctx)[1]
        o = attn._decode_shard(q, kc, vc, n_mem - 1, ccfg, ctx).reshape(B, S, -1)
        o = attn._mesh_out_input(p["cross"]["o"], ctx, "cross_o", o, False)
        return dense(p["cross"]["o"], o, ctx, "cross_o")
    o = attention(p["cross"], h, ctx, ccfg, None, memory=memory, role_prefix="cross",
                  cache=None if cache is None else cache["cross"])
    return o if cache is None else o[0]


def _norm(p, x, ctx: Ctx):
    """``rmsnorm`` of the residual stream; under the sequence-parallel
    layout on this rank's chunk of the sequence, so its gain's gradient is
    this rank's share and the gain enters through ``launch.mesh.copy_to``
    (backward: the all-reduce over model that completes it)."""
    if ctx.seq_parallel:
        from repro_torch.launch.mesh import copy_to

        p = dict(p, g=copy_to(p["g"], ctx.model_axes, ctx.mesh))
    return rmsnorm(p, x)


def _sp_block(ctx: Ctx, h, fn, ins=(), out=None, partial_out=None):
    """One block under the sequence-parallel layout (``ctx.seq_parallel``):
    ``h``, this rank's chunk of the sequence, gathered whole over model at
    the entry and the block's output ``fn(h, ctx)`` reduce-scattered (or
    sliced) back to the chunk at the exit. ``ins``: the (role, site params)
    that read ``h``; where every one runs a column plan their dX are left
    partial and the entry's backward reduce-scatters them
    (``launch.mesh.gather_partial``), else the entry's backward slices a
    whole cotangent (``gather_replicated``). ``out``: the (role, site
    params) whose output is the block's; a row plan leaves it partial for
    the exit's reduce-scatter (``scatter_partial``), else the exit slices
    it (``slice_replicated``). ``partial_out`` overrides that test (the MoE
    layer, whose experts' sum is partial). Off the layout: ``fn(h, ctx)``."""
    if not ctx.seq_parallel:
        return fn(h, ctx)
    from repro_torch.launch import mesh as m

    mp, mesh = ctx.model_axes, ctx.mesh
    p_in = bool(ins) and all(ctx.plan_kind(r, sp) in _MODEL_SHARDED_OUT for r, sp in ins)
    p_out = (partial_out if partial_out is not None
             else out is not None and ctx.plan_kind(*out) == "tp_row")
    roles = ({r for r, _ in ins} if p_in else set()) | ({out[0]} if p_out and out else set())
    if p_out and partial_out:
        roles.add("moe")
    bctx = dataclasses.replace(ctx, sp_partial=frozenset(roles))
    h = m.gather_partial(h, mp, mesh, 1) if p_in else m.gather_replicated(h, mp, mesh, 1)
    o = fn(h, bctx)

    def exit_(t):
        return m.scatter_partial(t, mp, mesh, 1) if p_out else m.slice_replicated(t, mp, mesh, 1)

    # a block that also returns a state, an aux loss or its cache: (out, extra)
    return (exit_(o[0]), o[1]) if isinstance(o, tuple) else exit_(o)


def _attn_layer(p, kind: LayerKind, x, ctx: Ctx, cfg: ArchConfig, positions, cache, pos,
                segs, memory=None):
    """A pre-norm attention layer (a decoder's cross-attention and then its
    MLP or MoE after it): (x, aux or None). Under the sequence-parallel
    layout ``x`` is this rank's chunk of the sequence and each sub-block
    runs through :func:`_sp_block`."""
    a_ = p["attn"]
    o = _sp_block(ctx, _norm(p["norm1"], x, ctx),
                  lambda h, c: attention(a_, h, c, attn_cfg(cfg, kind), positions, cache=cache,
                                         pos=pos, segs=segs),
                  ins=[(f"attn_{n}", a_[n]) for n in ("q", "k", "v")], out=("attn_o", a_["o"]))
    x = x + (o if cache is None else o[0])  # with a cache: (out, cache)
    if kind.cross:
        c_ = p["cross"]
        x = x + _sp_block(ctx, _norm(p["norm_c"], x, ctx),
                          lambda h, c: _cross(p, h, c, cfg, memory, cache, pos),
                          ins=[("cross_q", c_["q"])], out=("cross_o", c_["o"]))
    h2 = _norm(p["norm2"], x, ctx)
    if kind.moe:
        o, a = _sp_block(ctx, h2, lambda h, c: moe_ffn(p["moe"], h, c, _moe_cfg(cfg)),
                         partial_out=True)
        return x + o, a
    m_ = p["mlp"]
    ins = [(f"mlp_{n}", m_[n]) for n in ("in", "gate") if n in m_]
    return x + _sp_block(ctx, h2, lambda h, c: mlp(m_, h, c, cfg.mlp_type), ins=ins,
                         out=("mlp_out", m_["out"])), None


def _write_state(cache, state: dict) -> None:
    """Write a recurrent layer's new state into its cache, in place."""
    for k, v in state.items():
        cache[k].copy_(v)


def _mamba_layer(p, x, ctx: Ctx, cfg: ArchConfig, cache, pos):
    mcfg = _mamba_cfg(cfg)
    h = _norm(p["norm1"], x, ctx)
    if cache is None:
        return x + _sp_block(ctx, h, lambda t, c: ssm.mamba_block(p["mamba"], t, c, mcfg),
                             out=("ssm_out", p["mamba"]["out"]))
    if pos is None:
        # the cached state holds every head (cache_specs: batch over data only)
        o, state = _sp_block(ctx, h, lambda t, c: ssm.mamba_prefill(p["mamba"], t, c, mcfg,
                                                                    whole_heads=True),
                             out=("ssm_out", p["mamba"]["out"]))
    else:
        o, state = ssm.mamba_decode(p["mamba"], h, ctx, mcfg, cache)
    _write_state(cache, state)
    return x + o


def _rwkv_layer(p, x, ctx: Ctx, cfg: ArchConfig, cache):
    rcfg = _rwkv_cfg(cfg)
    tm = None if cache is None else {"wkv": cache["wkv"], "shift": cache["shift_tm"]}
    o, new_tm = _sp_block(ctx, _norm(p["norm1"], x, ctx),
                          lambda h, c: ssm.rwkv_time_mix(p["rwkv"], h, c, rcfg, tm),
                          out=("attn_o", p["rwkv"]["out"]))
    x = x + o
    o, new_cm = _sp_block(ctx, _norm(p["norm2"], x, ctx),
                          lambda h, c: ssm.rwkv_channel_mix(
                              p["rwkv"], h, c, rcfg, None if cache is None else cache["shift_cm"]))
    if cache is not None:
        _write_state(cache, {"wkv": new_tm["wkv"], "shift_tm": new_tm["shift"],
                             "shift_cm": new_cm})
    return x + o


def check_recurrent_segments(cfg: ArchConfig, segs) -> None:
    """Raise unless ``segs`` (int [B, S], a tensor or array; None passes)
    makes each row one segment without padding, where ``cfg`` has a
    recurrent layer: its state runs along the whole row (an exact-length
    engine wave is such a row). JAX's recurrent layers ignore segments: a
    packed row would leak state between its prompts, and pads would enter
    the state. A device tensor costs a device-to-host sync, so the prefill
    and train steps check their host batches before the copy, and
    :func:`forward` and :func:`prefill` check only segments on the CPU."""
    if segs is None or not any(k.kind in ("mamba", "rwkv") for k in layer_kinds(cfg)):
        return
    s = torch.as_tensor(segs)
    if not bool(((s > 0) & (s == s[:, :1])).all()):
        raise ValueError(f"{cfg.name}: a recurrent layer carries state along the row; its "
                         "segment ids must make each row one segment without padding, not "
                         "packed or padded prompts")


def _run_layers(params, x, ctx: Ctx, cfg: ArchConfig, step_key, positions, caches=None,
                pos=None, segs=None, memory=None, encoder=False):
    """Run every layer; returns (x, aux): the MoE layers' aux losses summed
    (float32 zero without MoE layers). With ``caches``, a prefill
    (``pos=None``) or decode step writes each layer's new keys and values or
    recurrent state into its cache. ``memory``: the encoder's output, for
    the decoder's cross-attention; ``encoder``: run the encoder's layers
    (``params["encoder"]``) under their uids."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kinds = encoder_kinds(cfg) if encoder else layer_kinds(cfg)
    if segs is not None and segs.device.type == "cpu" and not encoder:
        check_recurrent_segments(cfg, segs)
    stack = params["encoder"]["layers"] if encoder else params["layers"]
    base = ENCODER_UID_BASE if encoder else 0
    remat = _remat_fn(cfg) if caches is None and torch.is_grad_enabled() else None
    for i, (kind, p) in enumerate(zip(kinds, stack)):
        lctx = ctx.for_layer(step_key, base + i)
        cache = caches[i] if caches is not None else None
        if kind.kind == "shared_attn":
            p = params["shared"]

        def body(x, p=p, kind=kind, lctx=lctx, cache=cache):
            return _layer(p, kind, x, lctx, cfg, positions, cache, pos, segs, memory)

        if remat is None:
            x, a = body(x)
        else:
            x, a = remat(body, x)
        if a is not None:
            aux = aux + a
    return x, aux


def _layer(p, kind: LayerKind, x, ctx: Ctx, cfg: ArchConfig, positions, cache, pos, segs,
           memory):
    """One layer of any kind: (x, aux or None)."""
    if kind.kind in ("attn", "shared_attn"):
        return _attn_layer(p, kind, x, ctx, cfg, positions, cache, pos, segs, memory)
    if kind.kind == "mamba":
        return _mamba_layer(p, x, ctx, cfg, cache, pos), None
    return _rwkv_layer(p, x, ctx, cfg, cache), None


# the outputs the "dots" policy keeps (JAX's dots_with_no_batch_dims_saveable
# keeps the matmuls; the port keeps the batched ones too)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_fn(cfg: ArchConfig):
    """``cfg.remat`` as a wrapper of one layer body under differentiation
    (JAX's ``jax.checkpoint`` of the scanned body, ``models/lm.py``; serving
    steps, which carry caches, skip it as JAX's do): ``"full"`` keeps each
    layer's input and recomputes the layer in the backward, ``"dots"`` keeps
    its matmul outputs too, ``"none"`` keeps everything (None).

    The recompute runs the layer's forward again with the same inputs:
    every site draws its randomness from its own seeded generator in the
    backward alone, so the global RNG state is not saved; the backward runs
    once, on the recomputed graph, so each site's backward (its kernels,
    its compact-gradient slot, its probe, its plan carry) runs once. What
    runs twice is the forward's side: the sites' generators are built again
    from the same seeds, and under a mesh the forward's collectives run
    again (their payload counts twice, as a rematerialised all-gather does
    in JAX)."""
    if cfg.remat == "none":
        return None
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}: full | dots | none")
    import functools

    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, **kw)


def _sp_ctx(ctx: Ctx, S: int) -> Ctx:
    """``ctx`` with the sequence-parallel layout on for a sequence of ``S``
    positions where the runtime asks for it and ``S`` divides the model
    axis (else the fixed layout for this call, as JAX's ``_act_sharding``
    leaves a sequence that does not divide unsharded)."""
    if not ctx.seq_parallel:
        return ctx
    on = ctx.mesh is not None and bool(ctx.model_axes) and S % ctx.n_mp == 0
    return ctx if on else dataclasses.replace(ctx, seq_parallel=False)


def _sp_split(x, ctx: Ctx):
    """The residual stream entering the sequence-parallel layout: this
    rank's chunk of the sequence (backward: the chunks' cotangents
    all-gathered)."""
    if not ctx.seq_parallel:
        return x
    from repro_torch.launch.mesh import slice_replicated

    return slice_replicated(x, ctx.model_axes, ctx.mesh, 1)


def _sp_join(x, ctx: Ctx):
    """The residual stream leaving the sequence-parallel layout: the whole
    sequence on every model rank (backward: this rank's chunk)."""
    if not ctx.seq_parallel:
        return x
    from repro_torch.launch.mesh import gather_replicated

    return gather_replicated(x, ctx.model_axes, ctx.mesh, 1)


def encode(params, src_embeds, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """The encoder stack of an encoder-decoder config: ``src_embeds`` [B,
    S_enc, d] (the stub frontend's frames) in the compute type, the
    bidirectional layers, the encoder's final norm. Under the
    sequence-parallel layout the layers run on this rank's chunk of the
    frames and the memory leaves whole."""
    B, S, _ = src_embeds.shape
    ctx = _sp_ctx(ctx, S)
    x = _sp_split(src_embeds.to(getattr(torch, cfg.dtype)), ctx)
    x, _ = _run_layers(params, x, ctx, cfg, step_key,
                       _default_positions(cfg, B, S, src_embeds.device), encoder=True)
    return _sp_join(_norm(params["encoder"]["final_norm"], x, ctx), ctx)


def _prologue(params, batch, ctx: Ctx, cfg: ArchConfig, step_key):
    """(embedded inputs, positions, encoder memory or None, ctx) of a
    forward or prefill batch; under the sequence-parallel layout the
    embedded inputs are this rank's chunk of the sequence."""
    check_decoder(cfg)
    inp = _inputs(batch)
    B, S = inp.shape[0], inp.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, B, S, inp.device)
    # under a mesh every entry holds this rank's rows (M-RoPE's positions on
    # axis 1): the encoder runs on this rank's source rows
    memory = (encode(params, batch["src_embeds"], ctx, cfg, step_key) if cfg.is_encdec
              else None)
    x = _embed(params, inp, cfg) if ctx.mesh is None else _mesh_embed(params, inp, ctx, cfg)
    ctx = _sp_ctx(ctx, S)
    return _sp_split(x, ctx), positions, memory, ctx


def forward_with_aux(params, batch, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """Training forward: (logits, aux), JAX's ``lm.forward``.
    ``batch["tokens"]``: int [B, S] on the params' device, or ``"embeds"``:
    float [B, S, d] (the VLM's stub frontend); optional ``"positions"`` [B,
    S] ([3, B, S] for M-RoPE), ``"src_embeds"`` [B, S_enc, d] (required by
    an encoder-decoder) and ``"segments"`` (int [B, S], 0 = padding:
    self-attention stays within a segment). ``step_key``: the step's integer
    seed (None = no sketching). ``aux``: the MoE layers' summed
    load-balance loss (float32 zero without them)."""
    x, positions, memory, ctx = _prologue(params, batch, ctx, cfg, step_key)
    x, aux = _run_layers(params, x, ctx, cfg, step_key, positions,
                         segs=batch.get("segments"), memory=memory)
    return _head(params, _sp_join(x, ctx), ctx, cfg), aux


def forward(params, batch, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """The logits of :func:`forward_with_aux`."""
    return forward_with_aux(params, batch, ctx, cfg, step_key)[0]


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, enc_len: int = 0,
               device="cuda", mesh=None):
    """Zero decode caches, one dict per layer (:func:`layer_cache`). With
    ``mesh``: this rank's zero shards of the caches of ``batch`` rows, in
    ``launch.sharding.cache_specs``' layout, marked with their specs."""
    check_decoder(cfg)
    dev = resolve_device(device)
    if mesh is not None:
        from repro_torch.launch import sharding

        meta = torch.device("meta")
        shapes = [layer_cache(cfg, kind, batch, max_len, enc_len=enc_len, device=meta)
                  for kind in layer_kinds(cfg)]
        return sharding.zeros_shards(shapes, sharding.cache_specs(cfg, shapes, mesh, batch),
                                     mesh, dev)
    return [layer_cache(cfg, kind, batch, max_len, enc_len=enc_len, device=dev)
            for kind in layer_kinds(cfg)]


def layer_cache(cfg: ArchConfig, kind: LayerKind, batch: int, max_len: int, *,
                enc_len: int = 0, device: torch.device):
    """One layer's zero decode cache on ``device`` (a ``torch.device``, taken
    as it is: ``meta`` gives shapes without storage): ``{"k", "v"}`` of
    [batch, size, n_kv, d_head] for attention (size = max_len, or the
    layer's window when it is shorter), with ``"cross": {"k", "v"}`` of
    [batch, enc_len, n_kv, d_head] in a decoder layer of an
    encoder-decoder; the zero recurrent state for a Mamba or RWKV layer,
    batch first."""
    dtype = getattr(torch, cfg.dtype)
    if kind.kind == "mamba":
        return ssm.mamba_state_init(batch, _mamba_cfg(cfg), dtype, device)
    if kind.kind == "rwkv":
        return ssm.rwkv_state_init(batch, _rwkv_cfg(cfg), dtype, device)
    c = init_kv_cache(batch, max_len, attn_cfg(cfg, kind), dtype, device)
    if kind.cross:
        c["cross"] = init_kv_cache(batch, enc_len, cross_cfg(cfg), dtype, device)
    return c


def _global_rows(n_local: int, ctx: Ctx) -> int:
    """The batch's global row count from this rank's ``n_local`` rows."""
    if ctx.mesh is None or not ctx.rows_sharded:
        return n_local
    return n_local * ctx.mesh.axis_size(ctx.data_axes)


def prefill(params, batch, ctx: Ctx, cfg: ArchConfig, max_len: int, step_key=None):
    """Forward over the prompts and fill fresh caches: (logits [B, S, V],
    caches). The batch is :func:`forward_with_aux`'s; an encoder-decoder's
    caches hold the memory's cross keys and values. Optional
    ``batch["segments"]`` segment-masks self-attention, so several packed
    prompts share one call. Under a mesh the batch holds this rank's rows
    (``ctx.rows_sharded``; the whole batch otherwise), the logits are this
    rank's rows over the whole vocabulary, and the caches this rank's shards
    (:func:`init_cache` with ``mesh``)."""
    x, positions, memory, ctx = _prologue(params, batch, ctx, cfg, step_key)
    caches = init_cache(cfg, _global_rows(x.shape[0], ctx), max_len,
                        enc_len=0 if memory is None else memory.shape[1], device=x.device,
                        mesh=ctx.mesh)
    x, _ = _run_layers(params, x, ctx, cfg, step_key, positions, caches=caches,
                       segs=batch.get("segments"), memory=memory)
    return _head(params, _sp_join(x, ctx), ctx, cfg), caches


def decode_step(params, caches, tokens, pos, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """One decode step: tokens int [B, 1], or embeds float [B, 1, d], at
    position ``pos`` (an int, or an int tensor [B], one position per row;
    M-RoPE rotates all three streams by it, as JAX does). Writes the new
    keys and values, or the new recurrent state, into ``caches`` in place;
    a cross-attention reads the whole of its cached memory. Returns (logits
    [B, 1, V], caches). Under a mesh: this rank's rows of ``tokens`` and
    ``pos``, and this rank's shards of the caches (:func:`prefill`'s)."""
    check_decoder(cfg)
    ctx = dataclasses.replace(ctx, seq_parallel=False)  # one position: the fixed layout
    positions = _default_positions(cfg, tokens.shape[0], 1, tokens.device, offset=pos)
    x = _embed(params, tokens, cfg) if ctx.mesh is None else _mesh_embed(params, tokens, ctx,
                                                                         cfg)
    x, _ = _run_layers(params, x, ctx, cfg, step_key, positions, caches=caches, pos=pos)
    return _head(params, x, ctx, cfg), caches


def lm_loss(params, batch, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """Next-token cross-entropy plus the MoE aux loss. Returns (loss + aux,
    {"loss", "aux", "nll"}), as in JAX (aux is 0 without MoE layers).

    ``family="mlp"`` configs dispatch to the §5 classification MLP instead:
    the batch is ``{"x", "y"}`` and the metrics gain ``acc``, as in JAX."""
    if cfg.family == "mlp":
        from repro_torch.models import mlp as mlpmod

        loss, acc = mlpmod.mlp_loss(params, batch, ctx)
        return loss, {"loss": loss, "acc": acc, "nll": loss}
    logits, aux = forward_with_aux(params, batch, ctx, cfg, step_key)
    lg32 = logits.to(torch.float32)
    lse = torch.logsumexp(lg32, dim=-1)
    true_logit = lg32.gather(-1, batch["labels"][..., None].long())[..., 0]
    nll = lse - true_logit
    mask = batch.get("mask")
    n_dp = 1 if ctx.mesh is None else ctx.mesh.axis_size(ctx.data_axes)
    if n_dp > 1:
        # this rank's rows' share of the global mean: the ranks' losses (and
        # their gradients) sum to the global one. aux is the global value on
        # every rank, so each carries aux / n_dp (nn/moe.py); the metric
        # "aux" stays the global value, which the step does not sum
        from repro_torch.launch.mesh import psum

        if mask is None:
            loss = nll.mean() / n_dp
        else:
            den = psum(mask.sum().to(torch.float32), ctx.data_axes, ctx.mesh)
            loss = (nll * mask).sum() / den.clamp_min(1.0)
        return loss + aux / n_dp, {"loss": loss, "aux": aux, "nll": loss}
    if mask is None:
        loss = nll.mean()
    else:
        loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return loss + aux, {"loss": loss, "aux": aux, "nll": loss}


def num_params(params) -> int:
    return int(sum(p.numel() for p in tree_leaves(params)))


def active_params_per_token(params, cfg: ArchConfig) -> int:
    """Active parameter count (MoE: only top_k of n_experts per token)."""
    total = num_params(params)
    if cfg.n_experts == 0:
        return total
    e_total = sum(layer["moe"][k].numel() for layer in params["layers"] if "moe" in layer
                  for k in ("wi", "wo", "wg") if k in layer["moe"])
    return total - e_total + int(e_total * cfg.top_k / cfg.n_experts)
