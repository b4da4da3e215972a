"""Decoder-only LM (port of ``repro/models/lm.py``): the dense decoder,
gemma3's local/global interleave, the MoE family, and the SSM (rwkv) and
hybrid (zamba: Mamba2 layers with one shared attention block) families; the
training forward, prefill and decode. ``init_params`` and ``lm_loss`` also
dispatch the §5 MLP (``family="mlp"``), as in JAX.

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
converts). Encoder-decoder, M-RoPE and frontend families are not ported yet
(:func:`check_decoder`).
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
from repro_torch.nn.attention import AttnCfg, attention, attn_init, init_kv_cache
from repro_torch.nn.common import Ctx, dense_init, rmsnorm, rmsnorm_init, trunc_normal
from repro_torch.nn.mlp import mlp, mlp_init
from repro_torch.nn.moe import MoECfg, moe_ffn, moe_init
from repro_torch.tree import tree_leaves

__all__ = ["LayerKind", "plan_segments", "layer_kinds", "jax_layer_paths", "init_params",
           "forward", "forward_with_aux", "lm_loss", "num_params", "active_params_per_token",
           "check_supported", "attn_cfg", "check_decoder", "init_cache", "prefill",
           "decode_step"]


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


def _walk_plan(cfg: ArchConfig):
    """(uid, segment, sub-block, kind) of every layer, in uid order."""
    base = 0
    for si, (period, n_rep) in enumerate(plan_segments(cfg)):
        for rep in range(n_rep):
            for i, kind in enumerate(period):
                yield _layer_uid(base, rep, len(period), i), si, i, kind
        base += n_rep * len(period)


def layer_kinds(cfg: ArchConfig) -> list:
    """One :class:`LayerKind` per layer, in uid order: the plan of
    :func:`plan_segments` flattened (layer ``i`` has uid ``i``)."""
    return [kind for _, _, _, kind in _walk_plan(cfg)]


def jax_layer_paths(cfg: ArchConfig) -> list:
    """The JAX tree path (``segments/<segment>/<sub-block>``) of each layer's
    stacked parameters, in uid order; ``shared`` for a ``shared_attn`` layer,
    whose weights JAX keeps once in ``params["shared"]``."""
    return ["shared" if kind.kind == "shared_attn" else f"segments/{si}/{i}"
            for _, si, i, kind in _walk_plan(cfg)]


def attn_cfg(cfg: ArchConfig, kind: LayerKind) -> AttnCfg:
    """The attention config of a layer of kind ``kind`` (JAX's ``_attn_cfg``),
    and its cache's geometry (``nn.attention.init_kv_cache``)."""
    return AttnCfg(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.head_dim,
                   causal=kind.causal, window=kind.window, rope=cfg.rope,
                   theta=kind.theta or cfg.rope_theta, impl=cfg.attn_impl)


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
    outside the ported decoders: the dense decoder family, gemma3's
    local/global interleave, the MoE family, and the SSM (rwkv) and hybrid
    (zamba) families (the token forward, prefill and decode)."""
    what = None
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        what = f"the {cfg.family} family"
    elif cfg.block_kind not in ("attn", "rwkv", "zamba"):
        what = f"block kind {cfg.block_kind!r}"
    elif cfg.is_encdec:
        what = "the encoder-decoder stack"
    elif cfg.rope not in ("default", "none"):
        what = f"rope {cfg.rope!r}"
    elif cfg.frontend is not None:
        what = f"the {cfg.frontend} frontend"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported to repro_torch yet (ported: the dense decoder "
            "family, gemma3's local/global interleave, the MoE family, and the SSM and "
            "hybrid families)")


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
    return p


def init_params(seed: int, cfg: ArchConfig, *, device="cuda"):
    """Random parameters from ``seed``, on ``device`` (default the card);
    an ``mlp_arch`` config gives the §5 MLP's list of layers."""
    check_supported(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    if cfg.family == "mlp":
        from repro_torch.models import mlp as mlpmod

        return mlpmod.mlp_init(seed, mlpmod.mlp_sizes(cfg), dtype, device=device)
    dev = resolve_device(device)
    gen = rng.generator(seed, dev)
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
    return params


def _default_positions(B: int, S: int, device, offset=0):
    """[B, S] positions from ``offset``: an int, or an int tensor [B] of
    per-row start positions (decode)."""
    pos = torch.arange(S, device=device)[None, :]
    if isinstance(offset, torch.Tensor):
        pos = offset.to(device=device, dtype=torch.long).reshape(-1, 1) + pos
    else:
        pos = pos + int(offset)
    return pos.expand(B, S)


def _embed(params, tokens, cfg: ArchConfig):
    x = params["embed"][tokens].to(getattr(torch, cfg.dtype))
    if cfg.embed_scale:
        x = x * cfg.d_model ** 0.5
    return x


def _head(params, x, ctx: Ctx, cfg: ArchConfig):
    x = rmsnorm(params["final_norm"], x)
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]["w"]
    hcfg = ctx.cfg_for("lm_head")
    key = ctx.site_key("lm_head", x.device) if hcfg is not None else None
    return linear(x, w, key=key, cfg=hcfg)


def _attn_layer(p, kind: LayerKind, x, ctx: Ctx, cfg: ArchConfig, positions, cache, pos,
                segs):
    """A pre-norm attention layer (its MLP or MoE after it): (x, aux or None)."""
    o = attention(p["attn"], rmsnorm(p["norm1"], x), ctx, attn_cfg(cfg, kind), positions,
                  cache=cache, pos=pos, segs=segs)
    x = x + (o if cache is None else o[0])  # with a cache: (out, cache)
    h2 = rmsnorm(p["norm2"], x)
    if kind.moe:
        o, a = moe_ffn(p["moe"], h2, ctx, _moe_cfg(cfg))
        return x + o, a
    return x + mlp(p["mlp"], h2, ctx, cfg.mlp_type), None


def _write_state(cache, state: dict) -> None:
    """Write a recurrent layer's new state into its cache, in place."""
    for k, v in state.items():
        cache[k].copy_(v)


def _mamba_layer(p, x, ctx: Ctx, cfg: ArchConfig, cache, pos):
    mcfg = _mamba_cfg(cfg)
    h = rmsnorm(p["norm1"], x)
    if cache is None:
        return x + ssm.mamba_block(p["mamba"], h, ctx, mcfg)
    if pos is None:
        o, state = ssm.mamba_prefill(p["mamba"], h, ctx, mcfg)
    else:
        o, state = ssm.mamba_decode(p["mamba"], h, ctx, mcfg, cache)
    _write_state(cache, state)
    return x + o


def _rwkv_layer(p, x, ctx: Ctx, cfg: ArchConfig, cache):
    rcfg = _rwkv_cfg(cfg)
    tm = None if cache is None else {"wkv": cache["wkv"], "shift": cache["shift_tm"]}
    o, new_tm = ssm.rwkv_time_mix(p["rwkv"], rmsnorm(p["norm1"], x), ctx, rcfg, tm)
    x = x + o
    o, new_cm = ssm.rwkv_channel_mix(p["rwkv"], rmsnorm(p["norm2"], x), ctx, rcfg,
                                     None if cache is None else cache["shift_cm"])
    if cache is not None:
        _write_state(cache, {"wkv": new_tm["wkv"], "shift_tm": new_tm["shift"],
                             "shift_cm": new_cm})
    return x + o


def _run_layers(params, x, ctx: Ctx, cfg: ArchConfig, step_key, positions, caches=None,
                pos=None, segs=None):
    """Run every layer; returns (x, aux): the MoE layers' aux losses summed
    (float32 zero without MoE layers). With ``caches``, a prefill
    (``pos=None``) or decode step writes each layer's new keys and values or
    recurrent state into its cache."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for uid, (kind, p) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        lctx = ctx.for_layer(step_key, uid)
        cache = caches[uid] if caches is not None else None
        if kind.kind in ("attn", "shared_attn"):
            if kind.kind == "shared_attn":
                p = params["shared"]
            x, a = _attn_layer(p, kind, x, lctx, cfg, positions, cache, pos, segs)
            if a is not None:
                aux = aux + a
            continue
        if segs is not None:
            # JAX's recurrent layers ignore segments: packed prompts would
            # leak state into each other
            raise ValueError(f"{cfg.name}: a {kind.kind} layer carries state across the "
                             "sequence and cannot run segment-packed prompts")
        if kind.kind == "mamba":
            x = _mamba_layer(p, x, lctx, cfg, cache, pos)
        else:
            x = _rwkv_layer(p, x, lctx, cfg, cache)
    return x, aux


def forward_with_aux(params, batch, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """Training forward: (logits, aux), JAX's ``lm.forward``.
    ``batch["tokens"]``: int [B, S] on the params' device; optional
    ``"positions"`` [B, S] and ``"segments"`` (int [B, S], 0 = padding:
    attention stays within a segment). ``step_key``: the step's integer seed
    (None = no sketching). ``aux``: the MoE layers' summed load-balance loss
    (float32 zero without them)."""
    check_decoder(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(B, S, tokens.device)
    x, aux = _run_layers(params, _embed(params, tokens, cfg), ctx, cfg, step_key, positions,
                         segs=batch.get("segments"))
    return _head(params, x, ctx, cfg), aux


def forward(params, batch, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """The logits of :func:`forward_with_aux`."""
    return forward_with_aux(params, batch, ctx, cfg, step_key)[0]


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda"):
    """Zero decode caches, one dict per layer: ``{"k", "v"}`` of [batch, size,
    n_kv, d_head] for attention (size = max_len, or the layer's window when
    it is shorter), the zero recurrent state for a Mamba or RWKV layer."""
    check_decoder(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def one(kind):
        if kind.kind == "mamba":
            return ssm.mamba_state_init(batch, _mamba_cfg(cfg), dtype, dev)
        if kind.kind == "rwkv":
            return ssm.rwkv_state_init(batch, _rwkv_cfg(cfg), dtype, dev)
        return init_kv_cache(batch, max_len, attn_cfg(cfg, kind), dtype, dev)

    return [one(kind) for kind in layer_kinds(cfg)]


def prefill(params, batch, ctx: Ctx, cfg: ArchConfig, max_len: int, step_key=None):
    """Forward over the prompts and fill fresh caches: (logits [B, S, V],
    caches). Optional ``batch["segments"]`` segment-masks self-attention, so
    several packed prompts share one call."""
    check_decoder(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(B, S, tokens.device)
    caches = init_cache(cfg, B, max_len, device=tokens.device)
    x, _ = _run_layers(params, _embed(params, tokens, cfg), ctx, cfg, step_key, positions,
                       caches=caches, segs=batch.get("segments"))
    return _head(params, x, ctx, cfg), caches


def decode_step(params, caches, tokens, pos, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """One decode step: tokens int [B, 1] at position ``pos`` (an int, or an
    int tensor [B], one position per row). Writes the new keys and values,
    or the new recurrent state, into ``caches`` in place. Returns (logits
    [B, 1, V], caches)."""
    check_decoder(cfg)
    B = tokens.shape[0]
    positions = _default_positions(B, 1, tokens.device, offset=pos)
    x, _ = _run_layers(params, _embed(params, tokens, cfg), ctx, cfg, step_key, positions,
                       caches=caches, pos=pos)
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
