"""Decoder-only LM (port of ``repro/models/lm.py``): the dense decoder,
gemma3's local/global interleave and the MoE family; the training forward,
prefill and decode. ``init_params`` and ``lm_loss`` also dispatch the §5 MLP
(``family="mlp"``), as in JAX.

The JAX model compiles an architecture into segments of stacked, identical
periods (:func:`plan_segments`: gemma3's 5 local + 1 global layers are one
period) and scans them. The port keeps one parameter dict per layer in
``params["layers"]`` and runs a Python loop over :func:`layer_kinds`, the
plan flattened in uid order: layer ``i`` has uid ``i``, the uid JAX's
segment runner gives it (``_layer_uid``), so per-site seeds follow the same
step → layer → role structure. Each layer reads its :class:`LayerKind`: a
window and a RoPE theta of its own (gemma3's local and global layers), and
``{"moe": ...}`` in place of ``{"mlp": ...}`` for an MoE layer. The decode
caches follow the same layout: a list with one ``{"k", "v"}`` dict per layer
(a ring of the window's size for a windowed layer), where JAX stacks each
segment's on a leading axis (``interop.caches_from_jax`` converts). SSM,
hybrid, encoder-decoder, M-RoPE and frontend families are not ported yet
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
    stacked parameters, in uid order."""
    return [f"segments/{si}/{i}" for _, si, i, _ in _walk_plan(cfg)]


def attn_cfg(cfg: ArchConfig, kind: LayerKind) -> AttnCfg:
    """The attention config of a layer of kind ``kind`` (JAX's ``_attn_cfg``),
    and its cache's geometry (``nn.attention.init_kv_cache``)."""
    return AttnCfg(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.head_dim,
                   causal=kind.causal, window=kind.window, rope=cfg.rope,
                   theta=kind.theta or cfg.rope_theta, impl=cfg.attn_impl)


def _moe_cfg(cfg: ArchConfig) -> MoECfg:
    return MoECfg(cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.capacity_factor, cfg.mlp_type)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for configurations outside the ported families: the decoders of
    :func:`check_decoder` and the §5 MLP (``family="mlp"``,
    :func:`models.mlp.mlp_arch`)."""
    if cfg.family != "mlp":
        check_decoder(cfg)


def check_decoder(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError``, naming the architecture, for a config
    outside the ported decoders: the dense decoder family, gemma3's
    local/global interleave and the MoE family (the token forward, prefill
    and decode)."""
    what = None
    if cfg.family not in ("dense", "moe"):
        what = f"the {cfg.family} family"
    elif cfg.block_kind != "attn":
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
            "family, gemma3's local/global interleave and the MoE family)")


def _init_layer(gen, kind: LayerKind, cfg: ArchConfig, dtype, dev):
    d = cfg.d_model
    p = {"norm1": rmsnorm_init(d, dtype, dev),
         "attn": attn_init(gen, d, attn_cfg(cfg, kind), dtype, dev),
         "norm2": rmsnorm_init(d, dtype, dev)}
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
    params = {
        "embed": trunc_normal(gen, (cfg.vocab, d), d ** -0.5, dtype, dev),
        "final_norm": rmsnorm_init(d, dtype, dev),
        "layers": [_init_layer(gen, kind, cfg, dtype, dev) for kind in layer_kinds(cfg)],
    }
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


def _run_layers(params, x, ctx: Ctx, cfg: ArchConfig, step_key, positions, caches=None,
                pos=None, segs=None):
    """Run every layer; returns (x, aux): the MoE layers' aux losses summed
    (float32 zero without MoE layers)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for uid, (kind, p) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        lctx = ctx.for_layer(step_key, uid)
        acfg = attn_cfg(cfg, kind)
        h = rmsnorm(p["norm1"], x)
        if caches is None:
            x = x + attention(p["attn"], h, lctx, acfg, positions, segs=segs)
        else:
            o, _ = attention(p["attn"], h, lctx, acfg, positions, cache=caches[uid], pos=pos,
                             segs=segs)
            x = x + o
        h2 = rmsnorm(p["norm2"], x)
        if kind.moe:
            o, a = moe_ffn(p["moe"], h2, lctx, _moe_cfg(cfg))
            aux = aux + a
        else:
            o = mlp(p["mlp"], h2, lctx, cfg.mlp_type)
        x = x + o
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
    """Zero decode caches, one ``{"k", "v"}`` dict of [batch, size, n_kv,
    d_head] per layer (size = max_len, or the layer's window when it is
    shorter)."""
    check_decoder(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    return [init_kv_cache(batch, max_len, attn_cfg(cfg, kind), dtype, dev)
            for kind in layer_kinds(cfg)]


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
    int tensor [B], one position per row). Writes the new keys and values
    into ``caches`` in place. Returns (logits [B, 1, V], caches)."""
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
