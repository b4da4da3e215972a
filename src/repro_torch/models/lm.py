"""Decoder-only LM, dense family (port of ``repro/models/lm.py``): the
training forward, prefill and decode; ``init_params`` and ``lm_loss`` also
dispatch the §5 MLP (``family="mlp"``), as in JAX.

The JAX model scans stacked layers; the port keeps one parameter dict per
layer in ``params["layers"]`` and runs a Python loop. Layer ``i`` has uid
``i``, the uid the JAX segment runner gives it, so per-site seeds follow the
same step → layer → role structure. The decode caches follow the same
layout: a list with one ``{"k", "v"}`` dict per layer, where JAX stacks them
on a leading ``[n_layers]`` axis (``interop.caches_from_jax`` converts).
MoE, SSM, hybrid, encoder-decoder and local/global families are not ported
yet.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.configs.base import ArchConfig
from repro_torch.core import linear
from repro_torch.device import resolve_device
from repro_torch.nn.attention import AttnCfg, attention, attn_init, init_kv_cache
from repro_torch.nn.common import Ctx, dense_init, rmsnorm, rmsnorm_init, trunc_normal
from repro_torch.nn.mlp import mlp, mlp_init
from repro_torch.tree import tree_leaves

__all__ = ["init_params", "forward", "lm_loss", "num_params", "check_supported", "attn_cfg",
           "check_decoder", "init_cache", "prefill", "decode_step"]


def check_supported(cfg: ArchConfig) -> None:
    """Raise for configurations outside the ported families: the dense
    decoder and the §5 MLP (``family="mlp"``, :func:`models.mlp.mlp_arch`)."""
    if cfg.family != "mlp":
        check_decoder(cfg)


def check_decoder(cfg: ArchConfig) -> None:
    """Raise for configurations outside the ported dense decoder family (the
    token forward, prefill and decode)."""
    if (cfg.family not in ("dense",) or cfg.block_kind != "attn" or cfg.n_experts
            or cfg.is_encdec or cfg.local_global or cfg.rope not in ("default", "none")
            or cfg.frontend is not None):
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoder family is ported to repro_torch yet")


def attn_cfg(cfg: ArchConfig) -> AttnCfg:
    """The attention config every layer of ``cfg`` runs (and its caches'
    geometry: ``nn.attention.init_kv_cache``)."""
    return AttnCfg(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.head_dim,
                   causal=True, window=cfg.window, rope=cfg.rope, theta=cfg.rope_theta,
                   impl=cfg.attn_impl)


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
        "layers": [
            {"norm1": rmsnorm_init(d, dtype, dev),
             "attn": attn_init(gen, d, attn_cfg(cfg), dtype, dev),
             "norm2": rmsnorm_init(d, dtype, dev),
             "mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp_type, dtype, dev)}
            for _ in range(cfg.n_layers)],
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
    acfg = attn_cfg(cfg)
    for uid, p in enumerate(params["layers"]):
        lctx = ctx.for_layer(step_key, uid)
        h = rmsnorm(p["norm1"], x)
        if caches is None:
            x = x + attention(p["attn"], h, lctx, acfg, positions, segs=segs)
        else:
            o, _ = attention(p["attn"], h, lctx, acfg, positions, cache=caches[uid], pos=pos,
                             segs=segs)
            x = x + o
        x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x), lctx, cfg.mlp_type)
    return x


def forward(params, batch, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """Training forward. ``batch["tokens"]``: int [B, S] on the params' device;
    optional ``"positions"`` [B, S] and ``"segments"`` (int [B, S], 0 =
    padding: attention stays within a segment). ``step_key``: the step's
    integer seed (None = no sketching). Returns logits."""
    check_decoder(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(B, S, tokens.device)
    x = _run_layers(params, _embed(params, tokens, cfg), ctx, cfg, step_key, positions,
                    segs=batch.get("segments"))
    return _head(params, x, ctx, cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda"):
    """Zero decode caches, one ``{"k", "v"}`` dict of [batch, size, n_kv,
    d_head] per layer (size = max_len, or the window when it is shorter)."""
    check_decoder(cfg)
    dev = resolve_device(device)
    acfg = attn_cfg(cfg)
    return [init_kv_cache(batch, max_len, acfg, getattr(torch, cfg.dtype), dev)
            for _ in range(cfg.n_layers)]


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
    x = _run_layers(params, _embed(params, tokens, cfg), ctx, cfg, step_key, positions,
                    caches=caches, segs=batch.get("segments"))
    return _head(params, x, ctx, cfg), caches


def decode_step(params, caches, tokens, pos, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """One decode step: tokens int [B, 1] at position ``pos`` (an int, or an
    int tensor [B], one position per row). Writes the new keys and values
    into ``caches`` in place. Returns (logits [B, 1, V], caches)."""
    check_decoder(cfg)
    B = tokens.shape[0]
    positions = _default_positions(B, 1, tokens.device, offset=pos)
    x = _run_layers(params, _embed(params, tokens, cfg), ctx, cfg, step_key, positions,
                    caches=caches, pos=pos)
    return _head(params, x, ctx, cfg), caches


def lm_loss(params, batch, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """Next-token cross-entropy. Returns (loss, metrics dict).

    ``family="mlp"`` configs dispatch to the §5 classification MLP instead:
    the batch is ``{"x", "y"}`` and the metrics gain ``acc``, as in JAX."""
    if cfg.family == "mlp":
        from repro_torch.models import mlp as mlpmod

        loss, acc = mlpmod.mlp_loss(params, batch, ctx)
        return loss, {"loss": loss, "acc": acc, "nll": loss}
    logits = forward(params, batch, ctx, cfg, step_key)
    lg32 = logits.to(torch.float32)
    lse = torch.logsumexp(lg32, dim=-1)
    true_logit = lg32.gather(-1, batch["labels"][..., None].long())[..., 0]
    nll = lse - true_logit
    mask = batch.get("mask")
    if mask is None:
        loss = nll.mean()
    else:
        loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return loss, {"loss": loss, "nll": loss}


def num_params(params) -> int:
    return int(sum(p.numel() for p in tree_leaves(params)))
