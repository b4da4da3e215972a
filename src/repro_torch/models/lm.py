"""Decoder-only LM, dense family (port of ``repro/models/lm.py``).

The JAX model scans stacked layers; the port keeps one parameter dict per
layer in ``params["layers"]`` and runs a Python loop. Layer ``i`` has uid
``i``, the uid the JAX segment runner gives it, so per-site seeds follow the
same step → layer → role structure. MoE, SSM, hybrid, encoder-decoder and
local/global families are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.configs.base import ArchConfig
from repro_torch.core import linear
from repro_torch.device import resolve_device
from repro_torch.nn.attention import AttnCfg, attention, attn_init
from repro_torch.nn.common import Ctx, dense_init, rmsnorm, rmsnorm_init, trunc_normal
from repro_torch.nn.mlp import mlp, mlp_init
from repro_torch.tree import tree_leaves

__all__ = ["init_params", "forward", "lm_loss", "num_params", "check_supported"]


def check_supported(cfg: ArchConfig) -> None:
    """Raise for configurations outside the ported dense family."""
    if (cfg.family not in ("dense",) or cfg.block_kind != "attn" or cfg.n_experts
            or cfg.is_encdec or cfg.local_global or cfg.rope not in ("default", "none")
            or cfg.frontend is not None):
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoder family is ported to repro_torch yet")


def _attn_cfg(cfg: ArchConfig) -> AttnCfg:
    return AttnCfg(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.head_dim,
                   causal=True, window=cfg.window, rope=cfg.rope, theta=cfg.rope_theta)


def init_params(seed: int, cfg: ArchConfig, *, device="cuda"):
    """Random parameters from ``seed``, on ``device`` (default the card)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    gen = rng.generator(seed, dev)
    d = cfg.d_model
    params = {
        "embed": trunc_normal(gen, (cfg.vocab, d), d ** -0.5, dtype, dev),
        "final_norm": rmsnorm_init(d, dtype, dev),
        "layers": [
            {"norm1": rmsnorm_init(d, dtype, dev),
             "attn": attn_init(gen, d, _attn_cfg(cfg), dtype, dev),
             "norm2": rmsnorm_init(d, dtype, dev),
             "mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp_type, dtype, dev)}
            for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.vocab, dtype, device=dev, scale=d ** -0.5)
    return params


def forward(params, batch, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """Training forward. ``batch["tokens"]``: int [B, S] on the params' device.
    ``step_key``: the step's integer seed (None = no sketching). Returns logits."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens].to(getattr(torch, cfg.dtype))
    if cfg.embed_scale:
        x = x * cfg.d_model ** 0.5
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    acfg = _attn_cfg(cfg)
    for uid, p in enumerate(params["layers"]):
        lctx = ctx.for_layer(step_key, uid)
        x = x + attention(p["attn"], rmsnorm(p["norm1"], x), lctx, acfg, positions)
        x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x), lctx, cfg.mlp_type)
    x = rmsnorm(params["final_norm"], x)
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]["w"]
    hcfg = ctx.cfg_for("lm_head")
    key = ctx.site_key("lm_head", x.device) if hcfg is not None else None
    return linear(x, w, key=key, cfg=hcfg)


def lm_loss(params, batch, ctx: Ctx, cfg: ArchConfig, step_key=None):
    """Next-token cross-entropy. Returns (loss, metrics dict)."""
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
