"""Causal GQA self-attention for the training path.

Port of the training path of ``repro/nn/attention.py``: sketched q/k/v/o
projections, RoPE, and the attention core as plain float32 matmul and
softmax (the JAX ``einsum`` impl; the chunked impl computes the same
function in another order). Flash attention, KV caches, segment masks,
cross-attention and M-RoPE are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.nn.common import Ctx, dense, dense_init
from repro_torch.nn.rope import apply_rope

__all__ = ["AttnCfg", "attn_init", "attention", "multi_head_attention"]


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv: int
    d_head: int
    causal: bool = True
    window: Optional[int] = None  # sliding window (None = full)
    rope: str = "default"  # default | none
    theta: float = 10000.0

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


def multi_head_attention(q, k, v, cfg: AttnCfg):
    """q [B, Sq, H, dh], k/v [B, Skv, Kv, dh] -> [B, Sq, H, dh]; float32 scores
    and softmax; the causal mask is right-aligned when Skv > Sq."""
    Sq, dh = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    if cfg.groups > 1:
        k = k.repeat_interleave(cfg.groups, dim=2)
        v = v.repeat_interleave(cfg.groups, dim=2)
    s = torch.einsum("bqhd,bchd->bhqc", q.to(torch.float32), k.to(torch.float32)) * dh ** -0.5
    if cfg.causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = qpos >= kpos
        if cfg.window:
            mask &= (qpos - kpos) < cfg.window
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqc,bchd->bqhd", p, v.to(torch.float32))
    return o.to(q.dtype)


def attention(params, x, ctx: Ctx, cfg: AttnCfg, positions, role_prefix: str = "attn"):
    """Attention sublayer: sketched projections + core + sketched out-proj."""
    B, S, _ = x.shape
    q = dense(params["q"], x, ctx, f"{role_prefix}_q").reshape(B, S, cfg.n_heads, cfg.d_head)
    k = dense(params["k"], x, ctx, f"{role_prefix}_k").reshape(B, S, cfg.n_kv, cfg.d_head)
    v = dense(params["v"], x, ctx, f"{role_prefix}_v").reshape(B, S, cfg.n_kv, cfg.d_head)
    if cfg.rope == "default":
        q = apply_rope(q, positions, cfg.theta)
        k = apply_rope(k, positions, cfg.theta)
    elif cfg.rope != "none":
        raise NotImplementedError(f"rope {cfg.rope!r} is not ported to repro_torch yet")
    o = multi_head_attention(q, k, v, cfg)
    return dense(params["o"], o.reshape(B, S, -1), ctx, f"{role_prefix}_o")
