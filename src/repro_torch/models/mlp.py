"""The paper's §5 MLP: 784 -> 64 -> 64 -> 10, cross-entropy, SGD, clip 1.0.

Port of ``repro/models/mlp.py``. Every linear layer is a sketched VJP site;
the location study (App. B.1, Fig. 4) uses the policy's first/last/all
placement with static layer indices, as the paper applies it. The last layer
has role ``lm_head``, the others ``mlp_in``. Parameters are a list of
``{"w": [d_out, d_in], "b": [d_out]}`` dicts, the JAX package's layout.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.nn.common import Ctx, dense, dense_init

__all__ = ["mlp_arch", "mlp_init", "mlp_apply", "mlp_loss", "mlp_sizes"]


def mlp_arch(sizes=(784, 64, 64, 10), name: str = "mlp") -> ArchConfig:
    """The §5 MLP as an :class:`~repro_torch.configs.base.ArchConfig`
    (``family="mlp"``), so that ``lm.init_params``/``lm.lm_loss`` and with
    them ``Runtime.train`` drive it. Field reuse, as in JAX: ``d_ff`` = input
    dim, ``d_model`` = hidden width, ``vocab`` = class count (recovered by
    :func:`mlp_sizes`); the head fields are placeholders."""
    sizes = tuple(int(s) for s in sizes)
    if len(sizes) < 2:
        raise ValueError(f"mlp_arch needs >= 2 sizes, got {sizes}")
    if len(set(sizes[1:-1])) > 1:
        raise ValueError(f"mlp_arch encodes one hidden width, got {sizes}")
    return ArchConfig(name=name, family="mlp", n_layers=len(sizes) - 1,
                      d_model=(sizes[1] if len(sizes) > 2 else sizes[0]),
                      n_heads=1, n_kv=1, d_ff=sizes[0], vocab=sizes[-1])


def mlp_sizes(cfg: ArchConfig) -> tuple:
    """Layer sizes back out of an :func:`mlp_arch` config."""
    return (cfg.d_ff,) + (cfg.d_model,) * (cfg.n_layers - 1) + (cfg.vocab,)


def mlp_init(seed: int, sizes=(784, 64, 64, 10), dtype=torch.float32, *, device="cuda"):
    """Random parameters from ``seed``, on ``device`` (default the card)."""
    dev = resolve_device(device)
    gen = rng.generator(seed, dev)
    return [dense_init(gen, a, b, dtype, device=dev, bias=True)
            for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_apply(params, x, ctx: Ctx):
    L = len(params)
    for i, p in enumerate(params):
        # a static layer index: the location policy (first/last/all) applies
        lctx = dataclasses.replace(ctx.for_layer(ctx.key, i), layer_index=i, n_layers=L)
        x = dense(p, x, lctx, "lm_head" if i == L - 1 else "mlp_in")
        if i < L - 1:
            x = F.relu(x)
    return x


def cls_metrics(logits, labels):
    """(mean cross-entropy, accuracy) of ``logits`` [B, C] against int
    ``labels`` [B], in float32."""
    lg = logits.to(torch.float32)
    labels = labels.long()
    loss = (torch.logsumexp(lg, dim=-1) - lg.gather(-1, labels[:, None])[:, 0]).mean()
    acc = (lg.argmax(-1) == labels).to(torch.float32).mean()
    return loss, acc


def mlp_loss(params, batch, ctx: Ctx):
    """(loss, accuracy) on ``{"x": [B, d_in], "y": int [B]}``."""
    return cls_metrics(mlp_apply(params, batch["x"], ctx), batch["y"])
