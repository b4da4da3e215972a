"""Paper §5 larger architectures: ViT (Dosovitskiy 2021) and a BagNet-17-style
1×1-conv network (Brendel & Bethge 2019), sized per App. B.2.

Port of ``repro/models/vision.py``. Images are NHWC ``[B, H, W, 3]``, as in
JAX. BagNet's 1×1 convolutions are sketched linear sites over ``[B, H, W,
C]`` (a 1×1 conv is a dense layer over channels at every pixel); its 3×3
convolutions and 2×2 max-pools are exact library calls
(``torch.nn.functional.conv2d``/``max_pool2d``, as JAX leaves them to
``lax.conv_general_dilated``/``lax.reduce_window``). The activations stay
NHWC and contiguous, channels-last in memory: each 3×3 convolution sees a
channels-last NCHW view and its output's NHWC view is contiguous again, so
the sites flatten ``[B, H, W, C]`` to ``[N, C]`` without a copy. A 3×3 weight
is OIHW ``[cout, cin, k, k]``, PyTorch's layout (JAX's is HWIO;
``interop.bagnet_params_from_jax`` converts). ViT sketches its attention
projections and MLP layers; its attention is the plain non-causal einsum
path without RoPE (``impl="einsum"``), in JAX as here.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.device import resolve_device
from repro_torch.models.mlp import cls_metrics
from repro_torch.nn.attention import AttnCfg, attention, attn_init
from repro_torch.nn.common import Ctx, dense, dense_init, layernorm, layernorm_init
from repro_torch.nn.mlp import mlp as mlp_block
from repro_torch.nn.mlp import mlp_init

__all__ = ["vit_init", "vit_apply", "bagnet_init", "bagnet_apply", "cls_loss"]


# ---------------------------------------------------------------------------
# ViT — paper App. B.2: d=192, mlp 1024, depth 9, heads 12, patch 4 (CIFAR).
# ---------------------------------------------------------------------------


def _vit_attn(heads: int, d: int) -> AttnCfg:
    return AttnCfg(n_heads=heads, n_kv=heads, d_head=d // heads, causal=False, rope="none",
                   impl="einsum")


def vit_init(seed: int, *, img=32, patch=4, d=192, depth=9, heads=12, d_ff=1024,
             n_classes=10, dtype=torch.float32, device="cuda"):
    """Random ViT parameters from ``seed``, on ``device`` (default the card)."""
    dev = resolve_device(device)
    gen = rng.generator(seed, dev)
    n_tok = (img // patch) ** 2
    acfg = _vit_attn(heads, d)
    layers = [{"ln1": layernorm_init(d, dtype, dev), "attn": attn_init(gen, d, acfg, dtype, dev),
               "ln2": layernorm_init(d, dtype, dev),
               "mlp": mlp_init(gen, d, d_ff, "gelu", dtype, dev)} for _ in range(depth)]
    return {
        "patch": dense_init(gen, patch * patch * 3, d, dtype, device=dev, bias=True),
        "pos": torch.randn((1, n_tok + 1, d), generator=gen, device=dev) * 0.02,
        "cls": torch.zeros((1, 1, d), dtype=dtype, device=dev),
        "layers": layers,
        "ln_f": layernorm_init(d, dtype, dev),
        "head": dense_init(gen, d, n_classes, dtype, device=dev, bias=True),
    }


def _patchify(x, patch: int):
    B, H, W, C = x.shape
    x = x.reshape(B, H // patch, patch, W // patch, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // patch) * (W // patch), patch * patch * C)


def vit_apply(params, x, ctx: Ctx, *, heads: int = 12):
    """x: [B, H, W, 3] images -> [B, n_classes] logits. ``heads`` is static
    config; the patch size follows from the shapes."""
    patch = int(round((params["patch"]["w"].shape[1] // 3) ** 0.5))
    d = params["pos"].shape[-1]
    acfg = _vit_attn(heads, d)
    t = dense(params["patch"], _patchify(x, patch), ctx, "input_proj")
    B = t.shape[0]
    cls = params["cls"].expand(B, 1, d).to(t.dtype)
    t = torch.cat([cls, t], dim=1) + params["pos"].to(t.dtype)
    L = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        lctx = dataclasses.replace(ctx.for_layer(ctx.key, i), layer_index=i, n_layers=L)
        # no RoPE: the attention reads no positions
        t = t + attention(lp["attn"], layernorm(lp["ln1"], t), lctx, acfg, None)
        t = t + mlp_block(lp["mlp"], layernorm(lp["ln2"], t), lctx, "gelu")
    t = layernorm(params["ln_f"], t)
    return dense(params["head"], t[:, 0], ctx, "lm_head")


# ---------------------------------------------------------------------------
# BagNet-17-style: mostly 1×1 convs (sketched linears over pixels) with a few
# exact 3×3 stages, ResNet-ish residual blocks.
# ---------------------------------------------------------------------------


def bagnet_init(seed: int, *, width=64, n_blocks=(2, 2, 2), n_classes=10, dtype=torch.float32,
                device="cuda"):
    """Random BagNet parameters from ``seed``, on ``device`` (default the
    card). 1×1 convolutions are ``{"w": [cout, cin], "b"}`` linear sites; 3×3
    ones ``{"w": [cout, cin, 3, 3] (OIHW), "b"}``."""
    dev = resolve_device(device)
    gen = rng.generator(seed, dev)
    params = {"stem": _conv_init(gen, 3, width, 3, dtype, dev)}
    blocks = []
    w = width
    for si, n in enumerate(n_blocks):
        stage = []
        for bi in range(n):
            stage.append({
                "c1": dense_init(gen, w, w, dtype, device=dev, bias=True),  # 1x1 (sketched)
                "c2": _conv_init(gen, w, w, 3, dtype, dev),  # 3x3 (exact)
                "c3": dense_init(gen, w, w * 2 if bi == n - 1 and si < 2 else w, dtype,
                                 device=dev, bias=True),  # 1x1 (sketched)
            })
        blocks.append(stage)
        if si < 2:
            w *= 2
    params["blocks"] = blocks
    params["head"] = dense_init(gen, w, n_classes, dtype, device=dev, bias=True)
    return params


def _conv_init(gen, cin, cout, k, dtype, device):
    w = torch.randn((cout, cin, k, k), generator=gen, device=device) * (k * k * cin) ** -0.5
    return {"w": w.to(dtype), "b": torch.zeros(cout, dtype=dtype, device=device)}


def _conv(p, x):
    """Stride-1 "SAME" convolution of NHWC ``x`` with the OIHW weight
    ``p["w"]`` (odd kernel, as JAX's callers use it); NHWC out, contiguous."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"], p["b"], padding=p["w"].shape[-1] // 2)
    return y.permute(0, 2, 3, 1).contiguous()


def _max_pool2(x):
    """2×2 max-pool, stride 2, no padding, of NHWC ``x``; NHWC out, contiguous."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1).contiguous()


def bagnet_apply(params, x, ctx: Ctx):
    """x: [B, H, W, 3] -> logits. The 1×1 convs are sketched dense sites."""
    x = F.relu(_conv(params["stem"], x))
    li = 0
    n_layers = sum(len(s) for s in params["blocks"])
    for si, stage in enumerate(params["blocks"]):
        for bp in stage:
            lctx = dataclasses.replace(ctx.for_layer(ctx.key, li), layer_index=li,
                                       n_layers=n_layers)
            li += 1
            h = F.relu(dense(bp["c1"], x, lctx, "mlp_in"))
            h = F.relu(_conv(bp["c2"], h))
            h = dense(bp["c3"], h, lctx, "mlp_out")
            x = F.relu(x + h) if h.shape[-1] == x.shape[-1] else F.relu(h)
        if si < len(params["blocks"]) - 1:
            x = _max_pool2(x)
    return dense(params["head"], x.mean(dim=(1, 2)), ctx, "lm_head")


def cls_loss(apply_fn, params, batch, ctx: Ctx):
    """(mean cross-entropy, accuracy) of ``apply_fn`` on ``{"x", "y"}``."""
    return cls_metrics(apply_fn(params, batch["x"], ctx), batch["y"])
