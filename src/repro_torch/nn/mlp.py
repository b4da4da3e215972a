"""Feed-forward blocks: plain MLP, GLU family (SwiGLU/GeGLU), squared-ReLU.
Port of ``repro/nn/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.nn.common import ACTIVATIONS, Ctx, dense, dense_init

__all__ = ["mlp_init", "mlp"]

_GLU = {"swiglu": "silu", "geglu": "gelu"}


def mlp_init(gen, d_model: int, d_ff: int, mlp_type: str, dtype=torch.float32, device="cpu"):
    p = {"in": dense_init(gen, d_model, d_ff, dtype, device=device),
         "out": dense_init(gen, d_ff, d_model, dtype, device=device, scale=d_ff ** -0.5)}
    if mlp_type in _GLU:
        p["gate"] = dense_init(gen, d_model, d_ff, dtype, device=device)
    return p


def mlp(params, x, ctx: Ctx, mlp_type: str, role_prefix: str = "mlp"):
    h = dense(params["in"], x, ctx, f"{role_prefix}_in")
    if mlp_type in _GLU:
        g = dense(params["gate"], x, ctx, f"{role_prefix}_gate")
        h = ACTIVATIONS[_GLU[mlp_type]](g.to(torch.float32)).to(h.dtype) * h
    else:
        act = {"relu_sq": "relu_sq", "gelu": "gelu", "relu": "relu"}.get(mlp_type, "gelu")
        h = ACTIVATIONS[act](h.to(torch.float32)).to(h.dtype)
    return dense(params["out"], h, ctx, f"{role_prefix}_out")
