"""Feed-forward blocks: plain MLP, GLU family (SwiGLU/GeGLU), squared-ReLU.
Port of ``repro/nn/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.nn.common import ACTIVATIONS, MODEL_SHARDED_OUT, Ctx, dense, dense_init

__all__ = ["mlp_init", "mlp"]

_GLU = {"swiglu": "silu", "geglu": "gelu"}


def mlp_init(gen, d_model: int, d_ff: int, mlp_type: str, dtype=torch.float32, device="cpu"):
    p = {"in": dense_init(gen, d_model, d_ff, dtype, device=device),
         "out": dense_init(gen, d_ff, d_model, dtype, device=device, scale=d_ff ** -0.5)}
    if mlp_type in _GLU:
        p["gate"] = dense_init(gen, d_model, d_ff, dtype, device=device)
    return p


def mlp(params, x, ctx: Ctx, mlp_type: str, role_prefix: str = "mlp"):
    """Under a mesh the hidden layer stays on this rank's d_ff chunk when the
    input projections run column-parallel and the output row-parallel; any
    other mix gathers or slices it over the model axis."""
    h = dense(params["in"], x, ctx, f"{role_prefix}_in")
    local = (ctx.mesh is not None
             and ctx.plan_kind(f"{role_prefix}_in", params["in"]) in MODEL_SHARDED_OUT)
    if mlp_type in _GLU:
        g = dense(params["gate"], x, ctx, f"{role_prefix}_gate")
        if ctx.mesh is not None:
            h, g, local = _same_layout(ctx, params, role_prefix, h, g, local)
        h = ACTIVATIONS[_GLU[mlp_type]](g.to(torch.float32)).to(h.dtype) * h
    else:
        act = {"relu_sq": "relu_sq", "gelu": "gelu", "relu": "relu"}.get(mlp_type, "gelu")
        h = ACTIVATIONS[act](h.to(torch.float32)).to(h.dtype)
    if ctx.mesh is not None:
        from repro_torch.nn.attention import _mesh_out_input

        h = _mesh_out_input(params["out"], ctx, f"{role_prefix}_out", h, local)
    return dense(params["out"], h, ctx, f"{role_prefix}_out")


def _same_layout(ctx: Ctx, params, prefix: str, h, g, h_local: bool):
    """The GLU's two projections in one layout: both on this rank's chunk,
    or both whole."""
    from repro_torch.launch.mesh import gather_replicated

    g_local = ctx.plan_kind(f"{prefix}_gate", params["gate"]) in MODEL_SHARDED_OUT
    if h_local == g_local:
        return h, g, h_local
    if h_local:
        h = gather_replicated(h, ctx.model_axes, ctx.mesh, -1)
    else:
        g = gather_replicated(g, ctx.model_axes, ctx.mesh, -1)
    return h, g, False
