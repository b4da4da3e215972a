"""Shared NN substrate: context object, linear sites, norms, activations, init.

Port of ``repro/nn/common.py``. Parameters are plain nested dicts of tensors
in the JAX package's layout (a linear weight is ``[d_out, d_in]``); modules
are ``init(gen, ...) -> params`` / ``apply(params, x, ctx, ...)`` pairs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.core import SketchPolicy, linear
from repro_torch.core.policy import ROLES

__all__ = ["Ctx", "dense", "dense_init", "rmsnorm", "rmsnorm_init", "layernorm",
           "layernorm_init", "ACTIVATIONS", "trunc_normal"]

_ROLE_IDS = {r: i for i, r in enumerate(ROLES)}


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through every module.

    ``key`` is the per-layer integer seed (already folded with the layer
    uid); each site folds in its role id and gets its own generator, so two
    sketched sites never share randomness. ``key=None`` means no sketching.
    """

    policy: Optional[SketchPolicy] = None
    key: Optional[int] = None
    layer_index: int = 0
    n_layers: int = 1

    def site_seed(self, role: str) -> Optional[int]:
        if self.key is None:
            return None
        return rng.fold_in(self.key, _ROLE_IDS[role])

    def site_key(self, role: str, device) -> Optional[torch.Generator]:
        """The site's own generator on ``device`` (None without a key)."""
        seed = self.site_seed(role)
        return None if seed is None else rng.generator(seed, device)

    def cfg_for(self, role: str):
        if self.policy is None:
            return None
        return self.policy.config_for(role, self.layer_index, self.n_layers)

    def for_layer(self, step_key: Optional[int], layer_index: int) -> "Ctx":
        """Child ctx for one layer of a stack (folds the seed with the uid)."""
        key = None if step_key is None else rng.fold_in(step_key, layer_index)
        return dataclasses.replace(self, key=key, layer_index=layer_index)


# Φ(-2) and Φ(2): the truncated normal samples the uniform between them
_PHI_LO = 0.5 * math.erfc(2.0 / math.sqrt(2.0))
_PHI_HI = 1.0 - _PHI_LO


def trunc_normal(gen: torch.Generator, shape, scale, dtype=torch.float32, device="cpu"):
    """Standard normal truncated to [-2, 2], times ``scale`` (inverse CDF)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    u = _PHI_LO + (_PHI_HI - _PHI_LO) * u
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (x.clamp(-2.0, 2.0) * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.float32, *, device="cpu",
               scale: float | None = None, bias: bool = False):
    w = trunc_normal(gen, (d_out, d_in), scale if scale is not None else d_in ** -0.5,
                     dtype, device)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def dense(params, x, ctx: Ctx, role: str):
    """Linear site; sketched iff the policy covers ``role``."""
    cfg = ctx.cfg_for(role)
    key = ctx.site_key(role, x.device) if cfg is not None else None
    return linear(x, params["w"], params.get("b"), key=key, cfg=cfg)


def rmsnorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"g": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["g"].to(torch.float32)).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"g": torch.ones(d, dtype=dtype, device=device),
            "b": torch.zeros(d, dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["g"].to(torch.float32) + params["b"].to(torch.float32)).to(x.dtype)


def _relu_sq(x):
    r = F.relu(x)
    return r * r


ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "silu": F.silu,
    "relu": F.relu,
    "relu_sq": _relu_sq,  # Nemotron-4 squared ReLU
    "tanh": torch.tanh,
}
