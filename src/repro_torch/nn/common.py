"""Shared NN substrate: context object, linear sites, norms, activations, init.

Port of ``repro/nn/common.py``. Parameters are plain nested dicts of tensors
in the JAX package's layout (a linear weight is ``[d_out, d_in]``); modules
are ``init(gen, ...) -> params`` / ``apply(params, x, ctx, ...)`` pairs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.core import SketchPolicy, linear
from repro_torch.core.compact_grad import GRAD_SLOT
from repro_torch.core.plan_state import PLAN_SLOT
from repro_torch.core.policy import ROLES
from repro_torch.telemetry.probes import PROBE_SLOT

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
    mesh: Optional[Any] = None  # a launch.mesh.Mesh: run on this rank's shards
    data_axes: tuple = ("data",)
    model_axes: tuple = ("model",)
    tp_sketch: bool = False  # TP plans for the sites that take them (core/site.py)
    # under a mesh: this rank's rows are its share of the batch over the data
    # axes (False: every data rank holds the whole batch, which did not divide)
    rows_sharded: bool = True
    # the residual stream is sequence-parallel between the blocks
    # (ExecutionConfig.act_sharding; models/lm.py turns it off for a call
    # whose sequence does not divide the model axis)
    seq_parallel: bool = False
    # roles whose TP plan leaves its result partial over the model axis for a
    # sequence-parallel mover to complete (the column plans' dX, the row
    # plan's output; "moe": the MoE layer's expert sum), set per block by
    # models/lm.py
    sp_partial: frozenset = frozenset()

    @property
    def n_mp(self) -> int:
        return 1 if self.mesh is None else self.mesh.axis_size(self.model_axes)

    def heads_local(self, n_heads: int, n_kv: int) -> bool:
        """JAX's ``constrain_heads`` rule: attention heads are sharded over
        the model axis only where both the query and the kv heads divide it."""
        n = self.n_mp
        return n > 1 and n_heads % n == 0 and n_kv % n == 0

    def site_spec(self, role: str, cfg, w, *, has_bias: bool = False, x_ndim: int = 3):
        """Resolve one linear site against this context's mesh (memoized in
        core/site.py: the one dispatch the slot builders share). ``w`` may be
        a shard: its global shape counts."""
        from repro_torch.core.site import resolve_site

        shape = tuple(w.shape)
        if self.mesh is not None:
            from repro_torch.launch.sharding import global_shape

            shape = global_shape(w, self.mesh)
        return resolve_site(role, cfg, d_out=shape[0], d_in=shape[1], has_bias=has_bias,
                            x_ndim=x_ndim, mesh=self.mesh, data_axes=tuple(self.data_axes),
                            model_axes=tuple(self.model_axes), tp_sketch=self.tp_sketch)

    def exact_spec(self, role: str, w, *, has_bias: bool = False, x_ndim: int = 3):
        """The TP plan of an EXACT site under ``tp_sketch`` (no config, a
        no-op config or no key), or None: a column role whose d_out divides
        the model axis runs ``tp_exact`` (Megatron column-parallel), a row
        role whose d_in divides it ``tp_row`` with the exact backward; the
        layout GSPMD gives an exact site of TP-sharded weights in JAX, so an
        exact bucket keeps the sketched buckets' layout and its collectives
        differ from theirs only in the gradient reduction."""
        from repro_torch.core import site
        from repro_torch.launch.sharding import global_shape

        if self.mesh is None or not self.tp_sketch or x_ndim != 3 or not self.model_axes:
            return None
        n, d_in = global_shape(w, self.mesh)
        kind = None
        if role in site.TP_OUT_ROLES and n % self.n_mp == 0:
            kind = "tp_exact"
        elif role in site.TP_ROW_ROLES and d_in % self.n_mp == 0:
            kind = "tp_row"
        if kind is None:
            return None
        plan = site.ExecutionPlan(kind, self.mesh, tuple(self.data_axes), self.model_axes[0])
        return site.SiteSpec(role=role, cfg=None, plan=plan, has_bias=has_bias, d_out=n,
                             d_in=d_in)

    def plan_kind(self, role: str, params, x_ndim: int = 3) -> str:
        """The plan ``dense`` runs the site of ``params`` on: ``tp_column``
        and ``tp_exact`` give an output sharded over the model axis,
        ``tp_row`` takes an input sharded over it; ``local`` reads and gives
        whole tensors."""
        if self.mesh is None:
            return "local"
        cfg = self.cfg_for(role)
        if cfg is None or cfg.is_noop or self.key is None:
            spec = self.exact_spec(role, params["w"], x_ndim=x_ndim)
            return "local" if spec is None else spec.plan.kind
        return self.site_spec(role, cfg, params["w"], has_bias="b" in params,
                              x_ndim=x_ndim).plan.kind

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
    """Linear site; sketched iff the policy covers ``role``. A plan-carry
    site's ``"sslot"`` leaf (``core/plan_state.py``), a compact-gradient
    site's ``"gslot"`` (``core/compact_grad.py``) and a probed site's
    ``"pslot"`` (``telemetry/probes.py``) go to the site. Under a mesh the
    site runs its resolved plan on this rank's shards (:func:`_mesh_dense`)."""
    cfg = ctx.cfg_for(role)
    if ctx.mesh is not None:
        return _mesh_dense(params, x, ctx, role, cfg)
    key = ctx.site_key(role, x.device) if cfg is not None else None
    return linear(x, params["w"], params.get("b"), key=key, cfg=cfg,
                  plan_state=params.get(PLAN_SLOT), grad_slot=params.get(GRAD_SLOT),
                  probe_slot=params.get(PROBE_SLOT))


def _mesh_dense(params, x, ctx: Ctx, role: str, cfg):
    """``dense`` on this rank's shards: the resolved plan's site
    (``core/site.py``): a TP plan, or the local plan on the gathered weight."""
    from repro_torch.core import site

    w, b = params["w"], params.get("b")
    seed = ctx.site_seed(role) if cfg is not None else None
    if cfg is None or cfg.is_noop or seed is None:
        spec = ctx.exact_spec(role, w, has_bias=b is not None, x_ndim=x.dim())
        if spec is not None:
            return site.tp_site(spec, x, w, b, None, partial=role in ctx.sp_partial)
        return site.mesh_site(None, x, w, b, None, ctx.mesh, ctx.data_axes, ctx.model_axes)
    spec = ctx.site_spec(role, cfg, w, has_bias=b is not None, x_ndim=x.dim())
    slots = dict(gslot=params.get(GRAD_SLOT), pslot=params.get(PROBE_SLOT),
                 sslot=params.get(PLAN_SLOT))
    if spec.plan.is_tp:
        return site.tp_site(spec, x, w, b, seed, partial=role in ctx.sp_partial, **slots)
    return site.mesh_site(spec.cfg, x, w, b, rng.generator(seed, x.device), ctx.mesh,
                          ctx.data_axes, ctx.model_axes, compact_rows=spec.compact_rows,
                          **slots)


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
