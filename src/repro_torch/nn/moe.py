"""Mixture-of-Experts FFN: token-choice top-k, capacity-bucketed (port of the
local mode of ``repro/nn/moe.py``).

Dispatch is sort-based, as in JAX: the ``N·top_k`` token replicas are ranked
within their expert by a stable argsort, and the first ``capacity`` of each
expert (FIFO) are scattered into an ``[E, C, d]`` bucket buffer; the others
go to one overflow slot and are dropped. Each expert runs its (sketched) GLU
FFN on its bucket, and the outputs are combined back with the renormalised
router weights. The aux loss is Switch-style: ``E · Σ(me · disp) · aux_coef``.

Expert weights are stacked ``[E, F, d]`` (``wi``, ``wg``) and ``[E, d, F]``
(``wo``), ``[d_out, d_in]`` per expert like every linear weight; the router
is float32 and exact. Each expert's three linears are sketched sites of
their own (roles ``expert_in``, ``expert_gate``, ``expert_out``), run through
``core.linear`` and not ``nn.common.dense``, as in JAX: they take no
gradient, probe or carry slot, so ``onepass`` and ``stale`` sample them from
the uniform prior every step.

JAX vmaps the expert FFN, which batches its kernels over the experts in one
launch; the port loops over the experts, so each sketched expert site
launches its kernels once. Seeds keep JAX's structure (layer key, then 1000,
then the expert, then the role), not its bits: expert ``e``'s sites fold
``1000`` and ``e`` into the layer seed before the role id, so no two sites
share one. The expert-parallel mode needs a mesh, which the port does not
have yet.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.core import linear
from repro_torch.nn.common import ACTIVATIONS, Ctx, dense_init, trunc_normal

__all__ = ["MoECfg", "moe_init", "moe_ffn", "capacity"]

_EXPERT_FOLD = 1000  # JAX's fold_in(layer_key, 1000) before the expert split


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    mlp_type: str = "swiglu"
    aux_coef: float = 0.01


def moe_init(gen, d_model: int, cfg: MoECfg, dtype=torch.float32, device="cpu"):
    """The float32 router and the stacked expert weights."""
    E, F_ = cfg.n_experts, cfg.d_ff
    p = {"router": dense_init(gen, d_model, E, torch.float32, device=device),
         "wi": trunc_normal(gen, (E, F_, d_model), d_model ** -0.5, dtype, device),
         "wo": trunc_normal(gen, (E, d_model, F_), F_ ** -0.5, dtype, device)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["wg"] = trunc_normal(gen, (E, F_, d_model), d_model ** -0.5, dtype, device)
    return p


def capacity(n_tokens: int, cfg: MoECfg) -> int:
    """Bucket rows per expert: ``ceil(N · top_k · capacity_factor / E)``, at least 1."""
    return max(1, -(-int(n_tokens * cfg.top_k * cfg.capacity_factor) // cfg.n_experts))


def _expert_ffn(wi, wg, wo, xb, ctx: Ctx, ectx: Ctx):
    """One expert's FFN on its [C, d] bucket; ``ectx`` carries the expert's
    seed (the role is folded in per site)."""

    def site(x, w, role):
        cfg = ctx.cfg_for(role)
        key = ectx.site_key(role, x.device) if cfg is not None else None
        return linear(x, w, key=key, cfg=cfg)

    h = site(xb, wi, "expert_in")
    if wg is not None:
        g = site(xb, wg, "expert_gate")
        h = F.silu(g.to(torch.float32)).to(h.dtype) * h
    else:
        h = ACTIVATIONS["gelu"](h.to(torch.float32)).to(h.dtype)
    return site(h, wo, "expert_out")


def _moe_local(router_w, wi, wg, wo, x2d, ctx: Ctx, cfg: MoECfg, e_offset: int,
               n_total_experts: int, cap: int):
    """Dispatch, expert compute and combine over the experts in ``wi``/``wo``.

    x2d: [N, d]; wi: [E_loc, F, d]. Returns (y2d [N, d], {"me", "disp"})."""
    N, d = x2d.shape
    E_loc = wi.shape[0]
    k = cfg.top_k
    dev = x2d.device
    logits = x2d.to(torch.float32) @ router_w.to(torch.float32).t()  # [N, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, k, dim=-1)  # [N, k], descending
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)  # renorm (Mixtral)

    flat_ids = top_ids.reshape(-1)  # [N*k], replica j of token i at i*k + j
    flat_w = top_w.reshape(-1)
    # rank of each replica within its expert (stable sort: FIFO capacity)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    starts = torch.searchsorted(sorted_ids, torch.arange(n_total_experts, device=dev))
    ranks_sorted = torch.arange(N * k, device=dev) - starts[sorted_ids]
    ranks = torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)

    local_e = flat_ids - e_offset
    keep = (local_e >= 0) & (local_e < E_loc) & (ranks < cap)
    slot = torch.where(keep, local_e * cap + ranks, E_loc * cap)  # overflow slot

    # each token's k replicas: a broadcast whose backward sums over k
    xrep = x2d[:, None, :].expand(N, k, d).reshape(N * k, d)
    buf = torch.zeros(E_loc * cap + 1, d, dtype=x2d.dtype, device=dev).index_add(0, slot, xrep)
    xe = buf[:-1].reshape(E_loc, cap, d)

    ekey = None if ctx.key is None else rng.fold_in(ctx.key, _EXPERT_FOLD)
    wgs = wg.unbind(0) if wg is not None else (None,) * E_loc
    ye = torch.stack([
        _expert_ffn(wi_e, wg_e, wo_e, xb, ctx,
                    dataclasses.replace(ctx, key=None if ekey is None else rng.fold_in(ekey, e)))
        for e, (wi_e, wg_e, wo_e, xb) in enumerate(zip(wi.unbind(0), wgs, wo.unbind(0),
                                                        xe.unbind(0)))])

    ye_flat = torch.cat([ye.reshape(E_loc * cap, d), ye.new_zeros(1, d)], dim=0)
    rows = ye_flat[slot] * torch.where(keep, flat_w, 0.0)[:, None].to(ye.dtype)
    # the k replicas of token i are rows i*k .. i*k + k - 1
    y = rows.reshape(N, k, d).sum(1)

    # Switch-style load-balance stats (fractions over all experts)
    me = probs.mean(0)  # [E] mean router probability
    disp = torch.bincount(flat_ids, minlength=n_total_experts).to(torch.float32) / (N * k)
    return y, {"me": me, "disp": disp}


def moe_ffn(params, x, ctx: Ctx, cfg: MoECfg):
    """x: [B, S, d] -> (y, aux loss scalar). Decode calls it with ``S = 1``:
    its ``N = B`` tokens get a capacity of their own, as in JAX."""
    if getattr(ctx, "mesh", None) is not None:
        raise NotImplementedError("expert parallelism needs a mesh, which repro_torch has not "
                                  "ported yet")
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    E = cfg.n_experts
    y2d, stats = _moe_local(params["router"]["w"], params["wi"], params.get("wg"),
                            params["wo"], x2d, ctx, cfg, 0, E, capacity(x2d.shape[0], cfg))
    aux = E * torch.sum(stats["me"] * stats["disp"]) * cfg.aux_coef
    return y2d.reshape(B, S, d), aux
