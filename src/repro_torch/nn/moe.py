"""Mixture-of-Experts FFN: token-choice top-k, capacity-bucketed, expert- or
tensor-parallel under a mesh (port of ``repro/nn/moe.py``).

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
share one.

Under a mesh (``ctx.mesh``) the layer runs JAX's ``shard_map`` body on this
rank's tensors, in one of two modes (JAX ``nn/moe.py:161-165``):

* EP, where the experts divide the model axis: this rank holds experts
  ``[e_off, e_off + E / n_mp)``, ``e_off = model rank x E / n_mp``, and runs
  their whole FFNs;
* TPX otherwise: every rank holds all experts and a ``d_ff / n_mp`` slice of
  their hidden layer (raises when ``d_ff`` does not divide either).

Tokens are this rank's rows (the residual stream is sharded over the data
axes and replicated over model), and the capacity comes from them:
``capacity(N / n_dp)``, so data shards drop tokens of their own, as in JAX.
When the rows are replicated over data (``ctx.rows_sharded`` false: the
batch did not divide the data axes) they are split over data as JAX splits
them when ``N`` divides ``n_dp``, and stay whole otherwise. The combine is a
sum over model; the router statistics ``me`` and ``disp`` are averaged over
data, so the aux loss is the global one on every rank. The expert weights'
FSDP (data) dimension is gathered (:func:`core.site.gather_fsdp`, a
reduce-scatter on the backward); their model dimension is not.

Autograd across the model axis follows ``launch/mesh.py``'s convention
(every model rank holds the full cotangent of a replicated tensor): the
tokens entering the local experts and the combine weights pass through
``launch.mesh.copy_to`` (identity; all-reduce of the partial cotangents over
model on the backward), the local output through ``reduce_from``
(all-reduce; identity backward). The router's own logits and the aux
statistics read the replicated tokens directly, so the aux loss's gradient
is counted once, not ``n_mp`` times. Over the data axes the aux statistics' backward reaches only
this rank's rows (``launch.mesh.pmean_shared``; on replicated rows that do
not split, no mean at all): ``lm.lm_loss`` adds ``aux / n_dp`` to each
rank's loss, whose gradients the train step sums. Rows split here enter
through ``launch.mesh.split_partial`` and leave through ``gather_partial``.

Expert sites run local plans (JAX's body runs with ``mesh=None``): the
configured backend on this rank's buckets, each data shard drawing from its
own bucket's scores under the shared seed. Local expert ``j`` folds ``j``
into the expert seed on every model rank, as JAX splits ``fold_in(key,
1000)`` into ``E_loc`` keys (``nn/moe.py:109``): the ranks' ``j``-th
experts draw alike (ROADMAP.md Queue 3 item 18).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.core import linear
from repro_torch.launch import mesh as meshlib
from repro_torch.nn.common import ACTIVATIONS, Ctx, dense_init, trunc_normal

__all__ = ["MoECfg", "moe_init", "moe_ffn", "capacity", "expert_mode"]

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
               n_total_experts: int, cap: int, model=None):
    """Dispatch, expert compute and combine over the experts in ``wi``/``wo``.

    x2d: [N, d]; wi: [E_loc, F, d]. ``model``: (mesh, model axes) under a
    mesh, where the experts' tokens and combine weights enter through
    ``launch.mesh.copy_to`` and the output leaves through ``reduce_from``.
    Returns (y2d [N, d], {"me", "disp"})."""
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

    xin = x2d
    if model is not None:
        mesh, mp = model
        xin, flat_w = meshlib.copy_to(x2d, mp, mesh), meshlib.copy_to(flat_w, mp, mesh)
    # each token's k replicas: a broadcast whose backward sums over k
    xrep = xin[:, None, :].expand(N, k, d).reshape(N * k, d)
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
    if model is not None:
        y = meshlib.reduce_from(y, mp, mesh)

    # Switch-style load-balance stats (fractions over all experts)
    me = probs.mean(0)  # [E] mean router probability
    disp = torch.bincount(flat_ids, minlength=n_total_experts).to(torch.float32) / (N * k)
    return y, {"me": me, "disp": disp}


def moe_ffn(params, x, ctx: Ctx, cfg: MoECfg):
    """x: [B, S, d] -> (y, aux loss scalar). Decode calls it with ``S = 1``:
    its ``N = B`` tokens get a capacity of their own, as in JAX. Under a
    mesh, the EP or TPX body on this rank's rows (module docstring)."""
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    E = cfg.n_experts
    if getattr(ctx, "mesh", None) is not None:
        y2d, me, disp = _moe_mesh(params, x2d, ctx, cfg)
    else:
        y2d, stats = _moe_local(params["router"]["w"], params["wi"], params.get("wg"),
                                params["wo"], x2d, ctx, cfg, 0, E,
                                capacity(x2d.shape[0], cfg))
        me, disp = stats["me"], stats["disp"]
    aux = E * torch.sum(me * disp) * cfg.aux_coef
    return y2d.reshape(B, S, d), aux


def expert_mode(cfg: MoECfg, n_mp: int) -> str:
    """``"ep"`` where the experts divide the model axis, else ``"tpx"``
    (raises when ``d_ff`` does not divide it either)."""
    if cfg.n_experts % n_mp == 0:
        return "ep"
    if cfg.d_ff % n_mp:
        raise ValueError(f"neither experts ({cfg.n_experts}) nor expert d_ff ({cfg.d_ff}) "
                         f"divide the model axis ({n_mp})")
    return "tpx"


def _moe_mesh(params, x2d, ctx: Ctx, cfg: MoECfg):
    """JAX's shard_map body on this rank: (y2d [N, d] this rank's rows, me,
    disp), the statistics averaged over data."""
    mesh, dp, mp = ctx.mesh, tuple(ctx.data_axes), tuple(ctx.model_axes)
    if len(mp) != 1:
        raise ValueError(f"expert parallelism uses a single model axis, got {mp}")
    n_mp = mesh.axis_size(mp)
    mode = expert_mode(cfg, n_mp)
    E = cfg.n_experts
    n_dp = mesh.axis_size(dp)
    N = x2d.shape[0]
    split = n_dp > 1 and not ctx.rows_sharded and N % n_dp == 0
    # the statistics are averaged over data unless every data rank holds the
    # same tokens (replicated rows that do not split)
    avg = n_dp > 1 and (ctx.rows_sharded or split)
    rows = meshlib.split_partial(x2d, dp, mesh) if split else x2d
    wi, wg, wo = (None if w is None else _expert_weight(w, mesh, mp, dp)
                  for w in (params["wi"], params.get("wg"), params["wo"]))
    e_off = meshlib.axis_index(mesh, mp) * (E // n_mp) if mode == "ep" else 0
    body = dataclasses.replace(ctx, mesh=None)
    y, stats = _moe_local(params["router"]["w"], wi, wg, wo, rows, body, cfg, e_off, E,
                          capacity(rows.shape[0], cfg), model=(mesh, mp))
    if split:
        y = meshlib.gather_partial(y, dp, mesh)
    me, disp = stats["me"], stats["disp"]
    if avg:
        me, disp = meshlib.pmean_shared(me, dp, mesh), meshlib.pmean_shared(disp, dp, mesh)
    return y, me, disp


def _expert_weight(w, mesh, mp, dp):
    """This rank's model shard of a stacked expert weight (as the sharding
    rules cut it: its experts under EP, its hidden slice under TPX), its
    FSDP (data) dimension gathered."""
    from repro_torch.core.site import gather_fsdp
    from repro_torch.launch.sharding import spec_of

    if mesh.axis_size(mp) > 1 and spec_of(w) is None:
        raise ValueError("under a model axis of several ranks the expert weights must be this "
                         "rank's shards (train_step.init_state, launch.sharding.shard_tree)")
    return gather_fsdp(w, mesh, dp)
