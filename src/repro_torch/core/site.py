"""The sketched-site spine: one ``torch.autograd.Function`` per linear site.

Port of the local plan of ``repro/core/site.py`` (``SiteSpec``,
``resolve_site``, ``resolve_tree_site``, ``_fwd``, ``_bwd``, ``_local_bwd``,
``_pack``). The forward is a plain matmul; the backward flattens the output
gradient to ``G2d [N, n]`` and dispatches through the estimator registry. A
compact backward's rows leave in one of two ways:

* dense (the default): scattered into a freshly zeroed dense weight gradient
  (compact ``db`` into the dense bias gradient);
* compact gradients: when the site has a gradient slot (``gslot``,
  ``core/compact_grad.py``), the kept rows and their int64 indices go into
  the slot and the weight gets NO gradient from the Function (``None``): no
  dense dW is allocated or filled. ``db`` stays dense ``[n]``, as in JAX.

The site's generator is consumed only in the backward, so a forward alone
draws no random numbers.

:func:`resolve_site` is the one dispatch decision per site, memoized: the
slot builders (``with_grad_slots``, ``with_plan_state``) emit slots from the
same resolved :class:`SiteSpec` (``compact_rows``, ``carry_rows``) that the
site checks its slot against, so slot emission and the backward's dispatch
cannot drift apart.

Plan carry, as in JAX: a plan-carry site (``onepass``, ``stale``) takes its
carry leaf (``sslot``, the previous step's column scores) as one more input.
The backward samples the plan from it and returns the REFRESHED scores as
that input's gradient, so ``torch.autograd.grad`` hands them to the train
step beside the weight gradients. The forward never writes the carry; the
train step takes the refreshed scores out of the gradients and writes them
over the carry after the optimizer update (``core/plan_state.py``).

Telemetry probes, as in JAX: a probed site takes its probe slot (``pslot``, a
zero ``[PROBE_WIDTH]`` float32 tensor made per step by
``telemetry.probes.with_probe_slots``) as one more autograd input. The
forward ignores it; the backward runs the estimator's probe spelling
(``apply_with_probe``, or ``apply_with_state(..., want_probe=True)`` for a
plan-carry estimator, so the probe comes from the same sweep) and returns the
probe vector as the slot's gradient, or zeros (``ok = 0``) when the
estimator emitted none. A site can hold a ``gslot``, a ``pslot`` and an
``sslot`` at once.

Under a mesh (``launch/mesh.py``) a site runs on this rank's shards. Its
:class:`ExecutionPlan` says how, as in JAX:

* ``local``: the site gathers its weight whole (:func:`gather_param`: over
  the data axes, FSDP, and over the model axis) and runs the estimator on this
  rank's rows of the batch; the scores are summed over the data axes before
  the plan is drawn from the shared seed, so every replica draws the plan of
  the whole batch and the step equals the single-device step. The weight's
  gradient is reduce-scattered back to its shard.
* ``tp_column`` / ``tp_row`` / ``tp_exact``: JAX's ``shard_map`` bodies
  (``repro/core/site.py:420-628``) on local tensors (:class:`TPSiteFn`): the
  weight's model shard stays local; the column plan folds the site seed with
  the model rank (each shard keeps its own columns), the row plan does not
  (G is replicated over model, every shard draws the same plan); dX is
  all-reduced over model on the column plan; the compact dW block is reduced
  over the data axes: reduce-scattered along d_in where the weight's d_in is
  sharded over data (the compressed DP gradient collective), all-reduced
  otherwise and on the row plan, whose weight shards its rows over data;
  with a gradient slot the rows and their GLOBAL indices are all-gathered
  over model (the column plan) and the step keeps the rows of this rank's
  shard; db is all-reduced over data; the probe is computed in the body and
  summed as JAX sums it. As in JAX the body gathers and multiplies with
  ``torch.matmul`` (no fused kernel); on the ``pallas`` backend the plan
  runs the score kernel.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.core import estimators
from repro_torch.core.sketching import SketchConfig, effective_cfg, static_block_rank, static_rank

__all__ = ["ExecutionPlan", "SiteSpec", "resolve_site", "resolve_tree_site", "site_role",
           "sketched_site", "tp_estimator", "tp_site", "mesh_site", "gather_param", "gather_fsdp",
           "TP_OUT_ROLES", "TP_ROW_ROLES"]

# roles whose d_out (column-parallel) / d_in (row-parallel) is sharded over
# the model axis under tp_sketch
TP_OUT_ROLES = frozenset({"attn_q", "attn_k", "attn_v", "mlp_in", "mlp_gate",
                          "cross_q", "cross_k", "cross_v", "ssm_in"})
TP_ROW_ROLES = frozenset({"attn_o", "mlp_out", "ssm_out", "cross_o"})


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Where one site's backward executes (static, hashable): ``local`` |
    ``tp_column`` | ``tp_row`` | ``tp_exact``. The TP kinds run on ``mesh``
    with the batch sharded over ``data_axes`` and the weight's parallel
    dimension over ``model_axis``."""

    kind: str = "local"
    mesh: Optional[object] = None
    data_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None

    def __post_init__(self):
        if self.kind not in ("local", "tp_column", "tp_row", "tp_exact"):
            raise ValueError(f"unknown plan kind {self.kind!r}")
        if self.kind != "local" and (self.mesh is None or self.model_axis is None):
            raise ValueError(f"plan {self.kind!r} needs a mesh and model_axis")
        object.__setattr__(self, "data_axes", tuple(self.data_axes))

    @property
    def is_tp(self) -> bool:
        return self.kind != "local"


_LOCAL = ExecutionPlan()


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """One resolved sketched-linear site (static, hashable).

    ``cfg`` is the effective config: on a site that cannot take a TP plan
    under ``tp_sketch``, a compact-form backend is replaced by the dense
    mask backend, as in JAX. ``d_out``/``d_in`` are the weight's global
    dimensions.

    ``compact_rows``: the number of compact dW rows the backward emits (the
    gslot rank), or None when the weight gradient stays dense.
    ``carry_rows``: the size of the site's plan-carry leaf (sslot) for a
    plan-carry estimator, or None.
    ``probe_capable``: the backward can emit the telemetry probe (the pslot
    builder reads it).
    """

    role: str
    cfg: Optional[SketchConfig]
    plan: ExecutionPlan = _LOCAL
    has_bias: bool = False
    d_out: int = 0
    d_in: int = 0
    compact_rows: Optional[int] = None
    carry_rows: Optional[int] = None
    probe_capable: bool = False


def tp_estimator(cfg):
    """The registered estimator of ``cfg`` iff it opted into the TP plans
    (``tp_shardable``); its ``validate`` runs here too, so a config is
    accepted or rejected alike on both paths. None otherwise."""
    if cfg is None or cfg.is_noop:
        return None
    try:
        est = estimators.get_estimator(cfg.backend)
    except KeyError:
        return None
    if not getattr(est, "tp_shardable", False):
        return None
    est.validate(cfg)
    return est


def _compact_capable(backend: str) -> bool:
    try:
        return bool(estimators.get_estimator(backend).supports_compact_grad)
    except KeyError:
        return False


def _tp_column_ok(cfg, d_out, mesh, model_axes) -> bool:
    n_mp = mesh.axis_size(model_axes)
    if d_out % n_mp != 0:
        return False
    n_loc = d_out // n_mp
    if cfg.block > 1:
        return n_loc % cfg.block == 0 and static_block_rank(cfg, n_loc) >= 1
    return static_rank(cfg, n_loc) >= 1


def _tp_row_ok(d_in, mesh, model_axes) -> bool:
    return d_in % mesh.axis_size(model_axes) == 0


@lru_cache(maxsize=4096)
def _resolve(role, cfg, d_out, d_in, has_bias, x_ndim, mesh, data_axes, model_axes,
             tp_sketch) -> SiteSpec:
    from repro_torch.telemetry.probes import probe_capable

    plan = _LOCAL
    eff = cfg
    if (cfg is not None and tp_sketch and mesh is not None and x_ndim == 3
            and model_axes and tp_estimator(cfg) is not None):
        if role in TP_OUT_ROLES and _tp_column_ok(cfg, d_out, mesh, model_axes):
            plan = ExecutionPlan("tp_column", mesh, data_axes, model_axes[0])
        elif role in TP_ROW_ROLES and _tp_row_ok(d_in, mesh, model_axes):
            plan = ExecutionPlan("tp_row", mesh, data_axes, model_axes[0])
    if plan.kind == "local" and cfg is not None and tp_sketch and _compact_capable(cfg.backend):
        # a site that cannot take a TP plan (or no mesh at all): the dense
        # mask estimator, not the compact path; the slot builders see the
        # same spec, so no gradient slot is made here
        eff = dataclasses.replace(cfg, backend="mask", block=0)
    rows = carry = None
    if eff is not None and not eff.is_noop:
        try:
            est = estimators.get_estimator(eff.backend)
        except KeyError:
            est = None
        if est is not None and est.supports_compact_grad:
            if plan.kind == "tp_column":
                n_mp = mesh.axis_size(model_axes)
                rows = n_mp * est.compact_rank(eff, d_out // n_mp)
            else:  # tp_row and local emit d_out-indexed rows
                rows = est.compact_rank(eff, d_out)
        if est is not None and getattr(est, "plan_carry", False) and plan.kind == "local":
            carry = est.carry_size(eff, d_out)
    probe = True if plan.is_tp else probe_capable(eff)
    return SiteSpec(role=role, cfg=eff, plan=plan, has_bias=has_bias, d_out=d_out, d_in=d_in,
                    compact_rows=rows, carry_rows=carry, probe_capable=probe)


def resolve_site(role: str, cfg: Optional[SketchConfig], *, d_out: int, d_in: int,
                 has_bias: bool = False, x_ndim: int = 3, mesh=None, data_axes=("data",),
                 model_axes=("model",), tp_sketch: bool = False) -> SiteSpec:
    """Resolve one linear site to its :class:`SiteSpec` (memoized): the one
    dispatch decision that ``nn.common.dense`` executes and the slot
    builders read. ``d_out``/``d_in``: the weight's global dimensions."""
    return _resolve(role, cfg, int(d_out), int(d_in), bool(has_bias), int(x_ndim), mesh,
                    tuple(data_axes), tuple(model_axes), bool(tp_sketch))


def site_role(path) -> Optional[str]:
    """The role of the linear site at ``path`` in a parameter tree (attn/cross
    q|k|v|o, mlp in|gate|out), or None."""
    if len(path) < 2:
        return None
    parent, leaf = path[-2], path[-1]
    if parent in ("attn", "cross") and leaf in ("q", "k", "v", "o"):
        return f"{parent}_{leaf}"
    if parent == "mlp" and leaf in ("in", "gate", "out"):
        return f"mlp_{leaf}"
    return None


def resolve_tree_site(path, node, policy, *, n_layers: int = 1, mesh=None,
                      data_axes=("data",), model_axes=("model",),
                      tp_sketch: bool = False) -> Optional[SiteSpec]:
    """Spec for one parameter-tree node, or None if the node is not a
    sketched site. Sites are matched by path with the layer-0 config, as in
    JAX; the multi-use ``"shared"`` subtree is excluded (a weight applied more
    than once per step gets no slot). The gslot, pslot and sslot builders all
    read it; under a mesh the weight is a shard and its global shape counts."""
    role = None if "shared" in path else site_role(path)
    if role is None or not isinstance(node, dict):
        return None
    w = node.get("w")
    if not isinstance(w, torch.Tensor) or w.dim() != 2:
        return None
    cfg = policy.config_for(role, 0, n_layers)
    if cfg is None or cfg.is_noop:
        return None
    shape = tuple(w.shape)
    if mesh is not None:
        from repro_torch.launch.sharding import global_shape

        shape = global_shape(w, mesh)
    return resolve_site(role, cfg, d_out=shape[0], d_in=shape[1], has_bias="b" in node,
                        mesh=mesh, data_axes=data_axes, model_axes=model_axes,
                        tp_sketch=tp_sketch)


def _matmul(x, w, b):
    y = torch.matmul(x, w.t())
    return y + b if b is not None else y


@dataclasses.dataclass(frozen=True)
class MeshEnv:
    """A local-plan site's place on a mesh: the data axes its batch is
    sharded over and the stored spec of its weight."""

    mesh: object
    data_axes: Tuple[str, ...]
    w_spec: Optional[tuple]

    @property
    def n_dp(self) -> int:
        return self.mesh.axis_size(self.data_axes)

    def score_axes(self):
        """The axes the scores are summed over (None on one data rank, so a
        one-rank mesh runs the single-device arithmetic)."""
        from repro_torch.launch.mesh import Axes

        return Axes(self.mesh, self.data_axes) if self.n_dp > 1 else None

    def rows_to_shard(self, rows: torch.Tensor) -> torch.Tensor:
        """Compact rows ``[r, d_in]`` of this rank's batch (the weight's
        whole d_in) -> summed over the data axes, in the weight's d_in
        layout (reduce-scattered where d_in is sharded over data, the model
        chunk where it is sharded over model)."""
        from repro_torch.launch import mesh as m
        from repro_torch.launch.sharding import dim_axes

        e = dim_axes(self.w_spec[1]) if self.w_spec else ()
        dpa = tuple(a for a in e if a in self.data_axes)
        rows = (m.psum_scatter(rows, dpa, self.mesh, scatter_dimension=1) if dpa
                else m.psum(rows, self.data_axes, self.mesh))
        mpa = tuple(a for a in e if a not in self.data_axes)
        return m.chunk_of(rows, mpa, self.mesh, 1) if mpa else rows


class SketchedLinearFn(torch.autograd.Function):
    """``y = x @ w.T (+ b)`` with the estimator backward of ``cfg``; the
    gradient of ``sslot`` (when given) is the refreshed plan carry, that of
    ``pslot`` the probe vector; with a ``gslot`` the compact rows go into the
    slot and ``w`` gets no gradient.

    ``env`` (a :class:`MeshEnv`, local plan under a mesh): ``w`` is the
    gathered weight and ``x`` this rank's rows; the scores are summed over
    the data axes, the slot's rows summed and put in the weight's d_in
    layout, and the probe recomputed from the summed rows. The weight and
    bias gradients stay this rank's partial sums (:func:`gather_param`
    reduces them)."""

    @staticmethod
    def forward(ctx, x, w, b, sslot, pslot, cfg, gen, gslot, env=None):
        ctx.save_for_backward(x, w, sslot)
        ctx.cfg = cfg
        ctx.gen = gen
        ctx.gslot = gslot
        ctx.env = env
        ctx.has_b = b is not None
        ctx.want_probe = pslot is not None
        return _matmul(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w, sslot = ctx.saved_tensors
        cfg = ctx.cfg
        env = ctx.env
        n = w.shape[0]
        G2d = g.reshape(-1, n)
        X2d = x.reshape(-1, x.shape[-1])
        est = estimators.get_estimator(cfg.backend)
        want_probe = ctx.want_probe
        kw = {}
        if env is not None and env.n_dp > 1:
            kw["score_psum_axes"] = env.score_axes()
        if getattr(est, "plan_carry", False):
            # the plan comes from the carried scores (None: uniform prior);
            # the refreshed scores come back in out.state, the probe from the
            # same sweep
            out = est.apply_with_state(cfg, G2d, X2d, w, ctx.gen, sslot, has_b=ctx.has_b,
                                       want_probe=want_probe, **kw)
        elif want_probe:
            out = est.apply_with_probe(cfg, G2d, X2d, w, ctx.gen, has_b=ctx.has_b, **kw)
        else:
            out = est.apply(cfg, G2d, X2d, w, ctx.gen, has_b=ctx.has_b, **kw)
        state_ct = None
        if sslot is not None:
            # zeros when the estimator emitted no refresh, as in JAX
            state_ct = (out.state.to(sslot.dtype) if out.state is not None
                        else torch.zeros_like(sslot))
        probe_ct = None
        if want_probe:
            from repro_torch.telemetry.probes import PROBE_WIDTH, probe_from_rows

            if out.probe is not None and kw:
                # the probe squares rows: it needs the rows of the whole batch
                from repro_torch.launch.mesh import psum

                rows = out.rows if out.is_compact else out.dw
                out.probe = probe_from_rows(psum(rows, env.data_axes, env.mesh), out.probe_p)
            probe_ct = (out.probe if out.probe is not None
                        else torch.zeros(PROBE_WIDTH, dtype=torch.float32, device=g.device))
        dX = out.dx.reshape(x.shape)
        rest = (None,) * 4
        if not out.is_compact:
            if ctx.gslot is not None:
                raise RuntimeError(f"estimator {cfg.backend!r} returned a dense dW for a site "
                                   "with a gradient slot")
            db = out.db if ctx.has_b else None
            return (dX, out.dw.to(w.dtype), db, state_ct, probe_ct) + rest
        db = None
        if ctx.has_b:
            db = torch.zeros(n, dtype=g.dtype, device=g.device).index_add_(
                0, out.cols, out.db_c.to(g.dtype))
        if ctx.gslot is not None:
            # compact gradients: the rows leave through the slot; no dense dW
            rows = out.rows if env is None else env.rows_to_shard(out.rows)
            ctx.gslot.put(rows, out.cols)
            return (dX, None, db, state_ct, probe_ct) + rest
        # kept rows are distinct, so the scatter-add writes each row once
        dW = torch.zeros_like(w).index_add_(0, out.cols, out.rows.to(w.dtype))
        return (dX, dW, db, state_ct, probe_ct) + rest


def sketched_site(cfg: Optional[SketchConfig], x, w, b=None,
                  gen: Optional[torch.Generator] = None,
                  sslot: Optional[torch.Tensor] = None, gslot=None,
                  pslot: Optional[torch.Tensor] = None):
    """Run one site. No config, a no-op config or no generator give the exact
    linear under plain autograd. ``sslot``: the site's plan-carry leaf;
    ``gslot``: its :class:`~repro_torch.core.compact_grad.GradSlot`, checked
    against the site's resolved ``compact_rows``; ``pslot``: its probe slot."""
    if cfg is None or cfg.is_noop or gen is None:
        return _matmul(x, w, b)
    if gslot is not None:
        spec = resolve_site("linear", cfg, d_out=w.shape[0], d_in=w.shape[1],
                            has_bias=b is not None)
        if spec.compact_rows != gslot.r:
            raise ValueError(f"gradient slot of {gslot.r} rows on a site that resolves to "
                             f"{spec.compact_rows} compact rows ({cfg.backend!r})")
    return SketchedLinearFn.apply(x, w, b, sslot, pslot, cfg, gen, gslot)


# -- under a mesh ---------------------------------------------------------------


class _GatherParam(torch.autograd.Function):
    """The whole weight from its shard; backward: the gradient of this
    rank's rows (partial over the data axes, complete over model) back to
    the shard: reduce-scattered over the data axes along the dimension they
    shard (all-reduced when none does), this rank's chunk along a
    model-sharded dimension."""

    @staticmethod
    def forward(ctx, w, spec, mesh, data_axes):
        from repro_torch.launch.sharding import dim_axes, gather_tensor

        ctx.spec, ctx.mesh, ctx.data_axes = spec, mesh, data_axes
        out = gather_tensor(w, spec, mesh)
        # no axis of the spec has two ranks: the gather was the identity
        # (decided from the mesh, not from storage: a fake tensor's data
        # pointer is 0 whatever it holds)
        if all(mesh.axis_size(dim_axes(e)) == 1 for e in spec):
            return w.view_as(w)
        return out

    @staticmethod
    def backward(ctx, g):
        return _grad_to_shard(g, ctx.spec, ctx.mesh, ctx.data_axes), None, None, None


def _grad_to_shard(g, spec, mesh, data_axes):
    from repro_torch.launch import mesh as m
    from repro_torch.launch.sharding import dim_axes

    scattered = False
    for d, e in enumerate(spec or ()):
        axes = dim_axes(e)
        dpa = tuple(a for a in axes if a in data_axes)
        mpa = tuple(a for a in axes if a not in data_axes)
        if dpa:
            g = m.psum_scatter(g, dpa, mesh, scatter_dimension=d)
            scattered = True
        if mpa:
            g = m.chunk_of(g, mpa, mesh, d)
    if not scattered:
        g = m.psum(g, data_axes, mesh)
    return g.contiguous()


class _SumOverData(torch.autograd.Function):
    """Identity forward; backward: the sum of the ranks' partial gradients
    over the data axes (a replicated leaf a site reads whole, its bias)."""

    @staticmethod
    def forward(ctx, t, mesh, data_axes):
        ctx.mesh, ctx.data_axes = mesh, data_axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.launch.mesh import psum

        return psum(g, ctx.data_axes, ctx.mesh), None, None


def gather_param(w, mesh, data_axes):
    """The whole of a marked shard ``w`` for a site that reads it whole
    (:class:`_GatherParam`); an unmarked (replicated) leaf is summed over
    the data axes on the backward. On a one-rank mesh the collectives are
    skipped (their bytes still counted) and the values pass unchanged."""
    from repro_torch.launch.sharding import spec_of

    spec = spec_of(w)
    if spec is None:
        return _SumOverData.apply(w, mesh, tuple(data_axes))
    return _GatherParam.apply(w, spec, mesh, tuple(data_axes))


def gather_fsdp(w, mesh, data_axes):
    """A marked shard gathered over the data axes only (its FSDP
    dimension), its model-sharded dimensions left as they are: the stacked
    expert weights of an expert- or tensor-parallel MoE layer
    (``nn/moe.py``), of any rank. Backward: the gradient reduce-scattered
    over the data axes (all-reduced where no dimension shards over them).
    An unmarked leaf is summed over the data axes on the backward."""
    from repro_torch.launch.sharding import dim_axes, spec_of

    data_axes = tuple(data_axes)
    spec = spec_of(w)
    if spec is not None:
        spec = tuple(tuple(a for a in dim_axes(e) if a in data_axes) or None for e in spec)
    if spec is None or all(e is None for e in spec):
        return _SumOverData.apply(w, mesh, data_axes)
    return _GatherParam.apply(w, spec, mesh, data_axes)


def _gather_model(w, mesh, data_axes):
    """The whole of a shard sharded over model only (gathered along each
    such dimension; backward: this rank's chunk, no sum over data)."""
    from repro_torch.launch.mesh import gather_replicated
    from repro_torch.launch.sharding import dim_axes, spec_of

    for d, e in enumerate(spec_of(w) or ()):
        axes = dim_axes(e)
        if any(a in data_axes for a in axes):
            raise ValueError(f"a weight sharded over the data axes ({spec_of(w)}) needs its "
                             "gradient summed over them: gather it with gather_param")
        if axes:
            w = gather_replicated(w, axes, mesh, d)
    return w


def mesh_site(cfg, x, w, b, gen, mesh, data_axes, model_axes, *, sslot=None, gslot=None,
              pslot=None, compact_rows=None, reduce_grad=True):
    """A local-plan site under a mesh: the weight gathered whole, this rank's
    rows of the batch, the single-device numbers (module docstring). Exact
    (``cfg`` None or no generator) through plain autograd on the gathered
    weight. A sketched site on a model axis of several ranks runs the
    ``mask`` backend only (or raises). ``reduce_grad=False`` (a tied head's
    table, sharded over model only): the weight is gathered over model and
    its gradient left this rank's partial sum over data, for the train step
    to sum with the table's other uses."""
    from repro_torch.launch.sharding import spec_of

    wf = gather_param(w, mesh, data_axes) if reduce_grad else _gather_model(w, mesh,
                                                                            data_axes)
    bf = None if b is None else _SumOverData.apply(b, mesh, tuple(data_axes))
    if cfg is None or cfg.is_noop or gen is None:
        return _matmul(x, wf, bf)
    if (mesh.axis_size(model_axes) > 1 and cfg.backend != "mask"):
        raise NotImplementedError(
            f"backend {cfg.backend!r} on a local-plan site with a model axis of "
            f"{mesh.axis_size(model_axes)} ranks is not ported (ROADMAP.md, Queue 1 "
            "item 2b): use tp_sketch=True, the mask backend, or a data-only mesh")
    if gslot is not None and compact_rows != gslot.r:
        raise ValueError(f"gradient slot of {gslot.r} rows on a site that resolves to "
                         f"{compact_rows} compact rows ({cfg.backend!r})")
    env = MeshEnv(mesh, tuple(data_axes), spec_of(w))
    return SketchedLinearFn.apply(x, wf, bf, sslot, pslot, cfg, gen, gslot, env)


def _gather_compact(lcfg, G2d, w_l, idx, scales):
    """The kept G columns (rescaled) and W rows of a plan; block plans gather
    whole blocks. Returns (Gc, Wc, per-column indices)."""
    if lcfg.block > 1:
        from repro_torch.core.sketched_linear import block_cols

        bs = lcfg.block
        nb = G2d.shape[-1] // bs
        Gc = (G2d.reshape(-1, nb, bs)[:, idx] * scales[None, :, None].to(G2d.dtype)
              ).reshape(G2d.shape[0], -1)
        Wc = w_l.reshape(nb, bs, -1)[idx].reshape(-1, w_l.shape[-1])
        return Gc, Wc, block_cols(idx, bs)
    Gc = G2d[:, idx] * scales[None, :].to(G2d.dtype)
    return Gc, w_l[idx], idx


def _plan_via_registry(est, lcfg, G2d, w_l, gen, score_axes):
    plan = est.plan(lcfg, G2d, w_l, gen, want_compact=True, score_psum_axes=score_axes)
    if plan is None or plan.indices is None:
        raise ValueError(
            f"estimator {est.name!r} is tp_shardable but plan() returned no compact "
            "ColumnPlan: the TP backward needs indices and scales")
    return plan


class TPSiteFn(torch.autograd.Function):
    """One site on a TP plan (``tp_column``, ``tp_row``, ``tp_exact``): JAX's
    shard_map bodies on this rank's tensors. Inputs: ``x`` this rank's rows
    (the column and exact plans: the whole d_in, replicated over model; the
    row plan: d_in's model chunk), ``w`` the stored shard, ``b`` the whole
    bias (replicated)."""

    @staticmethod
    def forward(ctx, x, w, b, pslot, spec, seed, gslot, partial=False):
        from repro_torch.launch import mesh as m
        from repro_torch.launch.sharding import dim_axes, spec_of

        plan = spec.plan
        mesh, dp, mp = plan.mesh, plan.data_axes, plan.model_axis
        wspec = spec_of(w) or (None, None)
        column = plan.kind != "tp_row"
        # the weight's model shard stays; its FSDP dimension (d_in for the
        # column and exact plans, d_out for the row plan) is gathered
        fsdp = 1 if column else 0
        leave_partial = partial is True  # a Python flag, never a tensor
        w_l = m.all_gather(w, dim_axes(wspec[fsdp]), mesh, axis=fsdp)
        y = torch.matmul(x, w_l.t())
        if column:
            if b is not None:
                y = y + m.chunk_of(b, mp, mesh, 0)
        elif leave_partial:
            # this rank's partial sum, which a sequence-parallel mover
            # reduce-scatters; the bias joins one rank's part
            if b is not None and m.axis_index(mesh, mp) == 0:
                y = y + b
        else:
            y = m.psum(y, mp, mesh)
            if b is not None:
                y = y + b
        ctx.save_for_backward(x, w_l)
        ctx.partial = leave_partial
        ctx.spec, ctx.seed, ctx.gslot, ctx.wspec = spec, seed, gslot, wspec
        ctx.has_b, ctx.want_probe = b is not None, pslot is not None
        ctx.w_shape, ctx.w_dtype = tuple(w.shape), w.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, w_l = ctx.saved_tensors
        spec = ctx.spec
        if spec.plan.kind == "tp_exact":
            outs = _tp_exact_bwd(ctx, x, w_l, g)
        elif spec.cfg is None:
            outs = _tp_row_exact_bwd(ctx, x, w_l, g)
        else:
            outs = _tp_sketch_bwd(ctx, x, w_l, g)
        return outs + (None, None, None, None)


def _din_scatter_axes(ctx, data_axes):
    from repro_torch.launch.sharding import dim_axes

    return tuple(a for a in dim_axes(ctx.wspec[1]) if a in data_axes)


def _tp_exact_bwd(ctx, x, w_l, g):
    """Megatron column-parallel EXACT backward (the vocabulary head)."""
    from repro_torch.launch import mesh as m

    plan = ctx.spec.plan
    mesh, dp, mp = plan.mesh, plan.data_axes, plan.model_axis
    G2d = g.reshape(-1, g.shape[-1])
    X2d = x.reshape(-1, x.shape[-1])
    dx = torch.matmul(g, w_l)
    if not ctx.partial:
        dx = m.psum(dx, mp, mesh)
    dW = G2d.t().to(torch.float32) @ X2d.to(torch.float32)
    sc = _din_scatter_axes(ctx, dp)
    dW = (m.psum_scatter(dW, sc, mesh, scatter_dimension=1) if sc
          else m.psum(dW, dp, mesh))
    db = None
    if ctx.has_b:
        db = m.all_gather(m.psum(G2d.sum(0), dp, mesh), mp, mesh, axis=0)
    probe = None
    if ctx.want_probe:
        from repro_torch.telemetry.probes import PROBE_WIDTH

        probe = torch.zeros(PROBE_WIDTH, dtype=torch.float32, device=g.device)
    return dx, dW.to(ctx.w_dtype), db, probe


def _tp_row_exact_bwd(ctx, x, w_l, g):
    """Megatron row-parallel EXACT backward (an exact site under tp_sketch):
    dX stays local; the dense dW is reduce-scattered over the data axes
    along the rows the weight shards over them."""
    from repro_torch.launch import mesh as m
    from repro_torch.launch.sharding import dim_axes

    plan = ctx.spec.plan
    mesh, dp = plan.mesh, plan.data_axes
    G2d = g.reshape(-1, g.shape[-1])
    X2d = x.reshape(-1, x.shape[-1])
    dx = torch.matmul(g, w_l)
    dW = G2d.t().to(torch.float32) @ X2d.to(torch.float32)
    sc = tuple(a for a in dim_axes(ctx.wspec[0]) if a in dp)
    dW = m.psum_scatter(dW, sc, mesh, scatter_dimension=0) if sc else m.psum(dW, dp, mesh)
    db = m.psum(G2d.sum(0), dp, mesh) if ctx.has_b else None
    probe = None
    if ctx.want_probe:
        from repro_torch.telemetry.probes import PROBE_WIDTH

        probe = torch.zeros(PROBE_WIDTH, dtype=torch.float32, device=g.device)
    return dx, dW.to(ctx.w_dtype), db, probe


def _tp_sketch_bwd(ctx, x, w_l, g):
    from repro_torch.launch import mesh as m
    from repro_torch.launch.mesh import Axes
    from repro_torch.launch.sharding import dim_axes

    spec = ctx.spec
    plan = spec.plan
    mesh, dp, mp = plan.mesh, plan.data_axes, plan.model_axis
    column = plan.kind == "tp_column"
    cfg = spec.cfg
    est = tp_estimator(cfg)
    if est is None:
        raise RuntimeError("TP sketched site on a non-tp_shardable backend")
    # column: each model shard samples its own columns (the seed folded with
    # the model rank); row: G is replicated over model, so every shard draws
    # the same plan and dX stays local. Data replicas share the seed and sum
    # their scores: every replica draws the same plan.
    mi = m.axis_index(mesh, mp)
    seed = rng.fold_in(ctx.seed, mi) if column else ctx.seed
    gen = rng.generator(seed, g.device)
    G2d = g.reshape(-1, g.shape[-1])
    X2d = x.reshape(-1, x.shape[-1])
    n_loc = G2d.shape[-1]
    lcfg = effective_cfg(cfg, n_loc)
    cplan = _plan_via_registry(est, lcfg, G2d, w_l, gen, Axes(mesh, dp))
    Gc, Wc, idx = _gather_compact(lcfg, G2d, w_l, cplan.indices, cplan.scales)
    dx = torch.matmul(Gc, Wc).reshape(x.shape)
    if column and not ctx.partial:
        dx = m.psum(dx, mp, mesh)  # the standard TP backward all-reduce
    dWc = Gc.t().to(torch.float32) @ X2d.to(torch.float32)
    # the compressed DP gradient collective: the COMPACT block (about budget
    # x the dense volume) reduced over the data axes; reduce-scattered along
    # d_in where the weight shards d_in over them. The row plan's weight
    # shards its ROWS over data, so its block is all-reduced and each rank
    # keeps the rows it holds.
    sc = _din_scatter_axes(ctx, dp) if column else ()
    dWc = m.psum_scatter(dWc, sc, mesh, scatter_dimension=1) if sc else m.psum(dWc, dp, mesh)
    dw = None
    if ctx.gslot is not None:
        if column:
            gidx = mi * n_loc + idx
            ctx.gslot.put(m.all_gather(dWc, mp, mesh, axis=0), m.all_gather(gidx, mp, mesh))
        else:
            ctx.gslot.put(dWc, idx)
    elif column:
        dw = torch.zeros(ctx.w_shape, dtype=ctx.w_dtype, device=g.device).index_add_(
            0, idx, dWc.to(ctx.w_dtype))
    else:
        lo = m.axis_index(mesh, dim_axes(ctx.wspec[0])) * ctx.w_shape[0]
        dw = _rows_into_shard(dWc, idx, lo, ctx.w_shape, spec.d_out, ctx.w_dtype)
    db = None
    if ctx.has_b:
        # db from the same kept-column stream: unbiased, E[Ĝ | G] = G
        db = torch.zeros(n_loc, dtype=g.dtype, device=g.device).index_add_(
            0, idx, Gc.sum(0).to(g.dtype))
        db = m.psum(db, dp, mesh)
        if column:
            db = m.all_gather(db, mp, mesh)
    probe = None
    if ctx.want_probe:
        # ||row_j||^2 over the whole d_in (summed over the axes that shard it
        # here), then the three statistics; summed over model on the column
        # plan, where each shard kept its own columns
        rs = (dWc * dWc).sum(-1)
        rs_axes = (() if column else (mp,)) + sc
        if rs_axes:
            rs = m.psum(rs, rs_axes, mesh)
        p = cplan.probs[idx].to(torch.float32)
        v3 = rs @ torch.stack([p, 1.0 - p, torch.ones_like(p)], dim=-1)
        if column:
            v3 = m.psum(v3, mp, mesh)
        probe = torch.cat([v3, torch.ones(1, dtype=torch.float32, device=g.device)])
    return dx, dw, db, probe


def _rows_into_shard(rows, idx, lo: int, shape, total: int, dtype):
    """The dense gradient of a shard holding rows ``[lo, lo + shape[0])``
    of ``total``: each row of ``rows`` whose global index ``idx`` lies in
    the shard added at ``idx - lo``, the others dropped (JAX's scatter of
    out-of-range indices). Static shapes: the dropped rows land on one
    extra row past the shard, which is cut off, so the number of rows a
    shard keeps never sizes a tensor."""
    size = shape[0]
    if lo == 0 and size == total:
        return torch.zeros(shape, dtype=dtype, device=rows.device).index_add_(
            0, idx, rows.to(dtype))
    li = torch.where((idx >= lo) & (idx < lo + size), idx - lo, size)
    buf = torch.zeros((size + 1,) + tuple(shape[1:]), dtype=dtype, device=rows.device)
    return buf.index_add_(0, li, rows.to(dtype))[:size]


def tp_site(spec: SiteSpec, x, w, b, seed, *, gslot=None, pslot=None, sslot=None,
            partial: bool = False):
    """Run one site on its TP plan (``spec.cfg`` None: the exact backward of
    the plan's layout). ``seed``: the site's integer seed.
    ``sslot`` is not read: a plan-carry estimator is never TP-shardable.
    ``partial`` (the sequence-parallel layout's blocks, ``models/lm.py``):
    the column plans leave dX this rank's partial sum and the row plan its
    output, for the block's mover to reduce-scatter, where the fixed layout
    all-reduces them here."""
    if spec.cfg is not None and tp_estimator(spec.cfg) is None:
        raise RuntimeError("TP sketched site on a non-tp_shardable backend")
    if gslot is not None and spec.compact_rows != gslot.r:
        raise ValueError(f"gradient slot of {gslot.r} rows on a site that resolves to "
                         f"{spec.compact_rows} compact rows")
    return TPSiteFn.apply(x, w, b, pslot, spec, seed, gslot, partial)
