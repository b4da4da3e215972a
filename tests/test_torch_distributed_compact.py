"""The compact backends (``compact``, ``pallas``, ``onepass``, ``stale``) on
local-plan sites with a model axis of several ranks, on CPU gloo ranks,
against the port's single device and JAX's mesh step.

The harness is ``test_torch_distributed_families.py``'s: 4 ranks spawned
once, one intra-op thread each, meshes (2, 2) and (1, 4) ``("data",
"model")``, ``tp_sketch`` off, so each sketched site runs the local plan,
split over model (column- or row-parallel on its stored shard,
``core/site.py``). Three smoke configs:

* yi-6b (the dense decoder; its widths split into whole blocks of 16);
* zamba2-7b (the hybrid: Mamba2's projections split, ``in_z``/``in_x`` by
  columns and ``out`` by rows, the recurrence on each rank's heads; the
  shared block split);
* qwen2-vl-2b (d_ff 96 and d_model 48: on 4 model ranks a shard holds 24 or
  12 columns, so kept blocks of 16 straddle two shards), its untied head
  sketched too (column-parallel over the vocabulary).

Every backend at l1, budget 0.5, block 16, SGD 0.1, probes on, two steps
from the same parameters and batches as one device, whose step each is
held to:

* the same updated rows of every weight at each step (the plan), loss and
  parameters within :data:`TOL`;
* the carried scores after two steps (``onepass``, ``stale``) and the
  telemetry probe of every site within the same tolerance;
* with ``compact_grads=True``: each site's gradient slot, cut to the
  rank's rows (``localize_compact``), covers the single device's row
  indices, and its rows put together are the single device's within the
  tolerance.

zamba2's sketched sites are Mamba2's projections and the shared block, to
which the slot builders give no slot, as JAX's (``core.site.site_role``):
no carry, probe or gradient slot, so it takes one step, held to
:data:`DEEP_TOL` (a second step from the perturbed parameters leaves it:
the random-init hybrid amplifies reordered float32 sums through its
recurrence, PERF.md §7).

The float64 witness of that amplification (ROADMAP.md Queue 1 item 2b
(b)): zamba2's ``mask_pc`` step (``per_column``, mask, budget 0.5, the
families file's policy) on (2, 2) and (1, 4) and its ``mask_l1`` step on
(1, 4), with Mamba2's projections split and with them on the gathered
weight (``Ctx.split_kind`` patched to None for ``ssm_in``/``ssm_out``, the
route before the split), each against the same step on one device in
float64 (every ``torch.float32`` of the port read as float64 while it
runs; the plan's draws are the float32 ones). The split's largest
departure of the logits and of the gradients from the float64 step is at
most twice the gathered path's, and the float32 single device's departure
plus twice the gathered path's, after an SGD step of 0.1, is within
``SPLIT_WITNESS_TOL``, the bound the families file holds zamba2's split
steps to.

One ``compact`` case, yi-6b on (2, 2) at budget 0.999 (every block kept:
the two packages' generators differ, so a plan that keeps every block is
the only one both draw), against JAX's sharded step with the same policy
on 4 CPU host devices, at JAX's own tolerances for its sharded step.

On (2, 2) the l1 scores are summed over the data ranks in another order
than one device sums them, so a cumulative probability next to a sampling
point could move a kept block (``test_torch_distributed_families.py``); with
blocks of 16 the plans of these configs are the single device's.

The same rank group runs the other sketch methods on yi-6b's split and
data-sharded local plans (``METHODS``): ``gsv`` (mask, block 16), ``rcs``
(mask) and a backend registered by the ranks (``TOY``, top-r columns by the
data-summed l1 score: kept on the gathered weight by ``Ctx.split_kind``),
one SGD step each
within :data:`TOL` of the single device's; ``per_element`` and
``per_sample`` steps whose draws follow the fold rule (a spy on
``rng.fold_generator`` records each draw's generator state on every rank);
and the row plan's compact block under ``tp_sketch``, reduce-scattered and
moved to its owners against the all-reduce it replaced (the same step with
``core.site._row_scatter_axes`` forced to ``()``), dense and with compact
gradients (whose slot keeps the all-reduce), at budgets 0.75 and 0.5: the
parameters within :data:`TOL`, and the row plan's backward wire bytes
(``collective_bytes()["wire"]`` around each ``tp_row`` backward).
"""
from __future__ import annotations

import importlib
import os
import time

import numpy as np
import pytest
import torch

from test_torch_distributed_families import (SPLIT_WITNESS_TOL, STEP_SEED,
                                             assert_close_leaves, clone, family_inputs, finish,
                                             flat, gather_whole, init_group, jax_mesh,
                                             lead_rank, make_meshes, progress, spawn_ranks,
                                             updated_rows)
from test_torch_distributed_families import policy as family_policy

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ALONE_S = 65  # the rank group's time alone (spawning included; see SLOWDOWN)
FAMILIES = ("yi_6b", "zamba2_7b", "qwen2_vl_2b")
BACKENDS = ("compact", "pallas", "onepass", "stale")
CARRY = ("onepass", "stale")
BUDGET, BLOCK = 0.5, 16
# the split steps sum the same products in another order than one device
TOL = 1e-5
# zamba's random-init hybrid amplifies reordered float32 sums through its
# recurrence: test_torch_ssm.py's DEEP_TOL
DEEP_TOL = {"zamba2_7b": 5e-5}
JAX_CASE = ("yi_6b", "2x2")
JAX_BUDGET = 0.999
# the families whose sites take the slots (carry, probe, gradient slot)
SLOTTED = ("yi_6b", "qwen2_vl_2b")
# the untied head sketched too: column-parallel over the vocabulary (it takes
# no slot: the slot builders match attention and MLP sites)
HEAD_SKETCHED = ("qwen2_vl_2b",)


def policy(backend, budget=BUDGET, name=None):
    """l1 at ``budget``, block 16; on :data:`HEAD_SKETCHED` the head too."""
    from repro_torch.api import SketchConfig, SketchPolicy
    from repro_torch.core.policy import _DEFAULT_EXCLUDE

    exclude = tuple(r for r in _DEFAULT_EXCLUDE if name not in HEAD_SKETCHED or r != "lm_head")
    return SketchPolicy(base=SketchConfig(method="l1", budget=budget, backend=backend,
                                          block=BLOCK), exclude_roles=exclude)


def execution(mesh, **kw):
    from repro_torch.api import ExecutionConfig
    from repro_torch.telemetry import TelemetryConfig

    return ExecutionConfig(mesh=mesh, telemetry=TelemetryConfig(), **kw)


def steps(cfg, params, batches, backend, mesh=None):
    """An SGD step per batch: the parameters after each (whole), the
    losses, the probes of each step by site and the carries after the
    last."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.optim import sgd
    from repro_torch.train.train_step import init_state, make_train_step

    opt = sgd(0.1)
    ex = execution(mesh)
    pol = policy(backend, name=cfg.name.replace("-", "_"))
    st = init_state(0, cfg, opt, params=clone(params), device="cpu", policy=pol, execution=ex)
    step = make_train_step(cfg, opt, pol, execution=ex, device="cpu")
    res = {"params": [], "loss": [], "probes": []}
    for i, batch in enumerate(batches):
        st, m = step(st, batch if mesh is None else shard_batch(batch, mesh=mesh),
                     STEP_SEED + i)
        res["params"].append(flat(st.params) if mesh is None
                             else gather_whole(st.params, mesh))
        res["loss"].append(float(m["loss"]))
        res["probes"].append({k: v.detach().numpy().copy()
                              for k, v in m.get("probe_sites", {}).items()})
    res["carry"] = {k: v for k, v in res["params"][-1].items() if k.endswith("/sslot")}
    return res


def slot_rows(cfg, params, batch, backend, mesh=None):
    """One backward with compact gradients: every slotted weight's slot cut
    to this rank's rows, as the step cuts it (``localize_compact``), by
    path: the global row indices (rank 0: every rank's) and the dense
    gradient the rows make, whole."""
    import torch.distributed as dist

    from repro_torch.core import compact_grad as cgrad
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.sharding import dim_axes, set_spec, spec_of
    from repro_torch.models import lm
    from repro_torch.optim import sgd
    from repro_torch.train.train_step import init_state
    from repro_torch.tree import tree_leaves

    pol = policy(backend, name=cfg.name.replace("-", "_"))
    ex = execution(mesh, compact_grads=True).replace(telemetry=None)
    st = init_state(0, cfg, sgd(0.1), params=clone(params), device="cpu", execution=ex)
    p_in = cgrad.with_grad_slots(st.params, pol, n_layers=cfg.n_layers, **ex.slot_kwargs())
    ctx = ex.make_ctx(policy=pol, key=STEP_SEED, n_layers=cfg.n_layers)
    if mesh is not None:
        batch = shard_batch(batch, mesh=mesh)
    loss, _ = lm.lm_loss(p_in, batch, ctx, cfg, STEP_SEED)
    leaves = [t for t in tree_leaves(cgrad.grad_targets(p_in)) if isinstance(t, torch.Tensor)]
    torch.autograd.grad(loss, leaves, allow_unused=True)
    idx, dense = {}, {}

    def walk(node, path):
        if isinstance(node, dict):
            slot = node.get(cgrad.GRAD_SLOT)
            if slot is not None:
                w = node["w"]
                g = cgrad.CompactGrad(slot.rows, slot.idx)
                if mesh is not None:
                    g = cgrad.localize_compact({"w": g}, {"w": w})["w"]
                lo = 0
                if mesh is not None and spec_of(w) and dim_axes(spec_of(w)[0]):
                    lo = meshlib.axis_index(mesh, dim_axes(spec_of(w)[0])) * w.shape[0]
                idx[path + "/w"] = sorted((g.idx + lo).tolist())
                d = cgrad.densify(g, like=w)
                dense[path + "/w"] = d if mesh is None else set_spec(d, spec_of(w), mesh)
            for k, v in node.items():
                if k != cgrad.GRAD_SLOT:
                    walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")

    walk(p_in, "")
    if mesh is None:
        return {"idx": idx, "dense": {k: v.numpy().copy() for k, v in dense.items()}}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, idx)
    union = {k: sorted(set().union(*(e[k] for e in every))) for k in idx}
    # gather_whole joins its own "/" before each of these paths
    return {"idx": union, "dense": {k[1:]: v for k, v in gather_whole(dense, mesh).items()}}


def batches(inp, name):
    """The steps' batches: the family's, then (a slotted family) its rows
    reversed."""
    b = inp[f"{name}/batch"]
    if name not in SLOTTED:
        return [b]
    return [b, {k: v.flip(1 if k == "positions" else 0) for k, v in b.items()}]


def compact_runs(name, inp, out, meshes):
    """Every backend on each mesh, and on one device: rank ``i`` computes
    the single-device runs of backend ``i`` while the others wait in the
    gather that hands them to rank 0."""
    import torch.distributed as dist

    from repro_torch.configs.registry import smoke_config

    cfg = smoke_config(name)
    params = inp[f"{name}/params"]
    single = {}
    for i, backend in enumerate(BACKENDS):
        if i % dist.get_world_size() == dist.get_rank():
            key = f"{name}/single/{backend}"
            single[key] = steps(cfg, params, batches(inp, name), backend)
            if name in SLOTTED:
                single[key + "/slots"] = slot_rows(cfg, params, inp[f"{name}/batch"], backend)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, single)
    if lead_rank():
        for part in every:
            out.update(part)
    for backend in BACKENDS:
        for tag, mesh in meshes.items():
            key = f"{name}/{tag}/{backend}"
            out[key] = steps(cfg, params, batches(inp, name), backend, mesh)
            if name in SLOTTED:
                out[key + "/slots"] = slot_rows(cfg, params, inp[f"{name}/batch"], backend,
                                                mesh)


def jax_case_run(inp, out, meshes):
    """The port's mesh step of :data:`JAX_CASE` at :data:`JAX_BUDGET`."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.optim import sgd
    from repro_torch.train.train_step import init_state, make_train_step

    name, tag = JAX_CASE
    cfg, mesh = smoke_config(name), meshes[tag]
    ex = execution(mesh).replace(telemetry=None)
    opt = sgd(0.1)
    st = init_state(0, cfg, opt, params=clone(inp[f"{name}/params"]), device="cpu",
                    execution=ex)
    step = make_train_step(cfg, opt, policy("compact", JAX_BUDGET), execution=ex,
                           device="cpu")
    st, m = step(st, shard_batch(inp[f"{name}/batch"], mesh=mesh), STEP_SEED)
    out["jax_case/params"] = gather_whole(st.params, mesh)
    out["jax_case/loss"] = float(m["loss"])


# -- the other sketch methods on the split and data-sharded local plans ----------

METHOD_FAMILY = "yi_6b"
METHODS = ("gsv", "rcs_step", "toy", "toy_compact", "toy_carry")  # held to the single device's
# the registered copies of the compact and one-pass backends outside
# MODEL_SPLIT_BACKENDS: the gathered weight's gradient slots (compact
# gradients on) and plan carry (two steps)
TOY_COMPACT, TOY_CARRY = "toy_compact_mesh", "toy_carry_mesh"
DRAWN = ("per_element", "per_sample")  # held to the fold rule
TOY = "toy_topr_mesh"
ROW_BUDGETS = (0.75, 0.5)
# rcs's plan is a discontinuous function of its inputs: float32 sums in
# another order (the Gram over the data ranks, W Wᵀ over the d_in chunks, G
# itself from the layers above) rotate the basis ``eigh`` returns inside a
# near-degenerate eigenspace of A = Γ^½ W Wᵀ Γ^½, and move a direction's
# probability across a systematic-sampling point: the same law, other
# directions (docs/port.md, "Every sketch method on a mesh"). Every rank
# draws the same directions (``test_rcs_ranks_draw_one_plan``); the step is
# held to the single device's with rcs on the last layer (the layer below is
# exact, so the departure cannot compound) and off the sites whose A is
# rank-deficient (d_out > d_in, 128 x 64: a null space of dimension 64)
RCS_DEGENERATE = ("mlp_in", "mlp_gate")
# the second witness of that cause: the single device's step with Γ's Gram
# summed over the mesh's data chunks of the rows and W Wᵀ over its model
# chunks of d_in (``reordered_rcs_plan``), the same G and W otherwise. With
# rcs on every site it departs from the plain single device's step by as
# much as the mesh's does, within this factor either way; on ``rcs_step``'s
# sites it stays within TOL, as the mesh's does
WITNESS_FACTOR = 30


class TopR:
    """A registered backend outside ``MODEL_SPLIT_BACKENDS``: the r columns
    of largest l1 score over the whole batch (summed over ``score_psum_axes``)
    and the whole width, rescaled by n / r. Its plan mixes columns, so a
    site that a split would shard keeps the gathered weight."""

    name = TOY
    supports_compact_grad = False
    plan_carry = False
    tp_shardable = False

    def validate(self, cfg):
        pass

    def apply(self, cfg, G2d, X2d, w, gen, *, has_b, score_psum_axes=None):
        from repro_torch.core.estimators import EstimatorVJP
        from repro_torch.core.sketching import static_rank

        n = G2d.shape[1]
        r = static_rank(cfg, n)
        s = G2d.abs().sum(0)
        if score_psum_axes is not None:
            s = score_psum_axes.psum(s)
        keep = torch.zeros(n).index_fill_(0, torch.topk(s, r).indices, n / r)
        Ghat = G2d * keep[None, :]
        return EstimatorVJP(dx=Ghat @ w, dw=Ghat.T @ X2d, db=Ghat.sum(0) if has_b else None)

    def apply_with_probe(self, cfg, G2d, X2d, w, gen, *, has_b, score_psum_axes=None):
        return self.apply(cfg, G2d, X2d, w, gen, has_b=has_b, score_psum_axes=score_psum_axes)


def method_policy(kind, budget=0.5):
    from repro_torch.api import SketchConfig, SketchPolicy
    from repro_torch.core import estimators
    from repro_torch.core.policy import _DEFAULT_EXCLUDE

    # the module (``repro_torch.core`` re-exports its function of that name)
    sl = importlib.import_module("repro_torch.core.sketched_linear")

    if kind.startswith("toy"):
        name, make = {"toy": (TOY, TopR),
                      "toy_compact": (TOY_COMPACT, sl._CompactEstimator),
                      "toy_carry": (TOY_CARRY, sl._OnePassEstimator)}[kind]
        if name not in estimators.registered_backends():
            estimators.register_estimator(make(), name=name)
        block = 0 if kind == "toy" else BLOCK
        return SketchPolicy(base=SketchConfig(method="l1", budget=budget, backend=name,
                                              block=block))
    block = BLOCK if kind == "gsv" else 0
    base = SketchConfig(method=kind.split("_step")[0], budget=budget, backend="mask",
                        block=block)
    if kind == "rcs_step":
        return SketchPolicy(base=base, location="last",
                            exclude_roles=tuple(_DEFAULT_EXCLUDE) + RCS_DEGENERATE)
    return SketchPolicy(base=base)


def method_step(cfg, params, batch, pol, mesh=None, steps=1, **ex_kw):
    """``steps`` SGD steps (the batch, then its rows reversed): the
    parameters after them (whole) and the last loss."""
    from repro_torch.api import ExecutionConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.optim import sgd
    from repro_torch.train.train_step import init_state, make_train_step

    opt = sgd(0.1)
    ex = ExecutionConfig(mesh=mesh, **ex_kw) if mesh is not None else None
    st = init_state(0, cfg, opt, params=clone(params), device="cpu", execution=ex, policy=pol)
    step = make_train_step(cfg, opt, pol, execution=ex, device="cpu")
    for i, b in enumerate([batch, {k: v.flip(0) for k, v in batch.items()}][:steps]):
        st, m = step(st, b if mesh is None else shard_batch(b, mesh=mesh), STEP_SEED + i)
    params = flat(st.params) if mesh is None else gather_whole(st.params, mesh)
    return {"params": params, "loss": float(m["loss"])}


def reordered_rcs_plan(n_rows: int, n_cols: int):
    """``core.sketching.rcs_plan`` with Γ's Gram summed over ``n_rows``
    chunks of G's rows and W Wᵀ over ``n_cols`` chunks of d_in: the same
    sums in a mesh's order, on one device."""
    from repro_torch.core import sketching

    def plan(cfg, G2d, W):
        Gf, Wf = G2d.to(torch.float32), W.to(torch.float32)
        gram = sum(c.T @ c for c in Gf.chunk(n_rows, 0))
        wwt = sum(c @ c.T for c in Wf.chunk(n_cols, 1))
        return sketching.rcs_plan_from(cfg, gram / G2d.shape[0], wwt)
    return plan


def method_kw(kind) -> dict:
    """The toy copies' runs: compact gradients on, and two steps for the
    carry."""
    return {"toy_compact": {"compact_grads": True}, "toy_carry": {"steps": 2}}.get(kind, {})


def method_runs(inp, out, meshes):
    """gsv, rcs and the toy backend on one device (rank i the i-th) and on
    each mesh; per_element and per_sample on one device and each mesh with
    the fold rule's draws recorded: (tag, folds, a digest of the
    generator's state when the draw starts) in call order, every rank's."""
    import hashlib

    import torch.distributed as dist

    from repro_torch import rng
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core import sketching

    name = METHOD_FAMILY
    cfg = smoke_config(name)
    params, batch = inp[f"{name}/params"], inp[f"{name}/batch"]
    single = {}
    for i, kind in enumerate(METHODS + DRAWN + ("rcs",)):
        if i % dist.get_world_size() == dist.get_rank():
            single[f"methods/single/{kind}"] = method_step(cfg, params, batch,
                                                           method_policy(kind),
                                                           **method_kw(kind))
    real_plan = sketching.rcs_plan
    for i, (tag, kind) in enumerate((t, k) for k in ("rcs", "rcs_step") for t in meshes):
        if i % dist.get_world_size() == dist.get_rank():
            sketching.rcs_plan = reordered_rcs_plan(*MESHES[tag])
            try:
                single[f"witness/{tag}/{kind}"] = method_step(cfg, params, batch,
                                                              method_policy(kind))
            finally:
                sketching.rcs_plan = real_plan
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, single)
    if lead_rank():
        for part in every:
            out.update(part)
    for kind in METHODS:
        for tag, mesh in meshes.items():
            out[f"methods/{tag}/{kind}"] = method_step(cfg, params, batch, method_policy(kind),
                                                       mesh, **method_kw(kind))
    # the gathered weight under the sequence-parallel layout: the blocks'
    # entries and exits adapt to sites that are not split
    out["methods/2x2/toy_sp"] = method_step(cfg, params, batch, method_policy("toy"),
                                            meshes["2x2"], act_sharding=(("data",), "model", None))
    real = rng.fold_generator
    draws = []

    def spy(gen, tag, folds):
        g = real(gen, tag, folds)
        draws.append((tag, tuple(folds), hashlib.sha1(g.get_state().numpy().tobytes())
                      .hexdigest()))
        return g

    rng.fold_generator = spy
    real_apply = sketching.apply_rcs_directions

    def rcs_spy(G2d, plan, idx, **kw):
        h = hashlib.sha1()
        for t in (plan.U, plan.probs, plan.half, plan.inv_half, idx):
            h.update(t.numpy().tobytes())
        draws.append(("rcs", (), h.hexdigest()))
        return real_apply(G2d, plan, idx, **kw)

    sketching.apply_rcs_directions = rcs_spy
    try:
        for kind in DRAWN + ("rcs",):
            for tag, mesh in (("single", None),) + tuple(meshes.items()):
                draws.clear()
                res = method_step(cfg, params, batch, method_policy(kind), mesh)
                mine = {"coords": {} if mesh is None else dict(mesh.coords),
                        "draws": list(draws)}
                if mesh is not None:
                    every = [None] * dist.get_world_size()
                    dist.all_gather_object(every, mine)
                    res["ranks"] = every
                elif not lead_rank():
                    continue
                else:
                    res["ranks"] = [mine]
                out[f"methods/{tag}/{kind}"] = res
    finally:
        rng.fold_generator = real
        sketching.apply_rcs_directions = real_apply


def row_plan_runs(inp, out, meshes):
    """yi-6b's compact step under ``tp_sketch`` on (2, 2), l1 block 16, at
    each of :data:`ROW_BUDGETS`, dense and with compact gradients, with the
    row plan's block reduce-scattered and moved (``new``) and all-reduced
    (``allreduce``): the parameters, the loss and the wire bytes of the
    ``tp_row`` backwards."""
    from repro_torch.api import SketchConfig, SketchPolicy
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core import site
    from repro_torch.launch import mesh as meshlib

    name = METHOD_FAMILY
    cfg = smoke_config(name)
    params, batch = inp[f"{name}/params"], inp[f"{name}/batch"]
    mesh = meshes["2x2"]
    real_bwd, real_axes = site._tp_sketch_bwd, site._row_scatter_axes
    wire = []

    def counted(ctx, x, w_l, g):
        before = meshlib.collective_bytes()["wire"]["total"]
        outs = real_bwd(ctx, x, w_l, g)
        if ctx.spec.plan.kind == "tp_row":
            wire.append(meshlib.collective_bytes()["wire"]["total"] - before)
        return outs

    site._tp_sketch_bwd = counted
    try:
        for budget in ROW_BUDGETS:
            pol = SketchPolicy(base=SketchConfig(method="l1", budget=budget, backend="compact",
                                                 block=BLOCK))
            for version in ("new", "allreduce"):
                site._row_scatter_axes = (real_axes if version == "new"
                                          else lambda ctx, dp, d_in_loc: ())
                for compact in (False, True):
                    wire.clear()
                    res = method_step(cfg, params, batch, pol, mesh, tp_sketch=True,
                                      compact_grads=compact)
                    res["row_wire"] = list(wire)
                    out[f"row/{budget}/{version}/{'compact' if compact else 'dense'}"] = res
    finally:
        site._tp_sketch_bwd, site._row_scatter_axes = real_bwd, real_axes


# -- the float64 witness of zamba2's split Mamba2 sites ---------------------------

WITNESS_FAMILY = "zamba2_7b"
WITNESS_RUNS = (("2x2", "mask_pc"), ("1x4", "mask_pc"), ("1x4", "mask_l1"))
WITNESS_LR = 0.1  # the families file's SGD step, whose parameters it compares
# the split may sit this many times the gathered path's distance from the
# float64 step (ROADMAP.md Queue 1 item 2b (b))
WITNESS_FACTOR_SPLIT = 2.0


def capture_grads():
    """An optimizer whose update returns the step's gradients (marked as
    the parameters' shards) as the new parameters."""
    from repro_torch.launch.sharding import mark_like
    from repro_torch.optim import Optimizer

    return Optimizer(init=lambda params: {},
                     update=lambda grads, state, params, step: (mark_like(grads, params), state))


def _flat64(tree, path="") -> dict:
    """:func:`flat` in float64 (the float64 step's leaves kept whole)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat64(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat64(sub, f"{path}/{i}").items()}
    return {path: tree.detach().to(torch.float64).numpy()} if isinstance(tree, torch.Tensor) \
        else {}


def witness_step(cfg, params, batch, kind, mesh=None):
    """One step's gradients (whole, by path), its loss, and the logits of
    the forward from ``params`` (every row)."""
    import torch.distributed as dist

    from repro_torch.api import ExecutionConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models import lm
    from repro_torch.train.train_step import init_state, make_train_step

    opt = capture_grads()
    ex = None if mesh is None else ExecutionConfig(mesh=mesh)
    st = init_state(0, cfg, opt, params=clone(params), device="cpu", execution=ex)
    b = batch if mesh is None else shard_batch(batch, mesh=mesh)
    with torch.no_grad():
        logits = lm.forward(st.params, b, (ex or ExecutionConfig()).make_ctx(), cfg)
    step = make_train_step(cfg, opt, family_policy(kind), execution=ex, device="cpu")
    new, m = step(st, b, STEP_SEED)
    if mesh is None:
        return {"grads": _flat64(new.params), "loss": float(m["loss"]),
                "logits": logits.double().numpy()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mesh.coords["data"], logits.double().numpy()))
    rows = dict(every)  # one of each data rank's (equal) copies
    return {"grads": gather_whole(new.params, mesh), "loss": float(m["loss"]),
            "logits": np.concatenate([rows[i] for i in sorted(rows)], 0)}


def float64_step(cfg, params, batch, kind):
    """:func:`witness_step` on one device in float64: the parameters and
    the batch's floats in float64, and every ``torch.float32`` the port
    names read as ``torch.float64`` while it runs (its casts, buffers and
    the configs' dtype). The plan's uniforms come from ``torch.rand``'s
    default float32, so the plan is the float32 step's."""
    from repro_torch.tree import tree_map

    real = torch.float32
    p64 = tree_map(lambda t: t.double() if t.is_floating_point() else t, params)
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    torch.float32 = torch.float64
    try:
        out = witness_step(cfg, p64, b64, kind)
    finally:
        torch.float32 = real
    assert all(v.dtype == np.float64 for v in out["grads"].values())
    return out


def witness_runs(inp, out, meshes):
    """zamba2's steps of :data:`WITNESS_RUNS`: on each mesh with Mamba2's
    projections split and gathered (``Ctx.split_kind`` None for their
    roles), and on one device in float32 and float64 (rank 0 alone)."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.nn.common import Ctx

    name = WITNESS_FAMILY
    cfg = smoke_config(name)
    params, batch = inp[f"{name}/params"], inp[f"{name}/batch"]
    for kind in sorted({k for _, k in WITNESS_RUNS}) if lead_rank() else ():
        out[f"witness/single/{kind}"] = witness_step(cfg, params, batch, kind)
        out[f"witness/float64/{kind}"] = float64_step(cfg, params, batch, kind)
    real = Ctx.split_kind

    def gathered(self, role, w):
        return None if role in ("ssm_in", "ssm_out") else real(self, role, w)

    try:
        for route in ("split", "gathered"):
            Ctx.split_kind = real if route == "split" else gathered
            for tag, kind in WITNESS_RUNS:
                out[f"witness/{tag}/{kind}/{route}"] = witness_step(cfg, params, batch, kind,
                                                                    meshes[tag])
    finally:
        Ctx.split_kind = real


def _worker(rank, world, store, work):
    init_group(rank, world, store)
    out = {}
    try:
        inp = torch.load(os.path.join(work, "inputs.pt"))
        meshes = make_meshes(MESHES)
        for name in FAMILIES:
            progress(work, rank, name)
            t0 = time.perf_counter()
            compact_runs(name, inp, out, meshes)
            out[f"time/{name}"] = time.perf_counter() - t0
        progress(work, rank, "jax_case")
        jax_case_run(inp, out, meshes)
        for part in (method_runs, row_plan_runs, witness_runs):
            progress(work, rank, part.__name__)
            t0 = time.perf_counter()
            part(inp, out, meshes)
            out[f"time/{part.__name__}"] = time.perf_counter() - t0
    finally:
        finish(rank, out, work)


# ---------------------------------------------------------------------------
# The test process's side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    return family_inputs(FAMILIES)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn_ranks(_worker, inputs, tmp_path_factory, alone_s=ALONE_S)


def _tol(name):
    return DEEP_TOL.get(name, TOL)


CASES = [(n, t, b) for n in FAMILIES for t in MESHES for b in BACKENDS]
SLOT_CASES = [c for c in CASES if c[0] in SLOTTED]


@pytest.mark.parametrize("name,tag,backend", CASES)
def test_split_compact_step_is_the_single_device_step(ranks, inputs, name, tag, backend):
    """The steps on the mesh: each updates exactly the single device's rows
    of every weight (the same plan), and the losses, the parameters after
    each step and the carried scores after the last are the single
    device's within the tolerance."""
    got, want = ranks[f"{name}/{tag}/{backend}"], ranks[f"{name}/single/{backend}"]
    tol = _tol(name)
    start = flat(inputs[f"{name}/params"])
    assert len(got["params"]) == len(want["params"]) == (2 if name in SLOTTED else 1)
    for i in range(len(want["params"])):
        assert sorted(got["params"][i]) == sorted(want["params"][i])
        for k, w in want["params"][i].items():
            if w.ndim == 2:
                g0, w0 = ((start[k], start[k]) if i == 0
                          else (got["params"][0][k], want["params"][0][k]))
                np.testing.assert_array_equal(updated_rows(got["params"][i][k], g0),
                                              updated_rows(w, w0), err_msg=f"step {i}: {k}")
        assert_close_leaves(got["params"][i], want["params"][i], tol, tol)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=tol)
    if backend in CARRY and name in SLOTTED:
        assert want["carry"], "no plan-carry leaf"
        assert_close_leaves(got["carry"], want["carry"], tol, tol)
    else:
        assert not want["carry"]


@pytest.mark.parametrize("name,tag,backend", SLOT_CASES)
def test_split_compact_probes_are_the_single_device_probes(ranks, name, tag, backend):
    """The telemetry probe of every sketched site at both steps (the three
    statistics of the whole batch and width) within the tolerance of the
    single device's."""
    got, want = ranks[f"{name}/{tag}/{backend}"], ranks[f"{name}/single/{backend}"]
    tol = _tol(name)
    for i in range(2):
        assert sorted(got["probes"][i]) == sorted(want["probes"][i]) and want["probes"][i]
        for k, w in want["probes"][i].items():
            # ok: one per layer holding the site (JAX's stacked sum)
            assert w[3] >= 1.0 and got["probes"][i][k][3] == w[3], k
            np.testing.assert_allclose(got["probes"][i][k], w, rtol=tol, atol=0, err_msg=k)


@pytest.mark.parametrize("name,tag,backend", SLOT_CASES)
def test_split_compact_slots_are_the_single_device_slots(ranks, name, tag, backend):
    """With compact gradients, every slotted weight's rows, cut to each
    rank's shard, cover the single device's row indices and make its dense
    gradient within the tolerance."""
    got, want = (ranks[f"{name}/{tag}/{backend}/slots"],
                 ranks[f"{name}/single/{backend}/slots"])
    tol = _tol(name)
    assert sorted(got["idx"]) == sorted(want["idx"]) and want["idx"]
    for k in want["idx"]:
        assert got["idx"][k] == want["idx"][k], k
    assert_close_leaves(got["dense"], want["dense"], tol, tol)


def test_split_compact_step_matches_jax_mesh_step(ranks, inputs):
    """yi-6b's ``compact`` step on (2, 2) at budget 0.999 (every block kept)
    against JAX's sharded step with the same policy on 4 CPU host devices:
    loss rtol 1e-4; parameters rtol 2e-3, atol 2e-4 (JAX's own tolerances
    for its sharded step)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import compat
    from repro.core import SketchConfig as JSketchConfig
    from repro.core import SketchPolicy as JSketchPolicy
    from repro.launch import sharding as shard
    from repro.optim import sgd
    from repro.train.train_step import TrainState, make_train_step
    from repro_torch import interop
    from repro_torch.configs.registry import smoke_config
    from test_torch_distributed_families import jax_setup

    name, tag = JAX_CASE
    jcfg, state = jax_setup(name)
    mesh = jax_mesh(tag)
    pspecs = shard.param_shardings(state.params, mesh)
    sshard = TrainState(params=pspecs, opt_state={k: pspecs for k in state.opt_state},
                        step=NamedSharding(mesh, P()))
    pol = JSketchPolicy(base=JSketchConfig(method="l1", budget=JAX_BUDGET, backend="compact",
                                           block=BLOCK))
    step = make_train_step(jcfg, sgd(0.1), pol, mesh=mesh,
                           act_sharding=NamedSharding(mesh, P(("data",), None, None)),
                           data_axes=("data",), model_axes=("model",))
    batch = {k: np.asarray(v.numpy()) for k, v in inputs[f"{name}/batch"].items()}
    bspec = {k: NamedSharding(mesh, P("data", *([None] * (v.ndim - 1))))
             for k, v in batch.items()}
    step = jax.jit(step, in_shardings=(sshard, bspec, NamedSharding(mesh, P())))
    new, m = step(state, batch, compat.prng_key(STEP_SEED))
    want = flat(interop.params_from_jax(new.params, smoke_config(name), device="cpu"))
    np.testing.assert_allclose(ranks["jax_case/loss"], float(m["loss"]), rtol=1e-4)
    assert_close_leaves(ranks["jax_case/params"], want, 2e-3, 2e-4)


@pytest.mark.parametrize("kind", METHODS)
@pytest.mark.parametrize("tag", list(MESHES))
def test_split_methods_step_is_the_single_device_step(ranks, tag, kind):
    """gsv (mask, block 16), rcs (mask; on the last layer, off
    :data:`RCS_DEGENERATE`) and the registered backends (the toy; copies of
    ``compact`` with compact gradients and of ``onepass`` with its carry
    over two steps) on yi-6b's split local plans, data-sharded on (2, 2):
    the loss and parameters (the carry among them) within :data:`TOL` of
    the single device's (every rank draws the whole batch's and width's plan
    from the unfolded seed; the registered backends run on the gathered
    route)."""
    got, want = ranks[f"methods/{tag}/{kind}"], ranks[f"methods/single/{kind}"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    assert_close_leaves(got["params"], want["params"], TOL, TOL)


def test_registered_backend_gathered_route_under_the_sp_layout(ranks):
    """The toy backend on (2, 2) in the sequence-parallel layout (its sites
    on the gathered weight, so the blocks' entries gather the sequence and
    their exits slice it, as for any unsplit site): one SGD step within
    :data:`TOL` of the single device's."""
    got, want = ranks["methods/2x2/toy_sp"], ranks["methods/single/toy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    assert_close_leaves(got["params"], want["params"], TOL, TOL)


@pytest.mark.parametrize("kind", DRAWN)
@pytest.mark.parametrize("tag", list(MESHES))
def test_drawn_methods_follow_the_fold_rule(ranks, tag, kind):
    """per_element and per_sample steps on the mesh run (finite loss and
    parameters), and every draw follows the fold rule on every rank:
    per_element's W mask is folded by the model rank (every yi-6b site is
    split) and shared by the data ranks, its X mask folded by the data rank
    (where there are several) and, on a row split, by the model rank, and
    shared by the other ranks; per_sample's row gate is folded by the data
    rank alone. Ranks whose folds agree hold the same generator state;
    ranks whose folds differ hold different ones. The row gate with no
    fold (one data rank) is the single device's draw (the same state at the
    same call)."""
    from repro_torch.core.sketching import TAG_MASK_W, TAG_MASK_X, TAG_ROW_GATE

    got, single = ranks[f"methods/{tag}/{kind}"], ranks[f"methods/single/{kind}"]
    assert np.isfinite(got["loss"]) and all(np.isfinite(v).all()
                                            for v in got["params"].values())
    ranks_ = got["ranks"]
    n_calls = len(single["ranks"][0]["draws"])
    assert n_calls and all(len(r["draws"]) == n_calls for r in ranks_)
    n_dp = MESHES[tag][0]
    tags = {TAG_MASK_W, TAG_MASK_X} if kind == "per_element" else {TAG_ROW_GATE}
    for i in range(n_calls):
        calls = [(r["coords"], r["draws"][i]) for r in ranks_]
        assert {c[1][0] for c in calls} <= tags
        for coords, (t, folds, _) in calls:
            d, k = coords["data"], coords["model"]
            dfold = (d,) if n_dp > 1 else ()
            if t == TAG_MASK_W:
                assert folds == (k,), (i, coords, folds)
            elif t == TAG_ROW_GATE:
                assert folds == dfold, (i, coords, folds)
            else:
                assert folds in (dfold, dfold + (k,)), (i, coords, folds)
        for a_coords, a in calls:
            for b_coords, b in calls:
                assert (a[2] == b[2]) == (a[1] == b[1]), (i, a_coords, b_coords)
        if calls[0][1][0] == TAG_ROW_GATE and not calls[0][1][1]:
            assert calls[0][1][2] == single["ranks"][0]["draws"][i][2], i


@pytest.mark.parametrize("budget", ROW_BUDGETS)
@pytest.mark.parametrize("slots", ["dense", "compact"])
def test_row_plan_block_reduce_scattered_is_the_all_reduce_step(ranks, budget, slots):
    """The row plan's compact block reduce-scattered over the last data
    axis and moved to its owners: the dense step within :data:`TOL` of the
    all-reduce version's, its backward wire bytes below the all-reduce's
    where a data shard holds fewer rows than the plan keeps (budget 0.75 >
    1 / 2: R = 48 kept rows, 32 a shard) and no more where it holds them
    all (budget 0.5: equal). With compact gradients the slot holds every
    kept row, all-reduced as before: the same step and wire bytes."""
    new, old = (ranks[f"row/{budget}/{v}/{slots}"] for v in ("new", "allreduce"))
    np.testing.assert_allclose(new["loss"], old["loss"], rtol=TOL)
    assert_close_leaves(new["params"], old["params"], TOL, TOL)
    assert len(new["row_wire"]) == len(old["row_wire"]) > 0
    w_new, w_old = sum(new["row_wire"]), sum(old["row_wire"])
    print(f"row plan wire bytes per step, budget {budget}, {slots}: all-reduce {w_old:.0f}, "
          f"reduce-scatter + move {w_new:.0f}")
    if budget > 0.5 and slots == "dense":
        assert w_new < w_old
    else:
        assert w_new == w_old



@pytest.mark.parametrize("tag", list(MESHES))
def test_rcs_ranks_draw_one_plan(ranks, tag):
    """rcs (mask) on every sketched site of both layers: each rank's plan
    (U, the probabilities, Γ^{±1/2}) and sampled directions are bit for bit
    every other rank's at every site (the Gram summed over data and W Wᵀ
    over the d_in chunks are all-reduced, so every rank eigendecomposes
    the same bits), and the step's loss is the single device's (the
    forward is exact)."""
    got, single = ranks[f"methods/{tag}/rcs"], ranks["methods/single/rcs"]
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=TOL)
    assert all(np.isfinite(v).all() for v in got["params"].values())
    calls = [r["draws"] for r in got["ranks"]]
    n = len(single["ranks"][0]["draws"])
    assert n == 14 and all(len(c) == n for c in calls)  # 7 sites x 2 layers
    for i in range(n):
        assert len({c[i][2] for c in calls}) == 1, i


def _departure(a, b) -> float:
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max()) for k in b)


@pytest.mark.parametrize("tag", list(MESHES))
def test_rcs_departure_is_the_single_device_summed_in_the_mesh_order(ranks, tag):
    """The second witness that rcs's mesh step departs by the order of its
    float32 sums and not by a fault: the single device's step with Γ's Gram
    summed over the mesh's data chunks and W Wᵀ over its model chunks
    (``reordered_rcs_plan``). With rcs on every site, its largest parameter
    departure from the plain single device's step and the mesh's lie
    within :data:`WITNESS_FACTOR` of each other, both far above
    :data:`TOL`; on ``rcs_step``'s sites (the last layer, off
    :data:`RCS_DEGENERATE`) the reordered step stays within :data:`TOL`, as
    the mesh's does (``test_split_methods_step_is_the_single_device_step``)."""
    single = ranks["methods/single/rcs"]["params"]
    mesh = _departure(ranks[f"methods/{tag}/rcs"]["params"], single)
    witness = _departure(ranks[f"witness/{tag}/rcs"]["params"], single)
    narrowed = _departure(ranks[f"witness/{tag}/rcs_step"]["params"],
                          ranks["methods/single/rcs_step"]["params"])
    print(f"rcs on every site, {tag}: the mesh departs {mesh:.3e}, the single device "
          f"summed in its order {witness:.3e}; on rcs_step's sites the latter {narrowed:.3e}")
    assert witness > TOL and mesh > TOL
    assert witness / WITNESS_FACTOR <= mesh <= witness * WITNESS_FACTOR
    assert narrowed <= TOL


def _witness(run, ref) -> dict:
    """The largest absolute departure of ``run``'s logits, loss and
    gradients (over every leaf) from the float64 step ``ref``."""
    grads = max(float(np.abs(run["grads"][k] - ref["grads"][k]).max()) for k in ref["grads"])
    return {"logits": float(np.abs(run["logits"] - ref["logits"]).max()),
            "loss": abs(run["loss"] - ref["loss"]), "grads": grads}


@pytest.mark.parametrize("tag,kind", WITNESS_RUNS)
def test_split_mamba_departs_from_float64_within_twice_the_gathered(ranks, tag, kind):
    """zamba2's step with Mamba2's projections split departs from the
    float64 single-device step by at most twice as much as with them
    gathered (the logits and the gradients, each its largest absolute
    departure over every entry), and the float32 single device's departure
    plus twice the gathered path's, scaled by the families file's SGD step
    of 0.1, is within ``SPLIT_WITNESS_TOL``: the distance from the float32
    single device that a split step may take there."""
    ref = ranks[f"witness/float64/{kind}"]
    single = _witness(ranks[f"witness/single/{kind}"], ref)
    split, gathered = (_witness(ranks[f"witness/{tag}/{kind}/{r}"], ref)
                       for r in ("split", "gathered"))
    assert sorted(ranks[f"witness/{tag}/{kind}/split"]["grads"]) == sorted(ref["grads"])
    print(f"{tag} {kind}: departure from float64 (logits / loss / grads): single "
          + ", ".join(f"{k} {single[k]:.3e}" for k in single) + "; gathered "
          + ", ".join(f"{k} {gathered[k]:.3e}" for k in gathered) + "; split "
          + ", ".join(f"{k} {split[k]:.3e}" for k in split))
    for k in ("logits", "grads"):
        assert split[k] <= WITNESS_FACTOR_SPLIT * gathered[k], k
    assert WITNESS_LR * (single["grads"] + WITNESS_FACTOR_SPLIT * gathered["grads"]) \
        <= SPLIT_WITNESS_TOL
