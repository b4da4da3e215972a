"""The compact backends (``compact``, ``pallas``, ``onepass``, ``stale``) on
local-plan sites with a model axis of several ranks, on CPU gloo ranks,
against the port's single device and JAX's mesh step.

The harness is ``test_torch_distributed_families.py``'s: 4 ranks spawned
once, one intra-op thread each, meshes (2, 2) and (1, 4) ``("data",
"model")``, ``tp_sketch`` off, so each sketched site runs the local plan:
split over model (column- or row-parallel on its stored shard,
``core/site.py``) or gathered (Mamba2's projections,
``nn.common.GATHERED_ROLES``). Three smoke configs:

* yi-6b (the dense decoder; its widths split into whole blocks of 16);
* zamba2-7b (the hybrid: Mamba2's gathered sites, the shared block split);
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
:data:`DEEP_TOL` (a second step from the perturbed parameters leaves it,
the recurrence's amplification of ROADMAP.md Queue 1 item 2b (b)).

One ``compact`` case, yi-6b on (2, 2) at budget 0.999 (every block kept:
the two packages' generators differ, so a plan that keeps every block is
the only one both draw), against JAX's sharded step with the same policy
on 4 CPU host devices, at JAX's own tolerances for its sharded step.

On (2, 2) the l1 scores are summed over the data ranks in another order
than one device sums them, so a cumulative probability next to a sampling
point could move a kept block (``test_torch_distributed_families.py``); with
blocks of 16 the plans of these configs are the single device's.
"""
from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from test_torch_distributed_families import (STEP_SEED, assert_close_leaves, clone,
                                             family_inputs, finish, flat, gather_whole,
                                             init_group, jax_mesh, lead_rank, make_meshes,
                                             progress, spawn_ranks, updated_rows)

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ALONE_S = 45  # the rank group's time alone (spawning included; see SLOWDOWN)
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
