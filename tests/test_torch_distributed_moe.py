"""The MoE layer's expert-parallel (EP) and tensor-parallel-expert (TPX)
modes and the MoE family's training under a mesh, on CPU gloo ranks,
against JAX.

The harness is ``test_torch_distributed_families.py``'s: 4 ranks spawned
once, one intra-op thread each, rank 0's results held against JAX's meshes
of 4 fake devices on the same numpy inputs. ``moe_ffn`` runs JAX's shapes
(``test_moe_ep_matches_local``: d 16, d_ff 32, top-2, a [4, 8, 16] input)
in both packages: EP with 8 experts on (2, 2), (1, 4) and (4, 1), TPX with 6
and 2 experts on (1, 4), at capacity factor 8.0 (no drops), and three cases
whose tokens drop at the published 1.25: rows over data (each data shard's
capacity from its own rows), and a batch whose rows do not divide the data
axis, its 8 tokens split over data and its 3 tokens replicated. The loss is
``sum(y * g) + 100 aux`` in both packages; on the ranks each holds its
share (``lm.lm_loss``'s convention: aux / n_dp). Tolerances: JAX's 3e-5 on
the output and aux (its ``test_moe_ep_matches_local``), and every gradient
within 1e-5 of JAX's largest entry.

Then the smoke configs of olmoe-1b-7b (8 experts, EP on both meshes) and
mixtral-8x22b (4 experts, sliding windows) through the harness's steps;
the shared expert draws of ROADMAP.md Queue 3 item 18; and an MoE state
whose experts (6) are EP on (2, 2) and TPX on (1, 4), checkpointed on the
one and restored on the other bit for bit.
"""
from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from test_torch_distributed_families import (assert_close_leaves, family_inputs, family_runs,
                                             finish, init_group, jax_mesh,
                                             jax_sharded_exact_step, lead_rank, make_meshes,
                                             np32, progress, runtime_train, spawn_ranks)

MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
ALONE_S = 15  # the rank group's time alone (spawning included; see SLOWDOWN)
FAMILY_MESHES = ("2x2", "1x4")
FAMILIES = ("olmoe_1b_7b", "mixtral_8x22b")
JAX_CASES = (("olmoe_1b_7b", "2x2"), ("olmoe_1b_7b", "1x4"), ("mixtral_8x22b", "2x2"))
D, D_FF, TOP_K, AUX_W = 16, 32, 2, 100.0
# name: (mesh, experts, capacity factor, input shape)
MOE_CASES = {
    "ep8_2x2": ("2x2", 8, 8.0, (4, 8, D)),
    "ep8_1x4": ("1x4", 8, 8.0, (4, 8, D)),
    "ep8_4x1": ("4x1", 8, 8.0, (4, 8, D)),
    "tpx6_1x4": ("1x4", 6, 8.0, (4, 8, D)),
    "tpx2_1x4": ("1x4", 2, 8.0, (4, 8, D)),
    "drop_2x2": ("2x2", 8, 1.25, (4, 8, D)),
    "split_2x2": ("2x2", 8, 1.25, (1, 8, D)),
    "replicated_2x2": ("2x2", 8, 1.25, (1, 3, D)),
}
GRAD_NAMES = ("router", "wi", "wg", "wo", "x")
CKPT_EXPERTS = 6


def _moe_cfg(pkg, E, cap):
    if pkg == "jax":
        from repro.nn.moe import MoECfg
    else:
        from repro_torch.nn.moe import MoECfg
    return MoECfg(n_experts=E, top_k=TOP_K, d_ff=D_FF, capacity_factor=cap)


# ---------------------------------------------------------------------------
# The ranks' side
# ---------------------------------------------------------------------------


def _moe_case(name, mesh, inp, out, ctx_kw=None):
    """One ``moe_ffn`` call on this rank's shards and rows, its loss's
    gradients: the output, aux and every gradient whole on rank 0."""
    from repro_torch.api import ExecutionConfig
    from repro_torch.launch import mesh as m
    from repro_torch.launch import sharding
    from repro_torch.nn.moe import moe_ffn

    _, E, cap, shape = MOE_CASES[name]
    p = inp[f"moe/{name}/params"]
    specs = {k: sharding.spec_for_path(f"/layers/0/moe/{k}", v.shape, mesh)
             for k, v in p.items() if k != "router"}
    params = {"router": {"w": p["router"].clone().requires_grad_(True)}}
    for k, spec in specs.items():
        params[k] = sharding.shard_tensor(p[k], spec, mesh).requires_grad_(True)
    n_dp = mesh.axis_size("data")
    rows_sharded = shape[0] % n_dp == 0
    x, g = inp[f"moe/{name}/x"], inp[f"moe/{name}/g"]
    if rows_sharded:
        x, g = (m.chunk_of(t, ("data",), mesh, 0) for t in (x, g))
    x = x.clone().requires_grad_(True)
    ctx = ExecutionConfig(mesh=mesh).make_ctx(rows_sharded=rows_sharded, **(ctx_kw or {}))
    y, aux = moe_ffn(params, x, ctx, _moe_cfg("torch", E, cap))
    # this rank's share of sum(y * g) + AUX_W * aux (each data rank of a
    # replicated batch holds all of it)
    share = (y * g).sum() / (1 if rows_sharded else n_dp) + AUX_W * aux / n_dp
    wants = [params["router"]["w"], params["wi"], params["wg"], params["wo"], x]
    grads = dict(zip(GRAD_NAMES, torch.autograd.grad(share, wants)))
    key = f"moe/{name}"
    # the router and a replicated batch's x: partial over data (the train
    # step sums them); the expert weights: reduced to their shards
    grads["router"] = m.psum(grads["router"], ("data",), mesh)
    for k, spec in specs.items():
        out[f"{key}/d{k}"] = np32(sharding.gather_tensor(grads[k], spec, mesh))
    if rows_sharded:
        out[f"{key}/dx"] = np32(m.all_gather(grads["x"], ("data",), mesh, axis=0))
        out[f"{key}/y"] = np32(m.all_gather(y.detach(), ("data",), mesh, axis=0))
    else:
        out[f"{key}/dx"] = np32(m.psum(grads["x"], ("data",), mesh))
        out[f"{key}/y"] = np32(y)
    out[f"{key}/drouter"] = np32(grads["router"])
    out[f"{key}/aux"] = float(aux)


def _moe_local(name, inp, out):
    """The same layer on one device (no mesh)."""
    from repro_torch.nn.common import Ctx
    from repro_torch.nn.moe import moe_ffn

    _, E, cap, _ = MOE_CASES[name]
    p = inp[f"moe/{name}/params"]
    params = {"router": {"w": p["router"]}, **{k: v for k, v in p.items() if k != "router"}}
    y, _ = moe_ffn(params, inp[f"moe/{name}/x"], Ctx(), _moe_cfg("torch", E, cap))
    out[f"moe/{name}/y_local"] = np32(y)


def _expert_seeds(meshes, out):
    """ROADMAP.md Queue 3 item 18: the seed each expert's sites fold their
    role into, by (model rank, local index), on one device and on (1, 4)
    with 8 experts (2 per rank), gathered from every rank."""
    import torch.distributed as dist

    from repro_torch.api import ExecutionConfig
    from repro_torch.launch import mesh as m
    from repro_torch.launch import sharding
    from repro_torch.nn import moe
    from repro_torch.nn.common import Ctx

    name = "ep8_1x4"
    real, seen = moe._expert_ffn, []

    def spy(wi, wg, wo, xb, ctx, ectx):
        seen.append(ectx.key)
        return real(wi, wg, wo, xb, ctx, ectx)

    _, E, cap, shape = MOE_CASES[name]
    x = torch.zeros(shape)
    p = {k: torch.zeros((E, D_FF, D) if k in ("wi", "wg") else (E, D, D_FF))
         for k in ("wi", "wg", "wo")}
    p["router"] = {"w": torch.zeros(E, D)}
    mesh = meshes["1x4"]
    shards = {k: v if k == "router" else sharding.shard_tensor(
        v, sharding.spec_for_path(f"/layers/0/moe/{k}", v.shape, mesh), mesh)
        for k, v in p.items()}
    moe._expert_ffn = spy
    try:
        moe.moe_ffn(p, x, Ctx(key=77), _moe_cfg("torch", E, cap))
        single = list(seen)
        seen.clear()
        moe.moe_ffn(shards, x, ExecutionConfig(mesh=mesh).make_ctx(key=77),
                    _moe_cfg("torch", E, cap))
    finally:
        moe._expert_ffn = real
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (m.axis_index(mesh, "model"), list(seen)))
    out["seeds/single"] = single
    out["seeds/mesh"] = got


def _ckpt(meshes, out, work, rank):
    """An MoE state (mixtral's smoke config with 6 experts, AdamW) stepped on
    (2, 2), where its experts are EP, saved by ``CheckpointManager(mesh=)``
    and restored by ``resume_on_mesh`` on (1, 4), where they are TPX: every
    parameter and moment bit for bit; then a step from the restored state
    against the single-device step from the whole state."""
    import torch.distributed as dist

    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import sharding
    from repro_torch.models import lm
    from repro_torch.nn.moe import expert_mode
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.elastic import gather_state, resume_on_mesh
    from repro_torch.tree import tree_leaves
    from test_torch_distributed_families import family_batch, one_step

    cfg = smoke_config("mixtral_8x22b").replace(n_experts=CKPT_EXPERTS)
    params = lm.init_params(3, cfg, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in family_batch(cfg, seed=1).items()}
    src, dst = meshes["2x2"], meshes["1x4"]
    out["ckpt/modes"] = (expert_mode(lm._moe_cfg(cfg), 2), expert_mode(lm._moe_cfg(cfg), 4))
    opt = adamw(1e-2)
    state, _, _ = one_step(cfg, params, batch, mesh=src, opt=opt)
    ckdir = os.path.join(work, "moe_ckpt")
    mgr = ck.CheckpointManager(ckdir, every=1, mesh=src)
    mgr.maybe_save(1, state)
    mgr.wait()
    dist.barrier()
    whole = gather_state(state, src)
    restored, step = resume_on_mesh(ckdir, whole, dst)
    back = gather_state(restored, dst)

    def leaves(st):
        return tree_leaves(st.params) + tree_leaves(st.opt_state)

    out["ckpt/restored"] = step == 1 and len(leaves(whole)) == len(leaves(back)) and all(
        torch.equal(a, b) for a, b in zip(leaves(whole), leaves(back)))
    wi = restored.params["layers"][0]["moe"]["wi"]
    out["ckpt/wi_spec"] = sharding.spec_of(wi)
    # one more step on (1, 4) (TPX) against one device, from the whole state
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.api import ExecutionConfig
    from repro_torch.train.train_step import TrainState, make_train_step

    ex = ExecutionConfig(mesh=dst)
    nxt, m1 = make_train_step(cfg, opt, None, execution=ex, device="cpu")(
        restored, shard_batch(batch, mesh=dst), 5)
    one = TrainState(params=whole.params, opt_state=whole.opt_state, step=whole.step)
    ref, m2 = make_train_step(cfg, opt, None, device="cpu")(one, batch, 5)
    from test_torch_distributed_families import flat

    out["ckpt/next/mesh"] = flat(sharding.gather_tree(nxt.params, dst))
    out["ckpt/next/single"] = flat(ref.params)
    out["ckpt/next/loss"] = (float(m1["loss"]), float(m2["loss"]))


def _worker(rank, world, store, work):
    init_group(rank, world, store)
    out = {}
    try:
        inp = torch.load(os.path.join(work, "inputs.pt"))
        meshes = make_meshes(MESHES)
        t0 = time.perf_counter()
        for name, (tag, *_rest) in MOE_CASES.items():
            progress(work, rank, f"moe_ffn/{name}")
            _moe_case(name, meshes[tag], inp, out)
            if lead_rank():
                _moe_local(name, inp, out)
        out["time/moe_ffn"] = time.perf_counter() - t0
        for name in FAMILIES:
            progress(work, rank, name)
            t0 = time.perf_counter()
            family_runs(name, inp, out, {t: meshes[t] for t in FAMILY_MESHES})
            runtime_train(name, inp, out, meshes["2x2"])
            out[f"time/{name}"] = time.perf_counter() - t0
        progress(work, rank, "expert_seeds")
        _expert_seeds(meshes, out)
        progress(work, rank, "ckpt")
        t0 = time.perf_counter()
        _ckpt(meshes, out, work, rank)
        out["time/ckpt"] = time.perf_counter() - t0
    finally:
        finish(rank, out, work)


# ---------------------------------------------------------------------------
# The test process's side
# ---------------------------------------------------------------------------


def _moe_numpy(name):
    _, E, _, shape = MOE_CASES[name]
    rs = np.random.RandomState(len(name) * 100 + E)
    p = {"router": rs.standard_normal((E, D)) * D ** -0.5,
         "wi": rs.standard_normal((E, D_FF, D)) * D ** -0.5,
         "wg": rs.standard_normal((E, D_FF, D)) * D ** -0.5,
         "wo": rs.standard_normal((E, D, D_FF)) * D_FF ** -0.5}
    x = rs.standard_normal(shape)
    g = rs.standard_normal(shape)
    return ({k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32),
            g.astype(np.float32))


@pytest.fixture(scope="module")
def inputs():
    inp = family_inputs(FAMILIES)
    for name in MOE_CASES:
        p, x, g = _moe_numpy(name)
        inp[f"moe/{name}/params"] = {k: torch.as_tensor(v) for k, v in p.items()}
        inp[f"moe/{name}/x"] = torch.as_tensor(x)
        inp[f"moe/{name}/g"] = torch.as_tensor(g)
    return inp


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn_ranks(_worker, inputs, tmp_path_factory, alone_s=ALONE_S)


def _jax_moe(name):
    """JAX's ``moe_ffn`` on the case's mesh: y, aux and the gradients of
    ``sum(y * g) + 100 aux``."""
    import jax
    import jax.numpy as jnp

    from repro.nn.common import Ctx
    from repro.nn.moe import moe_ffn

    tag, E, cap, _ = MOE_CASES[name]
    p, x, g = _moe_numpy(name)
    params = {"router": {"w": jnp.asarray(p["router"])},
              **{k: jnp.asarray(p[k]) for k in ("wi", "wg", "wo")}}
    ctx = Ctx(mesh=jax_mesh(tag), data_axes=("data",), model_axes=("model",))
    cfg = _moe_cfg("jax", E, cap)

    def loss(pp, xx):
        y, aux = moe_ffn(pp, xx, ctx, cfg)
        return jnp.sum(y * jnp.asarray(g)) + AUX_W * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    grads = {"router": gp["router"]["w"], "wi": gp["wi"], "wg": gp["wg"], "wo": gp["wo"],
             "x": gx}
    return np.asarray(y), float(aux), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_ffn_matches_jax_on_the_mesh(ranks, name):
    """EP (E 8 on (2, 2), (1, 4), (4, 1)), TPX (E 6, E 2 on (1, 4)) and the
    dropping cases against JAX's ``moe_ffn`` on the same mesh: output and
    aux within 3e-5; the gradients of router, wi, wg, wo and x, with the aux
    loss weighted 100, within 1e-5 of JAX's largest entry."""
    y, aux, grads = _jax_moe(name)
    key = f"moe/{name}"
    np.testing.assert_allclose(ranks[f"{key}/y"], y, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(ranks[f"{key}/aux"], aux, rtol=3e-5, atol=3e-5)
    for k in GRAD_NAMES:
        want = grads[k]
        np.testing.assert_allclose(ranks[f"{key}/d{k}"], want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=k)


@pytest.mark.parametrize("name", ["drop_2x2", "split_2x2"])
def test_data_shards_drop_their_own_tokens(ranks, name):
    """At capacity 1.25 each data shard fills its experts from its own rows
    (``capacity(N / n_dp)``, JAX's rule): the mesh's output is JAX's (above)
    and differs from the single-device layer's, whose capacity counts every
    row."""
    assert not np.allclose(ranks[f"moe/{name}/y"], ranks[f"moe/{name}/y_local"], atol=1e-4)


@pytest.mark.parametrize("name", ["ep8_2x2", "ep8_1x4", "ep8_4x1", "tpx6_1x4", "tpx2_1x4",
                                  "replicated_2x2"])
def test_moe_mesh_without_drops_is_the_local_layer(ranks, name):
    """Where no token drops (capacity 8.0) or every data rank holds all the
    tokens, the mesh's output is the single-device layer's (3e-5)."""
    np.testing.assert_allclose(ranks[f"moe/{name}/y"], ranks[f"moe/{name}/y_local"],
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("name,tag", JAX_CASES)
def test_moe_family_sharded_step_matches_jax(ranks, inputs, name, tag):
    """olmoe-1b-7b and mixtral-8x22b's exact mesh step against JAX's sharded
    exact step: loss rtol 1e-4; parameters rtol 2e-3, atol 2e-4."""
    want, loss = jax_sharded_exact_step(name, tag, inputs[f"{name}/batch"])
    np.testing.assert_allclose(ranks[f"{name}/{tag}/exact/loss"], loss, rtol=1e-4)
    assert_close_leaves(ranks[f"{name}/{tag}/exact/params"], want, 2e-3, 2e-4)


@pytest.mark.parametrize("run", ["exact", "exact_tp", "mask_pc"])
@pytest.mark.parametrize("tag", FAMILY_MESHES)
@pytest.mark.parametrize("name", FAMILIES)
def test_moe_family_mesh_step_matches_single_device(ranks, name, tag, run):
    """The exact, exact TP and ``per_column`` mask mesh steps (experts exact)
    against the single-device step: loss and every parameter within 1e-5;
    the aux metric is the global value, not a sum over data ranks."""
    kind = "exact" if run == "exact_tp" else run
    np.testing.assert_allclose(ranks[f"{name}/{tag}/{run}/loss"],
                               ranks[f"{name}/single/{kind}/loss"], rtol=1e-5)
    assert_close_leaves(ranks[f"{name}/{tag}/{run}/params"],
                        ranks[f"{name}/single/{kind}/params"], 1e-5, 1e-5)
    assert ranks[f"{name}/{tag}/{run}/aux"] == pytest.approx(
        ranks[f"{name}/1x4/exact/aux"], rel=1e-5)


@pytest.mark.parametrize("name", FAMILIES)
def test_moe_family_tp_sketch_step(ranks, name):
    """The compact TP step (expert sites on their local plan, as JAX's body
    runs them): its loss equals the exact TP step's, its update is finite,
    and on (2, 2) it hands the collectives fewer bytes."""
    for tag in FAMILY_MESHES:
        key = f"{name}/{tag}/compact"
        np.testing.assert_allclose(ranks[key + "/loss"], ranks[f"{name}/{tag}/exact_tp/loss"],
                                   rtol=1e-5)
        assert np.isfinite(ranks[key + "/grad_norm"])
        assert all(np.isfinite(a).all() for a in ranks[key + "/params"].values())
    assert ranks[f"{name}/2x2/compact/bytes"] < ranks[f"{name}/2x2/exact_tp/bytes"]


@pytest.mark.parametrize("name", FAMILIES)
def test_runtime_trains_the_moe_family_under_a_mesh(ranks, name):
    """``Runtime.train`` with ``ExecutionConfig(mesh=(2, 2))``: two steps
    whose losses (aux included, counted once) are the single-device run's."""
    got, want = ranks[f"{name}/train/mesh"], ranks[f"{name}/train/single"]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ep_experts_share_draws_across_model_ranks(ranks):
    """ROADMAP.md Queue 3 item 18, JAX's behaviour kept: its EP body splits
    ``fold_in(key, 1000)`` into E_loc keys (``src/repro/nn/moe.py:109``), so
    local expert j draws alike on every model rank. On (1, 4) with 8 experts
    every rank's two experts take the single device's seeds of experts 0
    and 1; one device gives its 8 experts 8 seeds."""
    single = ranks["seeds/single"]
    assert len(single) == 8 and len(set(single)) == 8
    by_rank = dict(ranks["seeds/mesh"])
    assert sorted(by_rank) == [0, 1, 2, 3]
    for seeds in by_rank.values():
        assert seeds == single[:2]


def test_moe_checkpoint_restores_across_meshes(ranks):
    """6 experts: EP on (2, 2), TPX on (1, 4). The (2, 2) AdamW state saved
    through ``CheckpointManager(mesh=)`` restores on (1, 4) bit for bit, its
    experts cut by the TPX rule (d_ff over model); a step there equals the
    single-device step from the same state (1e-5)."""
    assert ranks["ckpt/modes"] == ("ep", "tpx")
    assert ranks["ckpt/restored"] is True
    assert ranks["ckpt/wi_spec"] == (None, "model", ("data",))
    mesh_loss, single_loss = ranks["ckpt/next/loss"]
    np.testing.assert_allclose(mesh_loss, single_loss, rtol=1e-5)
    assert_close_leaves(ranks["ckpt/next/mesh"], ranks["ckpt/next/single"], 1e-5, 1e-5)


def test_whole_expert_weights_on_a_model_axis_are_refused():
    """On a model axis of several ranks the layer takes the shards the rules
    cut; whole (unmarked) expert weights are refused before any collective."""
    from repro_torch.launch.mesh import layout
    from repro_torch.nn.common import Ctx
    from repro_torch.nn.moe import moe_ffn

    p, x, _ = _moe_numpy("ep8_1x4")
    params = {"router": {"w": torch.as_tensor(p["router"])},
              **{k: torch.as_tensor(p[k]) for k in ("wi", "wg", "wo")}}
    ctx = Ctx(mesh=layout((1, 4), ("data", "model")))
    with pytest.raises(ValueError, match="this rank's shards"):
        moe_ffn(params, torch.as_tensor(x), ctx, _moe_cfg("torch", 8, 8.0))
