"""Every model family's training under a mesh, on CPU gloo ranks, against
JAX's sharded step and the port's single device.

One module fixture spawns 4 ranks once (a ``file://`` store under
``tmp_path``, one intra-op thread per rank) through the gloo files' shared
harness (:func:`spawn_ranks`: one rank group at a time, a deadline from the
group's time alone, a time-out naming each rank's part); each rank runs the smoke configs of gemma3-1b (tied embeddings, the 5
local : 1 global plan), rwkv6-3b, zamba2-7b (Mamba2 with its shared block),
qwen2-vl-2b (M-RoPE over stub embeddings, 6:2 heads that do not divide 4
ranks) and seamless-m4t-large-v2 (the encoder-decoder) on the meshes (2, 2)
and (1, 4) ``("data", "model")``, and rank 0 saves what they produced.
The MoE family, with its expert-parallel layer, is
``test_torch_distributed_moe.py``, which imports this module's harness.

The port's weights are JAX's (``interop.params_from_jax`` of its
``init_state``), the batch the same numpy arrays in both packages; JAX runs
with ``remat="none"`` (the same function, a shorter compile). Tolerances:
JAX's own for its sharded step (loss rtol 1e-4, parameters rtol 2e-3 / atol
2e-4) and 1e-5 against the port's single device.

The ``mask`` comparison with one device: ``per_column`` plans, whose
probabilities do not read the gradient, on both meshes, and ``l1`` plans on
(1, 4), where the ranks hold the whole batch and the step's numbers are the
single device's bit for bit. On (2, 2) the ``l1`` scores are summed over
the data ranks in another order than one device sums them, and systematic
sampling turns a last-bit difference of a cumulative probability next to a
sampling point into another kept column (a tie, not a fault), so ``l1`` is
not compared there.
"""
from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
ALONE_S = 65  # the rank group's time alone (spawning included; see SLOWDOWN)
STEP_SEED = 2
B, S, S_ENC = 8, 16, 12
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
FAMILIES = ("gemma3_1b", "rwkv6_3b", "zamba2_7b", "qwen2_vl_2b", "seamless_m4t_large_v2")
# (family, mesh) pairs held to JAX's sharded exact step
JAX_CASES = tuple((n, "2x2") for n in FAMILIES) + (("zamba2_7b", "1x4"),)
# the sequence-parallel layout (act_sharding (dp, "model", None)): the dense
# decoder, one MoE, one SSM (the hybrid's Mamba2 layers) and the
# encoder-decoder, against the fixed layout and JAX's sp=True sharded step
SP_FAMILIES = ("yi_6b", "olmoe_1b_7b", "zamba2_7b", "seamless_m4t_large_v2")
# the sequence-parallel step against the fixed layout and JAX's sp=True step:
# loss and every parameter within rtol / atol 1e-5 (the layouts sum the same
# partial products in another order: the reduce-scatter over model where the
# fixed layout all-reduces)
SP_RTOL = 1e-5
EXPERT_ROLES = ("expert_in", "expert_gate", "expert_out")


# ---------------------------------------------------------------------------
# The harness (shared with test_torch_distributed_moe.py)
# ---------------------------------------------------------------------------


def family_batch(cfg, seed=0) -> dict:
    """The numpy batch of a smoke config: tokens (or the VLM's embeddings and
    [3, B, S] positions whose three streams differ), labels, and an
    encoder-decoder's source frames."""
    rs = np.random.RandomState(seed)
    b = {"labels": rs.randint(0, cfg.vocab, (B, S)).astype(np.int64)}
    if cfg.frontend == "vision":
        b["embeds"] = (rs.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
        t = np.arange(S)
        b["positions"] = np.stack([np.broadcast_to(s, (B, S)) for s in (t, t // 4, t % 4)]
                                  ).astype(np.int64)
    else:
        b["tokens"] = rs.randint(0, cfg.vocab, (B, S)).astype(np.int64)
    if cfg.is_encdec:
        b["src_embeds"] = (rs.standard_normal((B, S_ENC, cfg.d_model)) * 0.5).astype(np.float32)
    return b


def np32(t):
    return t.detach().to(torch.float32).cpu().numpy().copy()


def clone(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def policy(kind):
    """None (exact); ``mask_pc`` / ``mask_l1``: the mask backend at budget 0.5
    with per_column / l1 plans; ``compact``: l1@0.5 compact (the TP plans).
    The expert roles stay exact in the mask policies: their draws follow
    the model rank's local expert index (ROADMAP.md Queue 3 item 18)."""
    from repro_torch.api import SketchConfig, SketchPolicy
    from repro_torch.core.policy import _DEFAULT_EXCLUDE

    if kind == "exact":
        return None
    if kind == "compact":
        return SketchPolicy(base=SketchConfig(method="l1", budget=0.5, backend="compact"))
    method = "per_column" if kind == "mask_pc" else "l1"
    return SketchPolicy(base=SketchConfig(method=method, budget=0.5, backend="mask"),
                        exclude_roles=tuple(_DEFAULT_EXCLUDE) + EXPERT_ROLES)


def one_step(cfg, params, batch, *, mesh=None, tp=False, kind="exact", opt=None, sp=False,
             wire=False):
    """One step from ``params`` (whole): (new state, metrics, collective
    bytes). Under ``mesh`` the state and batch are this rank's shards;
    ``sp``: the sequence-parallel residual layout; ``wire``: the bytes are
    (payload, wire)."""
    from repro_torch.api import ExecutionConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import mesh as meshlib
    from repro_torch.optim import sgd
    from repro_torch.train.train_step import init_state, make_train_step

    opt = opt or sgd(0.1)
    act = None if mesh is None or not sp else (("data",), "model", None)
    ex = None if mesh is None else ExecutionConfig(mesh=mesh, tp_sketch=tp, act_sharding=act)
    st = init_state(0, cfg, opt, params=clone(params), device="cpu", execution=ex)
    step = make_train_step(cfg, opt, policy(kind), execution=ex, device="cpu")
    meshlib.reset_collective_bytes()
    new, m = step(st, batch if mesh is None else shard_batch(batch, mesh=mesh), STEP_SEED)
    cb = meshlib.collective_bytes()
    return new, m, (cb["total"], cb["wire"]["total"]) if wire else cb["total"]


def flat(tree, path="") -> dict:
    """A tree's tensor leaves by path (``/layers/0/attn/q/w``): JAX's trees
    order their dicts' keys, the port's keep its own order."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat(sub, f"{path}/{i}").items()}
    return {path: np32(tree)} if isinstance(tree, torch.Tensor) else {}


def whole_leaves(state, mesh=None) -> dict:
    return flat(state.params) if mesh is None else gather_whole(state.params, mesh)


def gather_whole(tree, mesh) -> dict:
    """A tree of this rank's marked shards as whole float32 arrays by path
    (:func:`flat`'s), in one collective: every rank's shards are
    all-gathered as one object and each is put where its rank's coordinates
    place it (``launch.sharding.gather_tree`` runs a collective per leaf and
    sharded dimension, which a loaded box makes the ranks' slowest part)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import _unravel
    from repro_torch.launch.sharding import dim_axes, spec_of

    mine = {}

    def walk(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        elif isinstance(t, torch.Tensor):
            mine[path] = (np32(t), spec_of(t))

    walk(tree)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out = {}
    for path, (local, spec) in mine.items():
        spec = spec or (None,) * local.ndim
        sizes = [mesh.axis_size(dim_axes(e)) for e in spec]
        whole = np.empty(tuple(n * k for n, k in zip(local.shape, sizes)), np.float32)
        for rank, shards in enumerate(every):
            coords = dict(zip(mesh.axis_names, _unravel(rank, mesh.devices_shape)))
            at = []
            for n, e in zip(local.shape, spec):
                i = 0
                for a in mesh.axes(dim_axes(e)):
                    i = i * mesh.shape[a] + coords[a]
                at.append(slice(i * n, (i + 1) * n))
            whole[tuple(at)] = shards[path][0]
        out[path] = whole
    return out


def family_runs(name, inp, out, meshes):
    """The single-device steps (exact, both masks; rank 0 alone, which saves
    them) and on each mesh: exact, ``mask_pc`` (and ``mask_l1`` on (1, 4)),
    the exact TP step and the compact TP step."""
    from repro_torch.configs.registry import smoke_config

    cfg = smoke_config(name)
    params, batch = inp[f"{name}/params"], inp[f"{name}/batch"]
    for kind in ("exact", "mask_pc", "mask_l1") if lead_rank() else ():
        new, m, _ = one_step(cfg, params, batch, kind=kind)
        out[f"{name}/single/{kind}/params"] = whole_leaves(new)
        out[f"{name}/single/{kind}/loss"] = float(m["loss"])
    for tag, mesh in meshes.items():
        runs = [("exact", False), ("mask_pc", False), ("exact_tp", True), ("compact", True)]
        if tag == "1x4":
            runs.append(("mask_l1", False))
        for run, tp in runs:
            kind = "exact" if run == "exact_tp" else run
            new, m, nbytes = one_step(cfg, params, batch, mesh=mesh, tp=tp, kind=kind)
            key = f"{name}/{tag}/{run}"
            out[key + "/params"] = whole_leaves(new, mesh)
            out[key + "/loss"] = float(m["loss"])
            out[key + "/aux"] = float(m["aux"])
            out[key + "/grad_norm"] = float(m["grad_norm"])
            out[key + "/bytes"] = nbytes


def sp_runs(name, inp, out, meshes):
    """On each mesh, the exact step and the exact TP step in the fixed and
    the sequence-parallel layouts: parameters, loss, payload and wire bytes."""
    from repro_torch.configs.registry import smoke_config

    cfg = smoke_config(name)
    params, batch = inp[f"{name}/params"], inp[f"{name}/batch"]
    for tag, mesh in meshes.items():
        for run, tp in (("exact", False), ("exact_tp", True)):
            for layout, sp in (("fixed", False), ("sp", True)):
                new, m, (nbytes, wire) = one_step(cfg, params, batch, mesh=mesh, tp=tp, sp=sp,
                                                  wire=True)
                key = f"{name}/{tag}/{layout}/{run}"
                out[key + "/params"] = whole_leaves(new, mesh)
                out[key + "/loss"] = float(m["loss"])
                out[key + "/bytes"] = (nbytes, wire)


def runtime_train(name, inp, out, mesh):
    """``Runtime.train`` for two steps over two batches (l1@0.5 mask, the
    per_column plans), on one device (rank 0 alone) and under
    ``ExecutionConfig(mesh=)``, from the same initial state: the loss
    histories."""
    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.configs.registry import smoke_config
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import TrainerConfig

    cfg = smoke_config(name)
    data = [inp[f"{name}/batch"], {k: v.flip(0) for k, v in inp[f"{name}/batch"].items()}]
    runs = (("single", ExecutionConfig()),) if lead_rank() else ()
    for tag, ex in runs + (("mesh", ExecutionConfig(mesh=mesh)),):
        rt = Runtime(policy=policy("mask_pc"), device="cpu", execution=ex)
        opt = sgd(0.1)
        state = rt.init_state(0, cfg, opt, params=clone(inp[f"{name}/params"]))
        _, hist = rt.train(cfg, opt, iter(data), TrainerConfig(steps=2, log_every=1),
                           state=state, on_metrics=lambda m: None)
        out[f"{name}/train/{tag}"] = [h["loss"] for h in hist]


def make_meshes(shapes):
    from repro_torch.launch.mesh import make_mesh

    return {tag: make_mesh(shape, ("data", "model"), device="cpu")
            for tag, shape in shapes.items()}


# The rank groups of the four gloo files (this one, the MoE, the distributed
# and the serving file) take turns: a group holds an exclusive lock on one
# file under the session's base temp while its ranks run, so at most one
# group of 4 ranks competes with the suite's workers for the cores. The
# deadline starts when the lock is taken and is SLOWDOWN times the group's
# time alone (``alone_s``, spawning included). The groups wait on gloo's
# loopback collectives, whose latency varies more than their compute: the
# same group ran alone on one 8-core host in 40 s at ~1 ms per 4-rank
# all-reduce and in 146 s at 6-11 ms, so each ALONE_S is the slower reading.
GROUP_LOCK = "torch_gloo_rank_groups.lock"
GROUP_LOG = "torch_gloo_rank_groups.log"
SLOWDOWN = 4


def group_dir(tmp_path_factory) -> str:
    """The directory every pytest worker of this session shares: the base
    temp (under xdist each worker's base temp is its child)."""
    base = tmp_path_factory.getbasetemp()
    return str(base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base)


def progress(work, rank, part) -> None:
    """Record that ``rank`` entered ``part`` (the file's mtime says when)."""
    with open(os.path.join(work, f"progress.{rank}"), "w") as f:
        f.write(part)


def _where(work) -> str:
    """Each rank's last recorded part and how long it has been in it."""
    now, said = time.time(), []
    for rank in range(WORLD):
        path = os.path.join(work, f"progress.{rank}")
        if not os.path.exists(path):
            said.append(f"rank {rank} never started a part")
            continue
        with open(path) as f:
            part = f.read()
        said.append(f"rank {rank} in {part} for {now - os.path.getmtime(path):.0f} s")
    return "; ".join(said)


def spawn_ranks(worker, inputs, tmp_path_factory, *, alone_s: float):
    """Run ``worker(rank, world, store, work)`` on 4 spawned ranks once, when
    no other group runs (:data:`GROUP_LOCK`); rank 0's saved results, the
    wall time of the run and the wait for the lock. A run past its deadline
    (``SLOWDOWN * alone_s`` from the lock) fails, naming where each rank
    was (:func:`progress`)."""
    import fcntl

    import torch.multiprocessing as mp

    work = str(tmp_path_factory.mktemp("ranks"))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    shared = group_dir(tmp_path_factory)
    limit = SLOWDOWN * alone_s
    t_wait = time.perf_counter()
    with open(os.path.join(shared, GROUP_LOCK), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            t0 = time.perf_counter()
            pc = mp.start_processes(worker, args=(WORLD, os.path.join(work, "store"), work),
                                    nprocs=WORLD, join=False, start_method="spawn")
            deadline = time.monotonic() + limit
            while not pc.join(timeout=1.0):
                if time.monotonic() > deadline:
                    where = _where(work)
                    for p in pc.processes:
                        if p.is_alive():
                            p.kill()
                    pytest.fail(f"the {WORLD} ranks did not finish within {limit:.0f} s "
                                f"({SLOWDOWN} x their {alone_s:.0f} s alone): {where}")
            wall = time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    waited = t0 - t_wait
    with open(os.path.join(shared, GROUP_LOG), "a") as log:
        log.write(f"{worker.__module__} waited {waited:.1f} s ran {wall:.1f} s "
                  f"(limit {limit:.0f} s)\n")
    out = torch.load(os.path.join(work, "results.pt"), weights_only=False)
    out["wall_s"], out["wait_s"] = wall, waited
    return out


def lead_rank() -> bool:
    """Whether this rank saves the results: the single-device references,
    the same on every rank, are computed there alone."""
    import torch.distributed as dist

    return dist.get_rank() == 0


def init_group(rank, world, store):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)


def finish(rank, out, work):
    import torch.distributed as dist

    try:
        if rank == 0:
            torch.save(out, os.path.join(work, "results.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The ranks' side
# ---------------------------------------------------------------------------


def _worker(rank, world, store, work):
    init_group(rank, world, store)
    out = {}
    try:
        inp = torch.load(os.path.join(work, "inputs.pt"))
        meshes = make_meshes(MESHES)
        for name in FAMILIES:
            progress(work, rank, name)
            t0 = time.perf_counter()
            family_runs(name, inp, out, meshes)
            runtime_train(name, inp, out, meshes["2x2"])
            out[f"time/{name}"] = time.perf_counter() - t0
        for name in SP_FAMILIES:
            progress(work, rank, f"sp/{name}")
            t0 = time.perf_counter()
            sp_runs(name, inp, out, meshes)
            out[f"time/sp/{name}"] = time.perf_counter() - t0
    finally:
        finish(rank, out, work)


# ---------------------------------------------------------------------------
# The test process's side
# ---------------------------------------------------------------------------


def jax_setup(name):
    """JAX's smoke config (remat off) and its sgd(0.1) initial state."""
    from repro import compat
    from repro.configs import registry as jreg
    from repro.optim import sgd
    from repro.train.train_step import init_state

    jcfg = jreg.smoke_config(name).replace(remat="none")
    return jcfg, init_state(compat.prng_key(0), jcfg, sgd(0.1))


def family_inputs(names):
    from repro_torch import interop
    from repro_torch.configs.registry import smoke_config

    inp = {}
    for name in names:
        cfg = smoke_config(name)
        _, st = jax_setup(name)
        inp[f"{name}/params"] = interop.params_from_jax(st.params, cfg, device="cpu")
        inp[f"{name}/batch"] = {k: torch.as_tensor(v) for k, v in family_batch(cfg).items()}
    return inp


def jax_mesh(tag):
    import jax

    from repro import compat

    return compat.make_mesh(MESHES.get(tag) or tuple(int(a) for a in tag.split("x")),
                            ("data", "model"), devices=jax.devices()[:4])


def jax_sharded_exact_step(name, tag, batch, sp=False):
    """JAX's sharded exact step (``tests/test_distributed.py``'s): the
    parameter shardings of its rules, activations over ("data",) (with
    ``sp``, the sequence over "model": its dry run's ``_act_sharding(...,
    sp=True)``), the batch's rows over data; its new parameters as the
    port's leaves, and the loss."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import compat
    from repro.launch import sharding as shard
    from repro.optim import sgd
    from repro.train.train_step import TrainState, make_train_step
    from repro_torch import interop
    from repro_torch.configs.registry import smoke_config

    jcfg, state = jax_setup(name)
    mesh = jax_mesh(tag)
    pspecs = shard.param_shardings(state.params, mesh)
    sshard = TrainState(params=pspecs, opt_state={k: pspecs for k in state.opt_state},
                        step=NamedSharding(mesh, P()))
    act = NamedSharding(mesh, P(("data",), "model" if sp else None, None))
    step = make_train_step(jcfg, sgd(0.1), None, mesh=mesh, act_sharding=act,
                           data_axes=("data",), model_axes=("model",))

    def spec(k, v):
        if k == "positions":
            return P(None, "data", None)
        return P("data", *([None] * (v.ndim - 1)))

    bspec = {k: NamedSharding(mesh, spec(k, v)) for k, v in batch.items()}
    step = jax.jit(step, in_shardings=(sshard, bspec, NamedSharding(mesh, P())))
    new, m = step(state, {k: np.asarray(v.numpy()) for k, v in batch.items()},
                  compat.prng_key(STEP_SEED))
    return flat(interop.params_from_jax(new.params, smoke_config(name), device="cpu")), \
        float(m["loss"])


def assert_close_leaves(got: dict, want: dict, rtol, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def inputs():
    return family_inputs(FAMILIES + tuple(n for n in SP_FAMILIES if n not in FAMILIES))


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn_ranks(_worker, inputs, tmp_path_factory, alone_s=ALONE_S)


@pytest.mark.parametrize("name,tag", JAX_CASES)
def test_family_sharded_step_matches_jax(ranks, inputs, name, tag):
    """The exact mesh step (tp_sketch off) against JAX's sharded exact step
    on the same mesh shape: loss rtol 1e-4; parameters rtol 2e-3, atol 2e-4
    (JAX's own tolerances for its sharded step)."""
    want, loss = jax_sharded_exact_step(name, tag, inputs[f"{name}/batch"])
    np.testing.assert_allclose(ranks[f"{name}/{tag}/exact/loss"], loss, rtol=1e-4)
    assert_close_leaves(ranks[f"{name}/{tag}/exact/params"], want, 2e-3, 2e-4)


@pytest.mark.parametrize("run", ["exact", "exact_tp", "mask_pc"])
@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", FAMILIES)
def test_family_mesh_step_matches_single_device(ranks, name, tag, run):
    """The exact mesh step, the exact TP step (Megatron plans) and the
    ``per_column`` mask step against the port's single-device step from the
    same parameters, batch and seed: loss and every parameter within 1e-5."""
    kind = "exact" if run == "exact_tp" else run
    np.testing.assert_allclose(ranks[f"{name}/{tag}/{run}/loss"],
                               ranks[f"{name}/single/{kind}/loss"], rtol=1e-5)
    assert_close_leaves(ranks[f"{name}/{tag}/{run}/params"],
                        ranks[f"{name}/single/{kind}/params"], 1e-5, 1e-5)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_l1_mask_on_a_model_mesh_is_the_single_device_step(ranks, name):
    """On (1, 4) the ranks hold the whole batch: the ``l1`` mask step (scores
    read from the gradient) is the single-device step bit for bit."""
    got, want = ranks[f"{name}/1x4/mask_l1/params"], ranks[f"{name}/single/mask_l1/params"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ranks[f"{name}/1x4/mask_l1/loss"] == ranks[f"{name}/single/mask_l1/loss"]


@pytest.mark.parametrize("name", FAMILIES)
def test_family_tp_sketch_step(ranks, name):
    """The compact TP step: its loss equals the exact TP step's (the sketch
    is backward-only, rtol 1e-5), its update is finite, and on (2, 2) it
    hands the collectives fewer bytes than the exact TP step."""
    for tag in MESHES:
        key = f"{name}/{tag}/compact"
        np.testing.assert_allclose(ranks[key + "/loss"], ranks[f"{name}/{tag}/exact_tp/loss"],
                                   rtol=1e-5)
        assert np.isfinite(ranks[key + "/grad_norm"])
        assert all(np.isfinite(a).all() for a in ranks[key + "/params"].values())
    assert ranks[f"{name}/2x2/compact/bytes"] < ranks[f"{name}/2x2/exact_tp/bytes"]


@pytest.mark.parametrize("name", FAMILIES)
def test_runtime_trains_the_family_under_a_mesh(ranks, name):
    """``Runtime.train`` with ``ExecutionConfig(mesh=(2, 2))``: two steps
    whose losses are the single-device run's (1e-5)."""
    got, want = ranks[f"{name}/train/mesh"], ranks[f"{name}/train/single"]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("run", ["exact", "exact_tp"])
@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", SP_FAMILIES)
def test_sequence_parallel_step_matches_the_fixed_layout(ranks, name, tag, run):
    """The sequence-parallel step (the residual stream's sequence over
    model between the blocks, gathered at each block's entry and
    reduce-scattered at its exit) against the fixed-layout step, with the
    local plans and with the TP plans: loss and every parameter within
    SP_RTOL."""
    sp, fixed = (f"{name}/{tag}/{lay}/{run}" for lay in ("sp", "fixed"))
    np.testing.assert_allclose(ranks[sp + "/loss"], ranks[fixed + "/loss"], rtol=SP_RTOL)
    assert_close_leaves(ranks[sp + "/params"], ranks[fixed + "/params"], SP_RTOL, SP_RTOL)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("name", SP_FAMILIES)
def test_sequence_parallel_step_matches_jax(ranks, inputs, name, tag):
    """The port's sequence-parallel exact step against JAX's sharded exact
    step with ``sp=True`` on the same mesh: loss and every parameter within
    SP_RTOL."""
    want, loss = jax_sharded_exact_step(name, tag, inputs[f"{name}/batch"], sp=True)
    key = f"{name}/{tag}/sp/exact"
    np.testing.assert_allclose(ranks[key + "/loss"], loss, rtol=SP_RTOL)
    assert_close_leaves(ranks[key + "/params"], want, SP_RTOL, SP_RTOL)


@pytest.mark.parametrize("tag", list(MESHES))
def test_sequence_parallel_payload_and_wire_formulas(ranks, inputs, tag):
    """The dense decoder's exact step (local plans, remat "full"): the
    sequence-parallel layout adds to the fixed layout's collectives exactly
    its movers. Each block (attention, MLP) gathers its input's chunk ``c``
    (B_local x S/n x d float32) in the forward, again in the recompute, and
    gathers its output's chunk cotangent in the backward; each of the two
    norms per layer all-reduces its gain's gradient (d float32) over model;
    the embedding's slice gathers a chunk cotangent and the head's join a
    chunk. Wire: an all-gather of ``c`` over n ranks moves (n - 1) c, an
    all-reduce of b moves 2 (n - 1) / n b."""
    from repro_torch.configs.registry import smoke_config

    cfg = smoke_config("yi_6b")
    n_dp, n = MESHES[tag]
    c = (B // n_dp) * (S // n) * cfg.d_model * 4
    r = 1 if cfg.remat != "none" else 0
    L, gain = cfg.n_layers, cfg.d_model * 4
    pay = L * (2 * (2 + r) * c + 2 * gain) + 2 * c
    wire = L * (2 * (2 + r) * (n - 1) * c + 2 * 2 * (n - 1) / n * gain) + 2 * (n - 1) * c
    (p_sp, w_sp), (p_fix, w_fix) = (ranks[f"yi_6b/{tag}/{lay}/exact/bytes"]
                                    for lay in ("sp", "fixed"))
    assert p_sp - p_fix == pay
    assert w_sp - w_fix == pytest.approx(wire, rel=1e-12)


@pytest.mark.parametrize("name", FAMILIES)
def test_serving_under_a_mesh_raises_naming_the_next_slice(name):
    """Serving under a mesh runs for every family since the eighteenth slice
    (``test_torch_distributed_serve.py``); what stays for the next
    distributed slice (ROADMAP.md Queue 1 item 2b) still raises when the
    serving Runtime is built, before any collective: an activation layout
    other than the port's fixed one."""
    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.mesh import layout

    cfg = smoke_config(name)
    mesh = layout((2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 2b"):
        Runtime(device="cpu", execution=ExecutionConfig(mesh=mesh,
                                                        act_sharding=(None, None, "model"))
                ).prefill_step(cfg, S + 4)
