"""The port's distributed runtime on CPU gloo ranks, against JAX's meshes.

One module fixture spawns 4 ranks once (``torch.multiprocessing``, a
``file://`` store under ``tmp_path``: no ports, so no clash between xdist
workers; one intra-op thread per rank) through the gloo files' shared
harness (``test_torch_distributed_families.spawn_ranks``: one rank group at
a time, a deadline from the group's time alone, a time-out naming each
rank's part). Every rank runs every scenario on the
meshes (2, 2) and (1, 4) ``("data", "model")``; rank 0 saves what they
produced, and the tests compare it here: with JAX on the same numpy inputs
(``make_mesh(..., devices=jax.devices()[:4])``, weights carried by
``interop.params_from_jax``) for the deterministic cases, with the port's own
single-device step, and statistically for the TP estimators and probes. The
arch is JAX's ``test_distributed._arch()``: 2 layers, d 32, 4 heads, 2 kv,
d_ff 64, vocab 64.
"""
from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from test_torch_distributed_families import (gather_whole, init_group, lead_rank, progress,
                                             spawn_ranks)

MESHES = ((2, 2), (1, 4))
TAGS = tuple(f"{a}x{b}" for a, b in MESHES)
ELASTIC = (((4, 1), ("data", "model")), ((2, 2), ("data", "model")),
           ((1, 4), ("data", "model")), ((1, 2, 2), ("pod", "data", "model")))
WORLD = 4
ALONE_S = 150  # the rank group's time alone (spawning included; see SLOWDOWN)
N_MC = 480  # draws of the unbiasedness tests (JAX's)
N_PROBE = 384  # draws of the probe tests (JAX's)
B, S, DIN, N = 4, 8, 16, 32  # the TP linear tests' shapes (JAX's)
STEP_SEED = 2
# the toy estimator's registry name: not JAX's test's own ("toy_tp_firstr"),
# which a worker sharing this process must find unregistered or its own
TOY = "toy_tp_firstr_port"
PLAN_SEEDS = 16
FULL = 0.999  # a budget that keeps every column (and block) with scale 1
# the biased split site (a local plan on its model shard, tp_sketch off):
# x [BB, BS, BD_IN], w [BN, BD_IN], blocks of BLOCK_B columns (four of them:
# one per model shard on (1, 4), two on (2, 2)); its runs: exact, pallas l1
# block 128 at budget 0.5 and at FULL
BB, BS, BD_IN, BN, BLOCK_B = 4, 8, 256, 512, 128
BIAS_SEED, BIAS_SITE_SEED = 5, 77
BIAS_RUNS = ("exact", "pallas_half", "pallas_full")


def _arch():
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv=2,
                      d_ff=64, vocab=64, q_chunk=16, kv_chunk=16)


def _policy(name):
    from repro_torch.api import SketchConfig, SketchPolicy

    if name.startswith("exact"):
        return None
    kw = dict(method="l1", budget=0.5, backend="mask" if name == "mask" else "compact")
    if name.startswith("block"):
        kw["block"] = 4
    return SketchPolicy(base=SketchConfig(**kw))


# name: (tp_sketch, compact_grads)
STEPS = {"exact": (False, False), "mask": (False, False), "exact_tp": (True, False),
         "compact": (True, False), "block": (True, False), "block_cg": (True, True)}


# ---------------------------------------------------------------------------
# The ranks' side
# ---------------------------------------------------------------------------


class _ToyTPFirstR:
    """The port of JAX's ``_ToyTPFirstR``: compact semantics, but the plan
    keeps the FIRST r columns (uniform marginals), deterministically."""

    @staticmethod
    def make():
        from repro_torch.core.sketched_linear import _CompactEstimator
        from repro_torch.core.sketching import ColumnPlan, static_rank

        class Toy(_CompactEstimator):
            name = TOY
            tp_shardable = True

            def plan(self, cfg, G2d, w, gen, *, want_compact=True, score_psum_axes=None):
                n = G2d.shape[-1]
                r = static_rank(cfg, n)
                p = torch.full((n,), r / n, dtype=torch.float32)
                idx = torch.arange(r)
                return ColumnPlan(indices=idx, scales=1.0 / p[idx], gate=None, probs=p)

        return Toy()


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy().copy()


def _full(t, spec, mesh):
    from repro_torch.launch.sharding import gather_tensor

    return _np(gather_tensor(t, spec, mesh))


def _steps(mesh, tag, inp, out):
    from repro_torch.api import ExecutionConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import mesh as meshlib
    from repro_torch.optim import sgd
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = _arch()
    batch = {"tokens": inp["tokens"], "labels": inp["tokens"]}
    for name, (tp, cg) in STEPS.items():
        opt = sgd(0.1)
        ex = ExecutionConfig(mesh=mesh, tp_sketch=tp, compact_grads=cg)
        st = init_state(0, cfg, opt, params=_clone(inp["params"]), device="cpu", execution=ex)
        step = make_train_step(cfg, opt, _policy(name), execution=ex, device="cpu")
        meshlib.reset_collective_bytes()
        new, m = step(st, shard_batch(batch, mesh=mesh), STEP_SEED)
        out[f"{tag}/step/{name}/bytes"] = meshlib.collective_bytes()["total"]
        out[f"{tag}/step/{name}/params"] = list(gather_whole(new.params, mesh).values())
        out[f"{tag}/step/{name}/loss"] = float(m["loss"])
        out[f"{tag}/step/{name}/grad_norm"] = float(m["grad_norm"])
        if name == "exact" and tag == TAGS[0]:
            out["ckpt_state"] = new
    for name in ("exact", "mask") if lead_rank() else ():
        if f"single/{name}/params" in out:
            continue
        opt = sgd(0.1)
        st = init_state(0, cfg, opt, params=_clone(inp["params"]), device="cpu")
        new, m = make_train_step(cfg, opt, _policy(name), device="cpu")(st, batch, STEP_SEED)
        out[f"single/{name}/params"] = [_np(t) for t in tree_leaves(new.params)]
        out[f"single/{name}/loss"] = float(m["loss"])


def _clone(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def _ctx(mesh, **kw):
    from repro_torch.api import ExecutionConfig

    return ExecutionConfig(mesh=mesh, tp_sketch=True).make_ctx(**kw)


def _linear_inputs(inp, mesh, kind, rows=B):
    """This rank's x rows of the first ``rows`` (and model chunk of d_in on
    the row plan), w shard (the rules of a q / an mlp-out weight), and the
    specs."""
    from repro_torch.launch import mesh as m
    from repro_torch.launch import sharding

    path = "/layers/0/mlp/out/w" if kind == "row" else "/layers/0/attn/q/w"
    wspec = sharding.spec_for_path(path, (N, DIN), mesh)
    w = sharding.shard_tensor(inp["lin_w"], wspec, mesh).requires_grad_(True)
    x = m.chunk_of(inp["lin_x"][:rows], ("data",), mesh, 0)
    xspec = (("data",), None, "model" if kind == "row" else None)
    if kind == "row":
        x = m.chunk_of(x, ("model",), mesh, 2)
    return x.clone().requires_grad_(True), w, wspec, xspec


def _tp_fn(kind):
    from repro_torch.core import sharded_sketch as ss

    return ss.tp_row_sketched_linear if kind == "row" else ss.tp_sketched_linear


def _gout(inp, mesh, kind, rows=B):
    """This rank's slice of the output cotangent ``g_out`` [rows, S, N]."""
    from repro_torch.launch import mesh as m

    g = m.chunk_of(inp["lin_g"][:rows], ("data",), mesh, 0)
    return g if kind == "row" else m.chunk_of(g, ("model",), mesh, 2)


def _toy(mesh, tag, inp, out):
    from repro_torch.core import estimators
    from repro_torch.core.sketching import SketchConfig

    if TOY not in estimators.registered_backends():
        estimators.register_estimator(_ToyTPFirstR.make())
    cfg = SketchConfig(method="per_column", budget=0.5, backend=TOY)
    x, w, wspec, xspec = _linear_inputs(inp, mesh, "column")
    y = _tp_fn("column")(x, w, _ctx(mesh), cfg, 7)
    dx, dw = torch.autograd.grad(torch.sin(y).sum(), (x, w))
    out[f"{tag}/toy/dx"] = _full(dx, xspec, mesh)
    out[f"{tag}/toy/dw"] = _full(dw, wspec, mesh)


def _budget_one(mesh, tag, inp, out):
    """Every TP plan at budget 0.999 (every column kept with scale 1: budget
    1.0 is a no-op config in both packages) with a bias and a probe; dense
    gradients, then the compact rows through a gradient slot."""
    from repro_torch.core.compact_grad import GradSlot
    from repro_torch.core.sharded_sketch import tp_exact_linear
    from repro_torch.core.sketching import SketchConfig
    from repro_torch.telemetry.probes import PROBE_WIDTH

    for kind in ("column", "column_block", "row", "exact"):
        cfg = SketchConfig(method="l1", budget=FULL, backend="compact",
                           block=4 if kind == "column_block" else 0)
        lk = "row" if kind == "row" else "column"
        for compact in (False, True):
            if compact and kind == "exact":
                continue
            x, w, wspec, xspec = _linear_inputs(inp, mesh, lk)
            b = inp["lin_b"].clone().requires_grad_(True)
            ps = torch.zeros(PROBE_WIDTH, requires_grad=True)
            slot = None
            if compact:
                n_mp = mesh.axis_size("model")
                slot = GradSlot(N if lk == "row" else n_mp * (N // n_mp))
            ctx = _ctx(mesh)
            if kind == "exact":
                y = tp_exact_linear(x, w, ctx, b=b)
            else:
                y = _tp_fn(lk)(x, w, ctx, cfg, 11, slot, b=b, pslot=ps)
            loss = (y * _gout(inp, mesh, lk)).sum()
            wants = [x, b] + ([] if compact else [w]) + ([] if kind == "exact" else [ps])
            grads = dict(zip(["dx", "db"] + ([] if compact else ["dw"])
                             + ([] if kind == "exact" else ["probe"]),
                             torch.autograd.grad(loss, wants)))
            key = f"{tag}/one/{kind}/{'compact' if compact else 'dense'}"
            out[key + "/y"] = _full(y.detach(), (("data",), None, None if lk == "row"
                                                 else "model"), mesh)
            out[key + "/dx"] = _full(grads["dx"], xspec, mesh)
            out[key + "/db"] = _np(grads["db"])
            if "dw" in grads:
                out[key + "/dw"] = _full(grads["dw"], wspec, mesh)
            if "probe" in grads:
                out[key + "/probe"] = _np(grads["probe"])
            if compact:
                cols = (None, "model") if lk == "row" else (None, ("data",))
                out[key + "/rows"] = _full(slot.rows, cols, mesh)
                out[key + "/idx"] = slot.idx.numpy().copy()


def _stack_full(draws, spec, mesh):
    """The draws of this rank's shards stacked, gathered whole once."""
    return _full(torch.stack(draws), (None,) + tuple(spec), mesh)


def _mc(mesh, tag, inp, out):
    """Draws for the statistical tests: the TP sketch (column), the probes
    (column, column block, row) and the bias sites (column, row)."""
    from repro_torch.api import SketchPolicy
    from repro_torch.core.sketching import SketchConfig
    from repro_torch.nn.common import dense
    from repro_torch.telemetry.probes import PROBE_WIDTH

    cfg = SketchConfig(method="l1", budget=0.5, backend="compact")
    x, w, wspec, xspec = _linear_inputs(inp, mesh, "column")
    ctx = _ctx(mesh)
    dxs, dws = [], []
    for k in range(N_MC):
        y = _tp_fn("column")(x, w, ctx, cfg, 1000 + k)
        dx, dw = torch.autograd.grad(torch.sin(y).sum(), (x, w))
        dxs.append(dx)
        dws.append(dw)
    out[f"{tag}/mc/sketch/dx"] = _stack_full(dxs, xspec, mesh)
    out[f"{tag}/mc/sketch/dw"] = _stack_full(dws, wspec, mesh)
    out[f"{tag}/mc/sketch/y"] = _full(y.detach(), (("data",), None, "model"), mesh)
    for kind in ("column", "column_block", "row"):
        lk = "row" if kind == "row" else "column"
        kcfg = SketchConfig(method="l1", budget=0.5, backend="compact",
                            block=4 if kind == "column_block" else 0)
        x, w, wspec, xspec = _linear_inputs(inp, mesh, lk, rows=2)  # JAX's B = 2
        g = _gout(inp, mesh, lk, rows=2)
        dws, probes = [], []
        for k in range(N_PROBE):
            ps = torch.zeros(PROBE_WIDTH, requires_grad=True)
            y = _tp_fn(lk)(x, w, ctx, kcfg, 5000 + k, pslot=ps)
            dw, probe = torch.autograd.grad((y * g).sum(), (w, ps))
            dws.append(dw)
            probes.append(_np(probe))
        out[f"{tag}/mc/probe/{kind}/dw"] = _stack_full(dws, wspec, mesh)
        out[f"{tag}/mc/probe/{kind}/probe"] = np.stack(probes)
    for role in ("attn_q", "mlp_out"):
        lk = "row" if role == "mlp_out" else "column"
        x, w, wspec, xspec = _linear_inputs(inp, mesh, lk, rows=2)
        b = inp["lin_b"].clone().requires_grad_(True)
        pol = SketchPolicy(base=cfg)
        ctx0 = _ctx(mesh, policy=pol, key=3)
        spec = ctx0.site_spec(role, cfg, w, has_bias=True)
        out[f"{tag}/mc/bias/{role}/kind"] = spec.plan.kind
        out[f"{tag}/mc/bias/{role}/rows"] = spec.compact_rows
        dws, dbs = [], []
        for k in range(N_MC):
            ctx0.key = 9000 + k
            y = dense({"w": w, "b": b}, x, ctx0, role)
            dw, db = torch.autograd.grad(torch.sin(y).sum(), (w, b))
            dws.append(dw)
            dbs.append(_np(db))
        out[f"{tag}/mc/bias/{role}/dw"] = _stack_full(dws, wspec, mesh)
        out[f"{tag}/mc/bias/{role}/db"] = np.stack(dbs)
        out[f"{tag}/mc/bias/{role}/y"] = _full(y.detach(), (("data",), None, None if lk == "row"
                                                            else "model"), mesh)


def _plans(mesh, tag, inp, out):
    """Which plan each rank drew, over PLAN_SEEDS seeds: the slot's indices
    of one TP column site (this shard's own local plan) and one TP row site,
    gathered from every rank."""
    import torch.distributed as dist

    from repro_torch.core.compact_grad import GradSlot
    from repro_torch.core.estimators import get_estimator
    from repro_torch.core.sketching import SketchConfig
    from repro_torch.launch import mesh as m

    cfg = SketchConfig(method="l1", budget=0.5, backend="compact")
    est = get_estimator("compact")
    n_mp = mesh.axis_size("model")
    n_loc = N // n_mp
    for lk in ("column", "row"):
        x, w, _, _ = _linear_inputs(inp, mesh, lk)
        mine = []
        for seed in range(PLAN_SEEDS):
            slot = GradSlot(est.compact_rank(cfg, N) if lk == "row"
                            else n_mp * est.compact_rank(cfg, n_loc))
            y = _tp_fn(lk)(x, w, _ctx(mesh), cfg, 77 + seed, slot)
            torch.autograd.grad((y * _gout(inp, mesh, lk)).sum(), (x,))
            idx = slot.idx
            if lk == "column":
                lo = m.axis_index(mesh, "model") * n_loc
                idx = idx[(idx >= lo) & (idx < lo + n_loc)] - lo
            mine.append(tuple(idx.tolist()))
        got = [None] * WORLD
        dist.all_gather_object(got, (mesh.coords["data"], mesh.coords["model"], mine))
        out[f"{tag}/plans/{lk}"] = got


DATA_ONLY_BACKENDS = ("compact", "pallas", "onepass", "stale")


def _data_only(inp, out):
    """Every backend's local plan on the data-only mesh (4, 1) and on one
    device, from the same parameters, batch and seed: block-4 l1@0.5 (the
    plan-carry backends with their carry leaves)."""
    from repro_torch.api import ExecutionConfig, SketchConfig, SketchPolicy
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import sgd
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.tree import tree_leaves

    mesh = make_mesh((4, 1), ("data", "model"), device="cpu")
    cfg = _arch()
    batch = {"tokens": inp["tokens"], "labels": inp["tokens"]}
    for backend in DATA_ONLY_BACKENDS:
        pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.5, backend=backend, block=4))
        # the single-device reference on rank 0 alone, which saves it
        for ex in ((None,) if lead_rank() else ()) + (ExecutionConfig(mesh=mesh),):
            opt = sgd(0.1)
            st = init_state(0, cfg, opt, params=_clone(inp["params"]), device="cpu",
                            policy=pol, execution=ex)
            new, m = make_train_step(cfg, opt, pol, execution=ex, device="cpu")(
                st, batch if ex is None else shard_batch(batch, mesh=mesh), STEP_SEED)
            key = f"data_only/{backend}/{'single' if ex is None else 'mesh'}"
            out[key + "/params"] = ([_np(t) for t in tree_leaves(new.params)] if ex is None
                                    else list(gather_whole(new.params, mesh).values()))
            out[key + "/loss"] = float(m["loss"])


def _trainer(inp, out):
    """JAX's test_adaptive_schedule_under_tp_sketch on the (2, 2) mesh:
    ``Runtime.train`` with ``BudgetSchedule.adaptive`` under ``tp_sketch``
    (the TP plans' probes feed the controller), 8 steps."""
    import warnings

    from repro_torch.api import (BudgetSchedule, ExecutionConfig, Runtime, SketchConfig,
                                 SketchPolicy)
    from repro_torch.api import runtime as runtime_mod
    from repro_torch.data.synthetic import LMStream
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import sgd
    from repro_torch.train.trainer import TrainerConfig

    from repro_torch.train import train_step as tstep_mod

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    cfg = _arch()
    runtime_mod._STEP_CACHE.clear()
    real, builds = tstep_mod.make_train_step, []

    def counting(*a, **kw):
        builds.append(1)
        return real(*a, **kw)

    tstep_mod.make_train_step = counting
    sched = BudgetSchedule.adaptive(0.05, budgets=(1.0, 0.5, 0.2), window=2)
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.5, backend="compact"))
    rt = Runtime(policy=pol, schedule=sched, device="cpu",
                 execution=ExecutionConfig(mesh=mesh, tp_sketch=True))
    data = LMStream(vocab=cfg.vocab, seed=0).batches(8, 16)
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            state, hist = rt.train(cfg, sgd(0.1), data, TrainerConfig(steps=8, log_every=1),
                                   on_metrics=lambda m: None)
    finally:
        tstep_mod.make_train_step = real
    out["trainer/warned"] = any("cannot measure gradient SNR" in str(w.message) for w in rec)
    out["trainer/builds"] = len(builds)
    out["trainer/buckets"] = sched.buckets()
    out["trainer/hist"] = [{k: v for k, v in h.items() if k in ("budget", "probe_snr", "loss")}
                           for h in hist]


def _resilience(inp, out, work):
    """``train_loop`` under resilience on the (2, 2) mesh, AdamW, a checkpoint
    every 2 of 6 steps, with a ``ckpt_io`` fault at steps 1 and 5: the write
    of step 2 fails and surfaces at step 4's save, the write of step 6 at
    the loop's last wait. Rank 0 alone writes, so every rank must learn of
    the failure before the synchronous retry's gathers (the run would hang
    otherwise). Records the events, the steps on disk and whether each one
    restores bit for bit."""
    from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
    from repro_torch.data.synthetic import LMStream
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import gather_tree
    from repro_torch.optim import adamw
    from repro_torch.resilience import ResilienceConfig
    from repro_torch.resilience.faults import FaultPlan, FaultSpec
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.elastic import resume_on_mesh, state_shardings
    from repro_torch.train.trainer import TrainerConfig, train_loop
    from repro_torch.tree import tree_leaves

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    cfg = _arch()
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.5, backend="compact"))
    rt = Runtime(policy=pol, device="cpu",
                 execution=ExecutionConfig(mesh=mesh, tp_sketch=True,
                                           resilience=ResilienceConfig(rollback_after=0)))
    ckdir = os.path.join(work, "resilience")
    plan = FaultPlan(faults=(FaultSpec(step=1, kind="ckpt_io"),
                             FaultSpec(step=5, kind="ckpt_io")))
    events = []
    state, _ = train_loop(rt, cfg, adamw(1e-2), LMStream(vocab=cfg.vocab, seed=0).batches(8, 16),
                          TrainerConfig(steps=6, log_every=1, ckpt_dir=ckdir, ckpt_every=2),
                          on_metrics=lambda m: None, faults=plan, on_event=events.append)
    import torch.distributed as dist

    mine = [(e["event"], e["step"]) for e in events if e["event"].startswith("ckpt")]
    out["resilience/events"] = [None] * dist.get_world_size()  # every rank's
    dist.all_gather_object(out["resilience/events"], mine)
    out["resilience/steps_on_disk"] = [s for s in (2, 4, 6) if ck.verify(ckdir, s)]
    # step 4 restores as this rank's shards; the newest, step 6, bit for bit
    at4, _ = ck.restore(ckdir, state, step=4, shardings=state_shardings(state, mesh))
    restored, step = resume_on_mesh(ckdir, state, mesh)

    def whole(st):
        return (tree_leaves(gather_tree(st.params, mesh))
                + tree_leaves(gather_tree(st.opt_state, mesh)))

    want, got = whole(state), whole(restored)
    out["resilience/final_restores"] = (step == 6 and state.step == 6 and len(want) == len(got)
                                        and all(torch.equal(a, b) for a, b in zip(want, got)))
    out["resilience/step4_shards"] = all(
        a.shape == b.shape for a, b in zip(tree_leaves(at4.params), tree_leaves(state.params)))


def _elastic(inp, out, work, rank):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import gather_tree
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.elastic import gather_state, resume_on_mesh
    from repro_torch.tree import tree_leaves

    state = out.pop("ckpt_state")
    mesh = make_mesh(MESHES[0], ("data", "model"), device="cpu")
    whole = gather_state(state, mesh)
    ckdir = os.path.join(work, "ckpt")
    if rank == 0:
        ck.save(ckdir, 5, whole)
    dist.barrier()
    want = [t for t in tree_leaves(whole.params)]
    for shape, axes in ELASTIC:
        mesh = make_mesh(shape, axes, device="cpu")
        restored, step = resume_on_mesh(ckdir, whole, mesh)
        got = tree_leaves(gather_tree(restored.params, mesh))
        moments = gather_tree(restored.opt_state, mesh) if restored.opt_state else {}
        out[f"elastic/{'x'.join(map(str, shape))}"] = (
            step == 5 and all(torch.equal(a, b) for a, b in zip(want, got))
            and all(torch.equal(a, b) for a, b in zip(tree_leaves(whole.opt_state),
                                                     tree_leaves(moments))))


def _split(mesh, tag, inp, out):
    """The local plans split over model (``tp_sketch`` off): the ``mask``
    step's plans on every rank against the single device's, its probes
    against the single device's, the vocab-parallel loss against the loss
    of the gathered logits, and rank 0's FlopCounterMode FLOPs of the exact
    step against the gathered layout's (every weight whole on every
    rank)."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.api import ExecutionConfig
    from repro_torch.core import site, sketching
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import sharding
    from repro_torch.models import lm
    from repro_torch.optim import sgd
    from repro_torch.telemetry import TelemetryConfig
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = _arch()
    batch = {"tokens": inp["tokens"], "labels": inp["tokens"]}
    ex = ExecutionConfig(mesh=mesh)
    shard = shard_batch(batch, mesh=mesh)

    def step(execution, name, b):
        opt = sgd(0.1)
        st = init_state(0, cfg, opt, params=_clone(inp["params"]), device="cpu",
                        execution=execution)
        fn = make_train_step(cfg, opt, _policy(name), execution=execution, device="cpu")
        return fn(st, b, STEP_SEED)

    plans, real_plan = [], sketching.column_plan

    def spy(*a, **kw):
        plan = real_plan(*a, **kw)
        plans.append(plan.indices.tolist())
        return plan

    sketching.column_plan = spy
    try:
        step(None, "mask", batch)
        single = list(plans)
        plans.clear()
        step(ex, "mask", shard)
    finally:
        sketching.column_plan = real_plan
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (plans == single, len(plans)))
    out[f"{tag}/split/plans"] = every
    probed = [step(ExecutionConfig(mesh=m, telemetry=TelemetryConfig()), "mask", b)[1]
              for m, b in ((None, batch), (mesh, shard))]
    out[f"{tag}/split/probes"] = [{k: _np(v) for k, v in p["probe_sites"].items()}
                                  for p in probed]
    ctx = ex.make_ctx()
    params = sharding.shard_params(_clone(inp["params"]), mesh)
    with torch.no_grad():
        loss, _ = lm.lm_loss(params, shard, ctx, cfg)
        logits = lm.forward(params, shard, ctx, cfg)
    labels = shard["labels"].long()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]
    out[f"{tag}/split/loss"] = (float(loss), float(nll.mean() / mesh.axis_size("data")))

    def flops():
        with FlopCounterMode(display=False) as fc:
            step(ex, "exact", shard)
        return fc.get_total_flops()

    split = flops()
    real_kind = site.split_kind
    site.split_kind = lambda *a, **k: None  # the gathered layout
    try:
        out[f"{tag}/split/flops"] = (split, flops())
    finally:
        site.split_kind = real_kind


def _bias_arrays():
    """The biased site's numpy inputs: x, w, b and the output cotangent g."""
    rs = np.random.RandomState(BIAS_SEED)
    return ((rs.standard_normal((BB, BS, BD_IN)) / 2).astype(np.float32),
            (rs.standard_normal((BN, BD_IN)) / 16).astype(np.float32),
            (rs.standard_normal((BN,)) / 4).astype(np.float32),
            (rs.standard_normal((BB, BS, BN)) / 4).astype(np.float32))


def _bias_cfg(run):
    from repro_torch.core.sketching import SketchConfig

    if run == "exact":
        return None
    return SketchConfig(method="l1", budget=0.5 if run == "pallas_half" else FULL,
                        backend="pallas", block=BLOCK_B)


def _bias_split(mesh, tag, inp, out):
    """A hand-sharded biased site split over model (``core.site.mesh_site``
    with ``split=``), column-parallel (the weight stored as an MLP-in's,
    ``("model", ("data",))``) and row-parallel (as an MLP-out's), per
    :data:`BIAS_RUNS`, the plan drawn from the site's generator: y, dX, dW
    and db whole."""
    import torch.distributed as dist

    from repro_torch import rng
    from repro_torch.core import site
    from repro_torch.launch import sharding

    X, W, Bv, G = (torch.as_tensor(a) for a in _bias_arrays())
    for kind in ("column", "row"):
        path = "/layers/0/mlp/out/w" if kind == "row" else "/layers/0/mlp/in/w"
        wspec = sharding.spec_for_path(path, (BN, BD_IN), mesh)
        xspec = (("data",), None, "model" if kind == "row" else None)
        yspec = (("data",), None, None if kind == "row" else "model")
        for run in BIAS_RUNS:
            w = sharding.shard_tensor(W, wspec, mesh).requires_grad_(True)
            x = sharding.shard_tensor(X, xspec, mesh).requires_grad_(True)
            b = Bv.clone().requires_grad_(True)
            cfg = _bias_cfg(run)
            gen = None if cfg is None else rng.generator(BIAS_SITE_SEED, "cpu")
            assert site.split_kind(w, mesh, ("data",), ("model",)) == kind
            y = site.mesh_site(cfg, x, w, b, gen, mesh, ("data",), ("model",), split=kind)
            g = sharding.shard_tensor(G, yspec, mesh)
            dx, dw, db = torch.autograd.grad((y * g).sum(), (x, w, b))
            key = f"{tag}/bias/{kind}/{run}"
            out[key + "/y"] = _full(y.detach(), yspec, mesh)
            out[key + "/dx"] = _full(dx, xspec, mesh)
            out[key + "/dw"] = _full(dw, wspec, mesh)
            # db is whole on every rank: rank 0's, with every rank's equal
            every = [None] * mesh.size
            dist.all_gather_object(every, _np(db))
            out[key + "/db"] = _np(db)
            out[key + "/db_equal"] = all(np.array_equal(e, every[0]) for e in every)


def _worker(rank, world, store, work):
    import torch.distributed as dist

    init_group(rank, world, store)
    try:
        from repro_torch.launch.mesh import make_mesh

        inp = torch.load(os.path.join(work, "inputs.pt"))
        out = {}
        for shape in MESHES:
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            tag = "x".join(map(str, shape))
            for part in (_steps, _split, _toy, _budget_one, _mc, _plans, _bias_split):
                progress(work, rank, f"{tag}/{part.__name__}")
                t0 = time.perf_counter()
                part(mesh, tag, inp, out)
                out[f"time/{tag}/{part.__name__}"] = time.perf_counter() - t0
        for part in (_data_only, _trainer):
            progress(work, rank, part.__name__)
            t0 = time.perf_counter()
            part(inp, out)
            out[f"time/{part.__name__}"] = time.perf_counter() - t0
        progress(work, rank, "_resilience")
        t0 = time.perf_counter()
        _resilience(inp, out, work)
        out["time/_resilience"] = time.perf_counter() - t0
        progress(work, rank, "_elastic")
        _elastic(inp, out, work, rank)
        if rank == 0:
            torch.save(out, os.path.join(work, "results.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The test process's side
# ---------------------------------------------------------------------------


def _jax_arch():
    from repro.configs.base import ArchConfig

    return ArchConfig(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv=2,
                      d_ff=64, vocab=64, q_chunk=16, kv_chunk=16)


@pytest.fixture(scope="module")
def jax_init():
    from repro import compat
    from repro.optim import sgd
    from repro.train.train_step import init_state

    return init_state(compat.prng_key(0), _jax_arch(), sgd(0.1))


@pytest.fixture(scope="module")
def inputs(jax_init):
    from repro_torch import interop

    rs = np.random.RandomState(0)
    return {
        "params": interop.params_from_jax(jax_init.params, _arch(), device="cpu"),
        "tokens": torch.as_tensor(rs.randint(0, 64, (8, 16))),
        "lin_x": torch.as_tensor(rs.standard_normal((B, S, DIN)).astype(np.float32)),
        "lin_w": torch.as_tensor((rs.standard_normal((N, DIN)) / 4).astype(np.float32)),
        "lin_b": torch.as_tensor((rs.standard_normal((N,)) / 4).astype(np.float32)),
        "lin_g": torch.as_tensor(rs.standard_normal((B, S, N)).astype(np.float32)),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Spawn the 4 ranks once; their results (rank 0's), and the wall time."""
    return spawn_ranks(_worker, inputs, tmp_path_factory, alone_s=ALONE_S)


def _jax_mesh(tag):
    from repro import compat
    import jax

    shape = tuple(int(a) for a in tag.split("x"))
    return compat.make_mesh(shape, ("data", "model"), devices=jax.devices()[:4])


def _jax_sharded_exact_step(tag, jax_init, tokens):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import compat
    from repro.launch import sharding as shard
    from repro.optim import sgd
    from repro.train.train_step import TrainState, make_train_step

    mesh = _jax_mesh(tag)
    state = jax_init
    pspecs = shard.param_shardings(state.params, mesh)
    sshard = TrainState(params=pspecs, opt_state={k: pspecs for k in state.opt_state},
                        step=NamedSharding(mesh, P()))
    act = NamedSharding(mesh, P(("data",), None, None))
    step = make_train_step(_jax_arch(), sgd(0.1), None, mesh=mesh, act_sharding=act,
                           data_axes=("data",), model_axes=("model",))
    batch = {"tokens": np.asarray(tokens), "labels": np.asarray(tokens)}
    bspec = {k: NamedSharding(mesh, P("data", None)) for k in batch}
    step = jax.jit(step, in_shardings=(sshard, bspec, NamedSharding(mesh, P())))
    new, m = step(state, batch, compat.prng_key(STEP_SEED))
    return new, float(m["loss"])


def _port_leaves_from_jax(jax_params):
    from repro_torch import interop
    from repro_torch.tree import tree_leaves

    return [_np(t) for t in tree_leaves(interop.params_from_jax(jax_params, _arch(),
                                                                device="cpu"))]


@pytest.mark.parametrize("tag", TAGS)
def test_exact_sharded_step_matches_jax(ranks, jax_init, inputs, tag):
    """The exact sharded step (tp_sketch off) against JAX's on the same mesh
    shape: loss rtol 1e-4; parameters rtol 2e-3, atol 2e-4 (JAX's own
    tolerances for its sharded step)."""
    new, loss = _jax_sharded_exact_step(tag, jax_init, inputs["tokens"])
    np.testing.assert_allclose(ranks[f"{tag}/step/exact/loss"], loss, rtol=1e-4)
    for a, b in zip(ranks[f"{tag}/step/exact/params"], _port_leaves_from_jax(new.params)):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("name", ["exact", "mask"])
@pytest.mark.parametrize("tag", TAGS)
def test_mesh_step_matches_port_single_device(ranks, tag, name):
    """The exact and ``mask`` mesh steps against the port's single-device
    step from the same parameters, batch and seed (every replica draws the
    single-device plan): loss and every parameter within 1e-5."""
    np.testing.assert_allclose(ranks[f"{tag}/step/{name}/loss"], ranks[f"single/{name}/loss"],
                               rtol=1e-5)
    for a, b in zip(ranks[f"{tag}/step/{name}/params"], ranks[f"single/{name}/params"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tag", TAGS)
def test_split_exact_step_matches_jax_mesh_step(ranks, jax_init, inputs, tag):
    """The exact step on the local plans split over model against JAX's
    sharded exact step (GSPMD's partition of its local plan): loss and
    every parameter within 1e-5."""
    new, loss = _jax_sharded_exact_step(tag, jax_init, inputs["tokens"])
    np.testing.assert_allclose(ranks[f"{tag}/step/exact/loss"], loss, rtol=1e-5)
    for a, b in zip(ranks[f"{tag}/step/exact/params"], _port_leaves_from_jax(new.params)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tag", TAGS)
def test_split_sites_draw_the_single_device_plans_on_every_rank(ranks, tag):
    """Every rank of the ``mask`` step (l1, the local plans split over
    model) draws each site's plan over the whole width from the unfolded
    seed: the single device's kept columns, site for site (14 sites: 2
    layers of q, k, v, o, in, gate, out; the head stays exact)."""
    assert ranks[f"{tag}/split/plans"] == [(True, 14)] * WORLD


@pytest.mark.parametrize("tag", TAGS)
def test_split_sites_probes_equal_the_single_device_probes(ranks, tag):
    """The telemetry probe of every split site (its three statistics summed
    over the ranks holding the other columns, or its row norms over the
    ranks holding the rest of d_in, ``core/site.py`` ``MeshEnv.probe``)
    equals the single-device step's, site for site, within 1e-5."""
    single, mesh = ranks[f"{tag}/split/probes"]
    assert sorted(mesh) == sorted(single) and len(single) == 7
    for k in single:
        np.testing.assert_allclose(mesh[k], single[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("tag", TAGS)
def test_vocab_parallel_loss_equals_the_gathered_logits_loss(ranks, tag):
    """The untied head's logits stay split over the vocabulary and
    ``lm_loss`` reads them by a vocab-parallel log-sum-exp: equal to the
    loss of the gathered logits (rank 0's share, rtol 1e-6)."""
    got, want = ranks[f"{tag}/split/loss"]
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("tag", TAGS)
def test_split_step_flops_fall_with_the_model_axis(ranks, tag):
    """Rank 0's FlopCounterMode FLOPs of the exact step: each site computes
    its model shard and attention its heads, so the split layout's are 1 /
    n_model of the gathered layout's (1/4 on (1, 4), 1/2 on (2, 2), where
    the data axis already halves both)."""
    split, gathered = ranks[f"{tag}/split/flops"]
    n_mp = int(tag.split("x")[1])
    assert split * n_mp == pytest.approx(gathered, rel=1e-3)


def split_payload(D: int, M: int, r: int = 1) -> int:
    """The exact step's collective payload (bytes) on the local plans split
    over model, on a (D, M) ``("data", "model")`` mesh, from the shapes of
    the arch (2 layers, d 32, 4 heads, 2 kv of 8, d_ff 64 SwiGLU, vocab 64,
    untied) at batch 8 x 16 and remat "full" (``r`` recomputes), float32:

    * each site's shard (q, k, v, in, gate, the head: (model, data); o,
      out: (data, model)) all-gathered over data along d_in in the forward
      and the layer's recompute, its d_in-whole gradient reduce-scattered
      over data in the backward; the embedded rows' model chunks gathered;
    * per layer, each block's input entering its column sites through one
      ``copy_to`` (all-reduce of dX, backward) and o's and out's partial
      outputs all-reduced (forward; o's again in the recompute, which stops
      before out, the layer's last op); the head's ``copy_to``;
    * where the kv heads do not divide the model axis (the "flat" head
      layout): k and v gathered over model (forward and recompute) and
      their partial cotangents all-reduced;
    * the vocab-parallel loss: a ``pmax`` and two ``psum`` of [rows, S];
    * the step: the unsited leaves' gradients (5 norm gains, the table's
      [V, d / M]) and three metrics summed over data where it has ranks,
      and the squared norms of the 15 leaves sharded over both axes and of
      the one over model alone."""
    L, d, H, Kv, dh, F, V = 2, 32, 4, 2, 8, 64, 64
    rows, S = 8 // D, 16
    shards = (2 * H * dh + 2 * Kv * dh + 3 * F) * d // (M * D)
    head = V * d // (M * D)
    weights = (1 + r) * L * shards + head + D * (L * shards + head)
    acts = (L * (4 + r) + 1) * rows * S * d + rows * S * d // M
    kv = rows * S * 2 * Kv * dh
    flat = 0 if Kv % M == 0 else (1 + r) * L * kv // M + L * kv
    loss = 3 * rows * S
    step = (5 * d + V * d // M + 3 if D > 1 else 0) + 7 * L + 1 + 1
    return 4 * (weights + acts + flat + loss + step)


@pytest.mark.parametrize("tag", TAGS)
def test_split_exact_step_payload_from_the_shapes(ranks, tag):
    """The exact step's payload on the split local plans equals
    :func:`split_payload`'s count from the shapes, to the byte."""
    D, M = (int(a) for a in tag.split("x"))
    assert ranks[f"{tag}/step/exact/bytes"] == split_payload(D, M)


@pytest.mark.parametrize("name", ["exact_tp", "compact", "block", "block_cg"])
@pytest.mark.parametrize("tag", TAGS)
def test_tp_step_loss_is_exact_and_update_finite(ranks, tag, name):
    """The sketch is backward-only: every TP step's loss equals the exact
    single-device loss (rtol 1e-5); the update is finite and moves."""
    np.testing.assert_allclose(ranks[f"{tag}/step/{name}/loss"], ranks["single/exact/loss"],
                               rtol=1e-5)
    assert np.isfinite(ranks[f"{tag}/step/{name}/grad_norm"])
    assert all(np.isfinite(a).all() for a in ranks[f"{tag}/step/{name}/params"])
    if name == "exact_tp":  # Megatron exact: the single-device numbers
        for a, b in zip(ranks[f"{tag}/step/{name}/params"], ranks["single/exact/params"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tag", TAGS)
def test_compact_grads_match_scatter_path(ranks, tag):
    """Compact gradients on the mesh (rows with global indices, each rank's
    own rows updated) equal the dense scatter path for the same seed (JAX's
    test_sharded_compact_grads_match_scatter_path: rtol 2e-5, atol 2e-6)."""
    np.testing.assert_allclose(ranks[f"{tag}/step/block/loss"],
                               ranks[f"{tag}/step/block_cg/loss"], rtol=1e-5)
    np.testing.assert_allclose(ranks[f"{tag}/step/block/grad_norm"],
                               ranks[f"{tag}/step/block_cg/grad_norm"], rtol=1e-3)
    for a, b in zip(ranks[f"{tag}/step/block/params"], ranks[f"{tag}/step/block_cg/params"]):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name", ["compact", "block", "block_cg"])
@pytest.mark.parametrize("tag", TAGS[:1])
def test_compressed_collective_sends_fewer_bytes(ranks, tag, name):
    """On the (2, 2) mesh the sketched TP steps hand the collectives fewer
    bytes than the exact step of the same layout (exact sites on the TP
    plans): the compact dW block replaces the dense one in the data-axis
    reduction. (On (1, 4) there is no data reduction to compress, and the
    compact slot's all-gather of every model shard's rows costs more than
    it saves at this width: docs/port.md, "Distributed".)"""
    assert ranks[f"{tag}/step/{name}/bytes"] < ranks[f"{tag}/step/exact_tp/bytes"]


def _jax_tp_linear(kind, tag, inputs, cfg, key, *, slot=False, bias=False, probe=False):
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.core.compact_grad import CompactGrad
    from repro.core.sharded_sketch import (tp_exact_linear, tp_row_sketched_linear,
                                           tp_sketched_linear)
    from repro.nn.common import Ctx
    from repro.telemetry.probes import PROBE_WIDTH

    mesh = _jax_mesh(tag)
    ctx = Ctx(mesh=mesh, data_axes=("data",), model_axes=("model",), tp_sketch=True)
    x = jnp.asarray(inputs["lin_x"].numpy())
    w = jnp.asarray(inputs["lin_w"].numpy())
    b = jnp.asarray(inputs["lin_b"].numpy())
    g = jnp.asarray(inputs["lin_g"].numpy())
    n_mp = mesh.shape["model"]
    rows = N if kind == "row" else n_mp * (N // n_mp)
    sl = CompactGrad(rows=jnp.zeros((rows, DIN)), idx=jnp.zeros((rows,))) if slot else None
    ps = jnp.zeros((PROBE_WIDTH,), jnp.float32) if probe else None
    k = compat.prng_key(key)

    def loss(x_, w_, b_, sl_, ps_):
        kw = dict(b=b_ if bias else None)
        if kind == "exact":
            y = tp_exact_linear(x_, w_, ctx, **kw)
        else:
            fn = tp_row_sketched_linear if kind == "row" else tp_sketched_linear
            y = fn(x_, w_, ctx, cfg, k, sl_, pslot=ps_, **kw)
        return jnp.sum(y * g), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        x, w, b, sl, ps)
    return y, grads


@pytest.mark.parametrize("tag", TAGS)
def test_registry_estimator_routes_through_tp_column(ranks, inputs, tag):
    """JAX's toy first-r ``tp_shardable`` estimator through ``tp_column``
    (deterministic: each model shard keeps its first r columns): dX and dW
    equal JAX's within 1e-5, and dW's support is each shard's leading r
    rows."""
    import jax
    import jax.numpy as jnp

    from repro import api, compat
    from repro.core.sharded_sketch import tp_sketched_linear
    from repro.core.sketched_linear import _CompactEstimator
    from repro.core.sketching import ColumnPlan, SketchConfig, static_rank
    from repro.nn.common import Ctx

    class _Toy(_CompactEstimator):
        name = TOY
        tp_shardable = True

        def plan(self, cfg, G2d, w, key, *, want_compact=True, score_psum_axes=None):
            n = G2d.shape[-1]
            r = static_rank(cfg, n)
            p = jnp.full((n,), jnp.float32(r) / n)
            idx = jnp.arange(r, dtype=jnp.int32)
            return ColumnPlan(indices=idx, scales=1.0 / jnp.take(p, idx), gate=None, probs=p)

    if TOY not in api.registered_backends():
        api.register_estimator(_Toy())
    mesh = _jax_mesh(tag)
    ctx = Ctx(mesh=mesh, data_axes=("data",), model_axes=("model",), tp_sketch=True)
    cfg = SketchConfig(method="per_column", budget=0.5, backend=TOY)
    x = jnp.asarray(inputs["lin_x"].numpy())
    w = jnp.asarray(inputs["lin_w"].numpy())
    dx, dw = jax.grad(lambda x_, w_: jnp.sum(jnp.sin(tp_sketched_linear(
        x_, w_, ctx, cfg, compat.prng_key(2)))), argnums=(0, 1))(x, w)
    np.testing.assert_allclose(ranks[f"{tag}/toy/dx"], np.asarray(dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ranks[f"{tag}/toy/dw"], np.asarray(dw), rtol=1e-5, atol=1e-5)
    n_mp = mesh.shape["model"]
    n_loc = N // n_mp
    r_loc = static_rank(cfg, n_loc)
    got = ranks[f"{tag}/toy/dw"].reshape(n_mp, n_loc, DIN)
    assert np.abs(got[:, :r_loc]).sum() > 0
    np.testing.assert_array_equal(got[:, r_loc:], 0.0)


@pytest.mark.parametrize("kind,compact", [(k, c) for k in ("column", "column_block", "row")
                                          for c in (False, True)] + [("exact", False)],
                         ids=lambda v: v if isinstance(v, str) else ("compact" if v else
                                                                     "dense"))
@pytest.mark.parametrize("tag", TAGS)
def test_tp_plans_at_full_budget_match_jax(ranks, inputs, tag, kind, compact):
    """Every TP plan at budget 0.999 (every column kept with scale 1: no
    randomness; 1.0 is a no-op config in both packages) with a bias and a
    probe slot, against JAX's shard_map bodies: the forward, dX, dW (dense;
    or the compact rows with their global indices), db and the probe,
    within 1e-5."""
    from repro.core.sketching import SketchConfig

    cfg = SketchConfig(method="l1", budget=FULL, backend="compact",
                       block=4 if kind == "column_block" else 0)
    jk = "row" if kind == "row" else ("exact" if kind == "exact" else "column")
    y, (dx, dw, db, sl, probe) = _jax_tp_linear(jk, tag, inputs, cfg, 11, slot=compact,
                                               bias=True, probe=kind != "exact")
    key = f"{tag}/one/{kind}/{'compact' if compact else 'dense'}"
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ranks[key + "/y"], np.asarray(y), **tol)
    np.testing.assert_allclose(ranks[key + "/dx"], np.asarray(dx), **tol)
    np.testing.assert_allclose(ranks[key + "/db"], np.asarray(db), **tol)
    if compact:
        np.testing.assert_allclose(ranks[key + "/rows"], np.asarray(sl.rows), **tol)
        np.testing.assert_array_equal(ranks[key + "/idx"], np.asarray(sl.idx).astype(np.int64))
    else:
        np.testing.assert_allclose(ranks[key + "/dw"], np.asarray(dw), **tol)
    if kind != "exact":
        np.testing.assert_allclose(ranks[key + "/probe"], np.asarray(probe), rtol=1e-5)


def _exact_grads(x, w, b=None):
    """dX, dW (and db) of sum(sin(x @ w.T + b)) in float64."""
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    z = x64 @ w64.T + (0.0 if b is None else b.astype(np.float64))
    G = np.cos(z)
    return G @ w64, G.reshape(-1, G.shape[-1]).T @ x64.reshape(-1, x64.shape[-1]), \
        G.reshape(-1, G.shape[-1]).sum(0)


def _assert_unbiased(draws, want, thresh=1.8):
    """JAX's MC check: deterministic entries equal (rtol 1e-3); elsewhere the
    mean t-statistic of mean - exact over the draws below ``thresh``."""
    mean, std = draws.mean(0), draws.std(0)
    scale = np.abs(want).max() + 1e-9
    det = std < 1e-5 * scale
    np.testing.assert_allclose(mean[det], want[det], rtol=1e-3, atol=1e-3 * scale)
    if det.all():
        return
    t = np.abs(mean[~det] - want[~det]) / (std[~det] / np.sqrt(len(draws)))
    assert np.mean(t) < thresh, np.mean(t)


@pytest.mark.parametrize("tag", TAGS)
def test_tp_sharded_sketch_unbiased_and_fwd_exact(ranks, inputs, tag):
    """JAX's test_tp_sharded_sketch_unbiased_and_fwd_exact: the column plan's
    forward is exact (1e-5) and dX, dW over 480 seeds are unbiased (mean
    t-statistic < 1.8)."""
    x, w = inputs["lin_x"].numpy(), inputs["lin_w"].numpy()
    np.testing.assert_allclose(ranks[f"{tag}/mc/sketch/y"], x @ w.T, rtol=1e-5, atol=1e-5)
    dx, dw, _ = _exact_grads(x, w)
    _assert_unbiased(ranks[f"{tag}/mc/sketch/dx"], dx)
    _assert_unbiased(ranks[f"{tag}/mc/sketch/dw"], dw)


@pytest.mark.parametrize("kind", ["column", "column_block", "row"])
@pytest.mark.parametrize("tag", TAGS)
def test_tp_probe_unbiased_vs_bruteforce(ranks, inputs, tag, kind):
    """JAX's test_tp_probe_unbiased_vs_bruteforce: over 384 seeds the probe's
    mean var equals the brute-force E||dŴ - dW||² and its g_sq ||dW||²
    (rel 0.15); ok is 1 exactly once."""
    x = inputs["lin_x"].numpy()[:2]
    g = inputs["lin_g"].numpy()[:2]
    dw_exact = g.reshape(-1, N).T.astype(np.float64) @ x.reshape(-1, DIN).astype(np.float64)
    dws = ranks[f"{tag}/mc/probe/{kind}/dw"]
    var_mc = float(np.mean(np.sum(np.square(dws - dw_exact[None]), axis=(1, 2))))
    pm = ranks[f"{tag}/mc/probe/{kind}/probe"].mean(0)
    assert pm[3] == pytest.approx(1.0)
    assert pm[1] == pytest.approx(var_mc, rel=0.15), (kind, pm, var_mc)
    assert pm[0] == pytest.approx(float(np.sum(dw_exact ** 2)), rel=0.15)


@pytest.mark.parametrize("role,kind", [("attn_q", "tp_column"), ("mlp_out", "tp_row")])
@pytest.mark.parametrize("tag", TAGS)
def test_tp_bias_sites_route_sharded_and_grads_unbiased(ranks, inputs, tag, role, kind):
    """JAX's test_tp_bias_sites_route_sharded_and_grads_unbiased: a bias site
    resolves to its TP plan with compact rows, its forward (bias included)
    is exact, and dW and db over 480 seeds are unbiased."""
    assert ranks[f"{tag}/mc/bias/{role}/kind"] == kind
    assert ranks[f"{tag}/mc/bias/{role}/rows"] is not None
    x = inputs["lin_x"].numpy()[:2]
    w, b = inputs["lin_w"].numpy(), inputs["lin_b"].numpy()
    np.testing.assert_allclose(ranks[f"{tag}/mc/bias/{role}/y"], x @ w.T + b, rtol=1e-5,
                               atol=1e-5)
    _, dw, db = _exact_grads(x, w, b)
    _assert_unbiased(ranks[f"{tag}/mc/bias/{role}/dw"], dw)
    _assert_unbiased(ranks[f"{tag}/mc/bias/{role}/db"], db)


@pytest.mark.parametrize("tag", TAGS)
def test_replicas_share_plans_and_model_shards_differ(ranks, tag):
    """Over 16 seeds: every data replica draws the same plan as its model
    shard's other replicas (the scores are summed over data, the seed is
    shared); all model shards draw the same row plan; the column plans of
    the model shards (the seed folded with the model rank, each its own G)
    differ for some seed."""
    for lk in ("column", "row"):
        by = {}
        for di, mi, plans in ranks[f"{tag}/plans/{lk}"]:
            by.setdefault(mi, set()).add(tuple(plans))
        assert all(len(v) == 1 for v in by.values()), (lk, by)
        per_shard = [next(iter(v)) for _, v in sorted(by.items())]
        if lk == "row":
            assert len(set(per_shard)) == 1
        elif len(per_shard) > 1:
            differ = [len(set(p[s] for p in per_shard)) > 1 for s in range(PLAN_SEEDS)]
            assert any(differ), per_shard


@pytest.mark.parametrize("backend", DATA_ONLY_BACKENDS)
def test_every_backend_on_a_data_only_mesh_matches_single_device(ranks, backend):
    """On the data-only mesh (4, 1) every backend's local plan draws the
    single-device plan (scores and plan-carry refreshes summed over data):
    loss and every parameter and carry leaf within 1e-5 of one device."""
    key = f"data_only/{backend}"
    np.testing.assert_allclose(ranks[key + "/mesh/loss"], ranks[key + "/single/loss"],
                               rtol=1e-5)
    for a, b in zip(ranks[key + "/mesh/params"], ranks[key + "/single/params"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_adaptive_schedule_under_tp_sketch(ranks):
    """JAX's test of the same name: under ``tp_sketch`` on the (2, 2) mesh the
    adaptive controller reads the TP probes (no "cannot measure" warning),
    runs only its pre-built buckets and switches between them, with a
    finite ``probe_snr``."""
    import math

    hist = ranks["trainer/hist"]
    assert not ranks["trainer/warned"]
    assert ranks["trainer/builds"] == len(ranks["trainer/buckets"])
    assert all(h["budget"] in ranks["trainer/buckets"] for h in hist)
    assert len({h["budget"] for h in hist}) >= 2
    assert all(math.isfinite(h["probe_snr"]) for h in hist if "probe_snr" in h)
    assert all(math.isfinite(h["loss"]) for h in hist) and len(hist) == 8


def test_ckpt_io_faults_under_a_mesh_recover_on_every_rank(ranks):
    """A failed async write of rank 0, surfaced at a later save's wait and at
    the loop's last wait, is retried synchronously by every rank together
    (the ranks finished: no rank waited alone in a gather); each retry wrote
    its step, the failed step 2 is not on disk, and the newest checkpoint
    restores onto the mesh bit for bit."""
    for events in ranks["resilience/events"]:
        assert events == [("ckpt_io_recovered", 3), ("ckpt_io_recovered", 6)]
    assert ranks["resilience/steps_on_disk"] == [4, 6]
    assert ranks["resilience/step4_shards"] is True
    assert ranks["resilience/final_restores"] is True


@pytest.mark.parametrize("shape", ["x".join(map(str, s)) for s, _ in ELASTIC])
def test_elastic_restore_across_meshes(ranks, shape):
    """A checkpoint of the (2, 2) step's state restores through
    ``resume_on_mesh`` onto (4, 1), (2, 2), (1, 4) and (1, 2, 2) ``("pod",
    "data", "model")``, every parameter and moment bit for bit."""
    assert ranks[f"elastic/{shape}"] is True


def test_mesh_without_process_group_raises():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    if dist.is_initialized():
        pytest.skip("a process group is initialised in this process")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), ("data", "model"), device="cpu")


@pytest.mark.parametrize("run", BIAS_RUNS)
@pytest.mark.parametrize("kind", ["column", "row"])
@pytest.mark.parametrize("tag", TAGS)
def test_biased_split_site_matches_single_device(ranks, tag, kind, run):
    """A biased site split over model (a column-parallel rank adds its chunk
    of b, its db from its own columns; a row-parallel site adds b once to
    the sum over model, db whole), exact and ``pallas`` l1 block 128 at
    budgets 0.5 and 0.999, the plan drawn from the site's generator,
    against the port's single-device biased site with the same generator:
    y, dX, dW and db within 1e-5, and db the same on every rank."""
    from repro_torch import rng
    from repro_torch.core import site

    x, w, b = (torch.as_tensor(a).requires_grad_(True) for a in _bias_arrays()[:3])
    g = torch.as_tensor(_bias_arrays()[3])
    cfg = _bias_cfg(run)
    gen = None if cfg is None else rng.generator(BIAS_SITE_SEED, "cpu")
    y = site.sketched_site(cfg, x, w, b, gen)
    dx, dw, db = torch.autograd.grad((y * g).sum(), (x, w, b))
    key = f"{tag}/bias/{kind}/{run}"
    assert ranks[key + "/db_equal"]
    for name, want in (("y", y), ("dx", dx), ("dw", dw), ("db", db)):
        np.testing.assert_allclose(ranks[f"{key}/{name}"], _np(want), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("run", ["exact", "pallas_full"])
@pytest.mark.parametrize("kind", ["column", "row"])
@pytest.mark.parametrize("tag", TAGS)
def test_biased_split_site_matches_jax_tp_plans(ranks, tag, kind, run):
    """The biased split site against JAX's TP plans with a bias on the same
    mesh (``repro/core/site.py:299-310``): column-parallel against
    ``tp_exact_linear`` (exact) and ``tp_sketched_linear`` (``tp_column``),
    row-parallel against ``tp_row_sketched_linear`` (``tp_row``), JAX's at
    budget 0.999 and block 128 (every block kept with scale 1, the exact
    numbers): y, dX, dW and db within 1e-5."""
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.core.sharded_sketch import (tp_exact_linear, tp_row_sketched_linear,
                                           tp_sketched_linear)
    from repro.core.sketching import SketchConfig
    from repro.nn.common import Ctx

    ctx = Ctx(mesh=_jax_mesh(tag), data_axes=("data",), model_axes=("model",), tp_sketch=True)
    cfg = SketchConfig(method="l1", budget=FULL, backend="compact", block=BLOCK_B)
    x, w, b, g = (jnp.asarray(a) for a in _bias_arrays())

    def loss(x_, w_, b_):
        if kind == "row":
            y = tp_row_sketched_linear(x_, w_, ctx, cfg, compat.prng_key(3), b=b_)
        elif run == "exact":
            y = tp_exact_linear(x_, w_, ctx, b=b_)
        else:
            y = tp_sketched_linear(x_, w_, ctx, cfg, compat.prng_key(3), b=b_)
        return jnp.sum(y * g), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(x, w, b)
    key = f"{tag}/bias/{kind}/{run}"
    for name, want in zip(("y", "dx", "dw", "db"), (y,) + tuple(grads)):
        np.testing.assert_allclose(ranks[f"{key}/{name}"], np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
