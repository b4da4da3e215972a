"""The supervisor's ``device_loss`` re-shard on CPU gloo ranks (JAX's
``tests/test_resilience.py::test_device_loss_reshards_and_keeps_descending``).

One rank group of 4 ranks (the gloo files' harness,
``test_torch_distributed_families.spawn_ranks``) trains yi-6b's smoke config
with exact steps only (``policy=None``, as JAX's test: no plan to draw, so
the steps on either mesh are comparable), AdamW, 14 steps of ``LMStream``
batches of 8 x 16, a checkpoint every 3 steps, and a ``device_loss`` fault
at step 7. Two scenarios, in this order:

* (2, 2) -> (1, 4) on the same four ranks: the process group stays, the
  mesh is rebuilt over it;
* (2, 2) -> (2, 1): the survivors are a prefix of the old rank order (ranks
  0 and 1), the process group is re-formed on them
  (``elastic.regroup``), and ranks 2 and 3 leave ``Supervisor.run`` with no
  state and a ``device_lost`` event. This runs last: it ends the group of
  four. Each rank that left saves its results to a file of its own, which
  rank 0 merges.

For each: the ``device_loss_reshard`` event's fields (JAX's), the state the
supervisor resumed from (``elastic.resume_on_mesh``, spied) bit for bit the
checkpoint's host restore of the same step, the runtime rebound to the new
mesh, the run finished at step 14, and the loss still descending.
"""
from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from test_torch_distributed_families import (WORLD, flat, gather_whole, init_group, progress,
                                             spawn_ranks)

ALONE_S = 40  # the rank group's time alone (spawning included; see SLOWDOWN)
NAME = "yi_6b"
STEPS, FAULT_STEP, CKPT_EVERY = 14, 7, 3
SCENARIOS = {"same_ranks": ((2, 2), (1, 4)), "fewer_ranks": ((2, 2), (2, 1))}
LEFT_WAIT_S = 120  # rank 0's wait for the files of the ranks that left


def _opt():
    from repro_torch.optim import adamw, constant

    return adamw(constant(1e-2), clip=1.0)


def _tree(state) -> dict:
    return {"params": state.params, "opt_state": state.opt_state}


def scenario(tag, work, out):
    """One supervised run of :data:`SCENARIOS` ``tag`` on this rank: its
    events, history and (a survivor) final state, the mesh it ended on, and
    the state resumed at the seam beside rank 0's host restore of its step."""
    import torch.distributed as dist

    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.synthetic import LMStream
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.resilience import FaultPlan, FaultSpec, ResilienceConfig, Supervisor
    from repro_torch.train import checkpoint as ckptlib
    from repro_torch.train import elastic
    from repro_torch.train.train_step import init_state
    from repro_torch.train.trainer import TrainerConfig

    old, new = SCENARIOS[tag]
    cfg = smoke_config(NAME)
    mesh = make_mesh(old, ("data", "model"), device="cpu")
    rt = Runtime(policy=None, device="cpu",
                 execution=ExecutionConfig(mesh=mesh, resilience=ResilienceConfig()))
    plan = FaultPlan(faults=(FaultSpec(step=FAULT_STEP, kind="device_loss", mesh_shape=new),))
    ckpt_dir = os.path.join(work, f"ckpt_{tag}")
    tcfg = TrainerConfig(steps=STEPS, log_every=2, ckpt_dir=ckpt_dir, ckpt_every=CKPT_EVERY,
                         seed=1)
    sup = Supervisor(rt, cfg, _opt(), tcfg, fault_plan=plan)
    seam = {}
    real = elastic.resume_on_mesh

    def spy(ckpt_dir_, like, mesh_, **kw):
        state, step = real(ckpt_dir_, like, mesh_, **kw)
        seam["step"] = step
        seam["state"] = gather_whole(_tree(state), mesh_)
        if dist.get_rank() == 0:
            whole = init_state(0, cfg, _opt(), device="cpu")
            host, hstep = ckptlib.restore(ckpt_dir_, whole, step=step, device="cpu")
            seam["host"], seam["host_step"] = flat(_tree(host)), hstep
        return state, step

    elastic.resume_on_mesh = spy
    t0 = time.perf_counter()
    try:
        state, hist = sup.run(LMStream(cfg.vocab, seed=0).batches(8, 16))
    finally:
        elastic.resume_on_mesh = real
    res = {"events": [dict(e) for e in sup.events], "history": hist, "seam": seam,
           "wall_s": time.perf_counter() - t0, "left": state is None}
    if state is not None:
        now = sup.runtime.execution.mesh
        res["mesh"] = tuple(now.devices_shape)
        res["step"] = int(state.step)
        res["final"] = gather_whole(_tree(state), now)
    out[f"{tag}/{dist.get_rank() if dist.is_initialized() else 'left'}"] = res


def _worker(rank, world, store, work):
    init_group(rank, world, store)
    out = {}
    try:
        for tag in SCENARIOS:
            progress(work, rank, tag)
            scenario(tag, work, out)
            if f"{tag}/left" in out:  # this rank is off the surviving mesh
                out[f"{tag}/{rank}"] = out.pop(f"{tag}/left")
    finally:
        _finish(rank, out, work)


def _finish(rank, out, work):
    """Rank 0 saves every rank's results: the survivors' through the
    (re-formed) group, those of the ranks that left from their files."""
    import torch.distributed as dist

    if not dist.is_initialized():
        path = os.path.join(work, f"left.{rank}.pt")
        torch.save(out, path + ".part")
        os.replace(path + ".part", path)  # whole when it appears
        return
    try:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, out)
        if rank == 0:
            merged = {k: v for part in every for k, v in part.items()}
            deadline = time.monotonic() + LEFT_WAIT_S
            for r in range(dist.get_world_size(), WORLD):
                path = os.path.join(work, f"left.{r}.pt")
                while not os.path.exists(path) and time.monotonic() < deadline:
                    time.sleep(0.2)
                if os.path.exists(path):
                    merged.update(torch.load(path, weights_only=False))
            torch.save(merged, os.path.join(work, "results.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The test process's side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(_worker, {}, tmp_path_factory, alone_s=ALONE_S)


def _survivors(tag):
    old, new = SCENARIOS[tag]
    return range(int(np.prod(new)))


@pytest.mark.parametrize("tag", list(SCENARIOS))
def test_device_loss_reshard_event_fields(ranks, tag):
    """Every survivor records one ``device_loss_reshard`` with JAX's fields:
    the fault's step, cause, the newest checkpoint's step (6), the steps
    lost (1), the old and new mesh shapes and the wall time; its runtime is
    rebound to the new mesh and the run ends at step 14. A rank outside the
    surviving mesh records one ``device_lost`` event and no re-shard, and
    ends with no state."""
    old, new = SCENARIOS[tag]
    for r in range(WORLD):
        res = ranks[f"{tag}/{r}"]
        if r in _survivors(tag):
            ev = [e for e in res["events"] if e["event"] == "device_loss_reshard"]
            assert len(ev) == 1, r
            e = ev[0]
            assert set(e) == {"event", "step", "cause", "resume_step", "steps_lost",
                              "old_mesh", "new_mesh", "wall_s"}
            assert (e["step"], e["cause"], e["resume_step"], e["steps_lost"]) == \
                (FAULT_STEP, "device_loss", 6, 1)
            assert e["old_mesh"] == list(old) and e["new_mesh"] == list(new)
            assert e["wall_s"] > 0
            assert not res["left"] and res["mesh"] == new and res["step"] == STEPS
            assert not any(e["event"] == "device_lost" for e in res["events"])
        else:
            assert res["left"] and "final" not in res
            lost = [e for e in res["events"] if e["event"] == "device_lost"]
            assert len(lost) == 1 and lost[0]["step"] == FAULT_STEP
            assert lost[0]["old_mesh"] == list(old) and lost[0]["new_mesh"] == list(new)
            assert not any(e["event"] == "device_loss_reshard" for e in res["events"])


@pytest.mark.parametrize("tag", list(SCENARIOS))
def test_device_loss_resumed_state_is_the_checkpoint(ranks, tag):
    """The state the supervisor resumed on the new mesh, gathered whole
    (parameters and AdamW moments), is the checkpoint's host restore of the
    same step bit for bit, on every survivor."""
    host = ranks[f"{tag}/0"]["seam"]["host"]
    assert ranks[f"{tag}/0"]["seam"]["host_step"] == 6
    for r in _survivors(tag):
        seam = ranks[f"{tag}/{r}"]["seam"]
        assert seam["step"] == 6
        assert sorted(seam["state"]) == sorted(host) and host
        for k, v in host.items():
            np.testing.assert_array_equal(seam["state"][k], v, err_msg=k)


@pytest.mark.parametrize("tag", list(SCENARIOS))
def test_device_loss_run_keeps_descending(ranks, tag):
    """The history across the seam (the first attempt's steps and the
    resumed ones) ends below where it started, and the survivors agree on
    the final state."""
    lead = ranks[f"{tag}/0"]
    losses = [h["loss"] for h in lead["history"]]
    assert losses[-1] < losses[0]
    print(f"{tag}: loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} logged "
          f"steps; the group ran {ranks['wall_s']:.1f} s")
    for r in _survivors(tag):
        final = ranks[f"{tag}/{r}"]["final"]
        for k, v in lead["final"].items():
            np.testing.assert_array_equal(final[k], v, err_msg=f"rank {r}: {k}")
