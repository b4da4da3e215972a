"""Resilience benchmark: wasted work and steps-to-recover under a fault drill
(port of ``benchmarks/bench_resilience.py``).

    PYTHONPATH=src python -m benchmarks.torch.bench_resilience [--steps N] [--full] \
        [--backend mask] [--device cuda]

The §5 MLP (784-64-64-10, l1 at budget 0.2 on the ``--backend``, JAX's
``mask`` by default) is trained twice through ``Supervisor`` and the
``Runtime``/``train_loop`` stack, with a checkpoint every ``ckpt_every``
steps:

1. **fault-free**: resilience on, no faults: the baseline trajectory (and
   the wall time the sentinel costs when nothing trips);
2. **faulted**: the same run under ``FaultPlan.drill`` (a checkpoint-write
   error, non-finite gradients, a loss spike, and a burst of consecutive
   trips that forces a checkpoint rollback).

Reported (``results/torch/resilience.json``, never ``BENCH_summary.json``):
``wasted_work_frac`` (Σ steps_lost over the recovery events / the steps
executed), ``steps_to_recover_mean`` / ``max`` (steps lost per rollback),
``loss_gap`` (|final faulted loss − final fault-free loss|), the sentinel
trips and each run's wall seconds, with the device they ran on. It runs on
the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from benchmarks.torch.common import save_result
from repro_torch.api import (ExecutionConfig, FaultPlan, ResilienceConfig, Runtime, SketchConfig,
                             SketchPolicy, Supervisor)
from repro_torch.data.synthetic import ClassStream
from repro_torch.models.mlp import mlp_arch
from repro_torch.optim import adamw, constant
from repro_torch.train.trainer import TrainerConfig

SIZES = (784, 64, 64, 10)


def _runtime(backend: str, device) -> Runtime:
    policy = SketchPolicy(base=SketchConfig(method="l1", budget=0.2, backend=backend))
    rcfg = ResilienceConfig(rollback_after=3, escalate_steps=4)
    return Runtime(policy=policy, execution=ExecutionConfig(resilience=rcfg), device=device)


def _one_run(runtime: Runtime, steps: int, ckpt_every: int, batch: int, workdir: str,
             plan: FaultPlan | None) -> dict:
    cfg = mlp_arch(SIZES)
    opt = adamw(constant(1e-3), clip=1.0)
    tcfg = TrainerConfig(steps=steps, log_every=max(1, steps // 10),
                         ckpt_dir=os.path.join(workdir, "ckpt"), ckpt_every=ckpt_every, seed=0)
    data = ClassStream(dim=SIZES[0], n_classes=SIZES[-1]).batches(batch)
    sup = Supervisor(runtime, cfg, opt, tcfg, fault_plan=plan)
    t0 = time.perf_counter()
    state, hist = sup.run(data, on_metrics=lambda m: None)
    if runtime.device.type == "cuda":
        torch.cuda.synchronize(runtime.device)
    wall = time.perf_counter() - t0
    return {"final_loss": float(hist[-1]["loss"]), "wall_s": wall,
            "n_recoveries": sup.recoveries, "events": sup.events}


def run(quick: bool = True, steps: int | None = None, batch: int = 64, backend: str = "mask",
        device="cuda") -> dict:
    runtime = _runtime(backend, device)
    dev = runtime.device
    steps = steps or (40 if quick else 200)
    ckpt_every = 5
    out = {"steps": steps, "ckpt_every": ckpt_every, "batch": batch, "sizes": list(SIZES),
           "backend": backend, "torch": torch.__version__,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}

    with tempfile.TemporaryDirectory() as d:
        out["fault_free"] = _one_run(runtime, steps, ckpt_every, batch, d, plan=None)
    plan = FaultPlan.drill(ckpt_every=ckpt_every)
    with tempfile.TemporaryDirectory() as d:
        out["faulted"] = _one_run(runtime, steps, ckpt_every, batch, d, plan=plan)

    recov = [e for e in out["faulted"]["events"] if e.get("event") == "rollback"]
    lost = [int(e.get("steps_lost", 0)) for e in recov]
    executed = steps + sum(lost)
    out["drill_faults"] = [[f.step, f.kind] for f in plan.faults]
    out["n_rollbacks"] = len(lost)
    out["wasted_work_frac"] = (sum(lost) / executed) if executed else 0.0
    out["steps_to_recover_mean"] = float(np.mean(lost)) if lost else 0.0
    out["steps_to_recover_max"] = max(lost) if lost else 0
    out["loss_gap"] = abs(out["faulted"]["final_loss"] - out["fault_free"]["final_loss"])
    out["sentinel_trips"] = sum(1 for e in out["faulted"]["events"]
                                if e.get("event") == "sentinel_trip")

    path = save_result("resilience", out)
    print(f"[{out['device']}, {backend}] fault-free loss {out['fault_free']['final_loss']:.4f} "
          f"({out['fault_free']['wall_s']:.2f} s) | faulted loss "
          f"{out['faulted']['final_loss']:.4f} ({out['faulted']['wall_s']:.2f} s) | trips "
          f"{out['sentinel_trips']} rollbacks {out['n_rollbacks']} | wasted work "
          f"{out['wasted_work_frac']:.3f} | steps-to-recover mean "
          f"{out['steps_to_recover_mean']:.1f} max {out['steps_to_recover_max']} -> {path}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--backend", default="mask")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(quick=not args.full, steps=args.steps, backend=args.backend, device=args.device)
