"""How often a profiler trace misses a kernel event that was launched.

    python -m benchmarks.torch.trace_drops [N]

On a CUDA card: builds the kernels, then traces ``chip_smoke.py``'s phase-9
step (the paper's MLP at budget 0.2, 3 ``col_l1_scores`` launches) N times
(default 400), alternately with host and device activity and with device
activity alone. A trace whose raw device events or ``key_averages`` hold
fewer score-kernel events than the launch counters counted is printed, and
the last line gives how many of the N traces missed one. ``chip_smoke.py``'s
``traced_step`` re-traces a step for this reason.
"""
from __future__ import annotations

import sys

import torch

import chip_smoke


def trace_drops(dev, n: int) -> int:
    """The number of ``n`` traces of the MLP step that miss a score event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Runtime
    from repro_torch.kernels import ops

    params, loss_fn, opt, batches = chip_smoke.paper_setup("mlp", dev, 2)
    step = chip_smoke.paper_step_fn("mlp", Runtime(policy=chip_smoke.paper_policy("mlp", 0.2),
                                                   device=dev), params, loss_fn, opt)
    float(step(0, batches[0]))
    torch.cuda.synchronize()
    sym, missed = chip_smoke.KERNEL_SYMBOLS["col_l1_scores"], 0
    for i in range(n):
        host = i % 2 == 0
        acts = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
        ops.reset_launch_counts()
        with profile(activities=acts) as prof:
            float(step(1 + i, batches[1]))
            torch.cuda.synchronize()
        want = ops.launch_counts()["col_l1_scores"]
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        raw = sum(sym in e.name for e in evs)
        agg = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and sym in e.key)
        if raw != want or agg != want:
            missed += 1
            print(f"[trace-drop] trace {i} ({'host and device' if host else 'device'} activity): "
                  f"the counters {want} score launches, raw events {raw}, aggregate {agg}, "
                  f"{len(evs)} device events")
    print(f"[trace-drop] {missed} of {n} traces missed a score-kernel event")
    return missed


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_drops: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    print(chip_smoke.smi_line())
    build.build_all()
    trace_drops(torch.device("cuda", 0), int(sys.argv[1]) if len(sys.argv) > 1 else 400)
    return 0


if __name__ == "__main__":
    sys.exit(main())
