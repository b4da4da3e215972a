#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, the CUDA
toolkit and Triton. Phases, each of which raises on failure:

1. print the card (``nvidia-smi``) and the torch, CUDA and Triton versions;
2. build the kernels from the checkout's sources (``nvcc`` per CUDA source,
   all at once; Triton compiles at first launch) and print the build time;
3. hold each kernel against its plain PyTorch version at every shape of the
   slice's path, in float32 and bfloat16 (the fused kernel with and without
   its score output), printing the error against the stated tolerance and
   the kernel's, the plain version's, the bound's and the library call's times;
4. wiring check: one lm-100m step at budget 0.999 keeps every block of every
   sketched site with scale 1, runs both kernels at every site, and gives the
   exact-backprop gradients within tolerance;
5. the slice's main path: ``Runtime(...).train`` of lm-100m for 5 steps with
   the pallas / block-128 l1@0.2 policy, with the launch counts read around it;
6. a step breakdown: exact-backprop steps beside sketched ones, and a
   profiler trace of one step of each (device busy time, top device and
   host ops);
7. one JSON line listing the ported kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the rest of the checkout, it exits with a
non-zero code before printing any result.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

# lm-100m, the repo's end-to-end trainer config (examples/train_lm.py)
BATCH, SEQ, STEPS = 8, 256, 5
N_ROWS = BATCH * SEQ
# the slice's kernel shapes and their calls per step (84 sketched sites)
SCORE_SHAPES = {(N_ROWS, 768): 60, (N_ROWS, 2048): 24}
FUSED_SHAPES = {(768, 768, 1): 48, (2048, 768, 3): 24, (768, 2048, 1): 12}  # (n, d, rb)
BLOCK = 128
# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# float32: the kernels and the plain versions sum in different orders; the
# relative error of a K-term float32 dot product is ~sqrt(K)*2^-24 (3e-6 at
# K = 2048), so 1e-5 of the output's scale leaves headroom. bfloat16 outputs
# (dX, dWc) round the float32 result to 8 bits: one ulp is 2^-8 of the value.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
GRAD_RTOL = 2e-4  # lm-100m gradients: 12 layers of float32 reorderings


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph and
    replayed between two events, so the host's launch cost (Triton's Python
    launcher, ctypes) does not leave the card idle between calls. Inputs stay
    in the 50 MB L2 across calls, as the path's freshly written G largely does."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()  # first replay uploads the graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, dtype) -> dict:
    """The least time for the work: bytes over the memory rate, operations
    over the peak rate for the type, whichever is larger (milliseconds)."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / PEAK_OPS[dtype]
    return dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want, rel_tol) -> tuple:
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    tol = rel_tol * max(want.abs().max().item(), 1e-30)
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"kernel disagrees with its plain version: max|err| {err:.3e} > tol {tol:.3e}")
    return err, tol


def check_scores(gen, dev):
    from repro_torch.kernels import col_scores

    rows = []
    for (N, n), calls in SCORE_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            G = torch.randn((N, n), generator=gen, device=dev).to(dtype)
            for mode in ("l1", "l2"):
                got = col_scores.col_l1_scores(G, mode=mode)
                want = col_scores.col_l1_scores_plain(G, mode=mode)
                if not torch.equal(got, col_scores.col_l1_scores(G, mode=mode)):
                    raise AssertionError("col_l1_scores is not deterministic")
                err, tol = max_err(got, want, 1e-5)  # float32 sums, either input type
                op = torch.abs if mode == "l1" else torch.square
                ms = cuda_ms(lambda: col_scores.col_l1_scores(G, mode=mode))
                plain = cuda_ms(lambda: col_scores.col_l1_scores_plain(G, mode=mode))
                lib = cuda_ms(lambda: op(G).sum(0, dtype=torch.float32))
                row = dict(shape=[N, n], dtype=str(dtype).split(".")[-1], mode=mode,
                           calls=calls, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                           library_ms=lib,
                           **bound(N * n * G.element_size() + 4 * n, 2 * N * n, torch.float32))
                print(f"[kernel] col_l1_scores {row}")
                rows.append(row)
    return rows


def check_fused(gen, dev):
    from repro_torch.kernels import sketch_matmul as sm

    rows = []
    for (n, d, rb), calls in FUSED_SHAPES.items():
        nb = n // BLOCK
        idx = torch.sort(torch.randperm(nb, generator=gen, device=dev)[:rb]).values.to(torch.int32)
        scales = 1.0 + 4.0 * torch.rand(rb, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            G = torch.randn((N_ROWS, n), generator=gen, device=dev).to(dtype)
            W = (torch.randn((n, d), generator=gen, device=dev) * d ** -0.5).to(dtype)
            X = torch.randn((N_ROWS, d), generator=gen, device=dev).to(dtype)
            for with_scores in (False, True):
                args = (G, idx, scales, W, X)
                kw = dict(block=BLOCK, with_scores=with_scores, score_mode="l1")
                got = sm.block_gather_matmul_fused(*args, **kw)
                want = sm.block_gather_matmul_fused_plain(*args, **kw)
                torch.cuda.synchronize()
                errs = []
                for name, g, w in zip(("dX", "dWc", "db", "scores"), got, want):
                    tol = TOL[dtype] if name in ("dX", "dWc") else 1e-5
                    errs.append(max_err(g, w, tol)[0])
                if with_scores:
                    plain3 = sm.block_gather_matmul_fused(*args, block=BLOCK)
                    if not all(torch.equal(a, b) for a, b in zip(plain3, got[:3])):
                        raise AssertionError("with_scores changed dX, dWc or db")
                ms = cuda_ms(lambda: sm.block_gather_matmul_fused(*args, **kw))
                plain = cuda_ms(lambda: sm.block_gather_matmul_fused_plain(*args, **kw))
                isz = G.element_size()
                kept = rb * BLOCK
                n_bytes = (isz * (N_ROWS * kept + kept * d + 2 * N_ROWS * d + kept * d)
                           + 8 * rb + 4 * kept * (2 if with_scores else 1))
                n_ops = 4 * N_ROWS * kept * d + 2 * N_ROWS * kept * (2 if with_scores else 1)
                row = dict(shape=[N_ROWS, n, d, rb], dtype=str(dtype).split(".")[-1],
                           with_scores=with_scores, calls=calls, max_abs_err=max(errs),
                           ms=ms, plain_ms=plain, **bound(n_bytes, n_ops, dtype))
                print(f"[kernel] block_gather_matmul_fused {row}")
                rows.append(row)
    return rows


def lm100m():
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name="lm-100m", family="dense", n_layers=12, d_model=768,
                      n_heads=12, n_kv=12, d_ff=2048, vocab=32000,
                      q_chunk=128, kv_chunk=256)


def slice_policy(budget):
    from repro_torch.api import SketchConfig, SketchPolicy

    return SketchPolicy(base=SketchConfig(method="l1", budget=budget, backend="pallas",
                                          block=BLOCK))


def wiring_check(dev):
    """One lm-100m step at budget 0.999: every block kept with scale 1, both
    kernels at every site, gradients equal to exact backprop."""
    from repro_torch import rng
    from repro_torch.api import Runtime
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.optim import sgd
    from repro_torch.train.train_step import batch_to_device, init_state
    from repro_torch.tree import tree_leaves

    cfg = lm100m()
    state = init_state(rng.fold_in(11, 0), cfg, sgd(0.0), device=dev)
    batch = batch_to_device(next(LMStream(vocab=cfg.vocab, seed=11).batches(BATCH, SEQ)), dev)
    leaves = tree_leaves(state.params)
    step_key = rng.fold_in(11, 1)

    def grads(runtime):
        ctx = runtime.ctx(step_key, n_layers=cfg.n_layers)
        loss, _ = lm.lm_loss(state.params, batch, ctx, cfg, step_key)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss_e, g_exact = grads(Runtime(policy=None, device=dev))
    plans = []
    fused = ops.block_gather_matmul_fused

    def spy(G, block_idx, scales, W, X, **kw):
        plans.append((G.shape[1] // kw["block"], block_idx.clone(), scales.clone()))
        return fused(G, block_idx, scales, W, X, **kw)

    ops.reset_launch_counts()
    ops.block_gather_matmul_fused = spy
    try:
        loss_s, g_sk = grads(Runtime(policy=slice_policy(0.999), device=dev))
    finally:
        ops.block_gather_matmul_fused = fused
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    n_sites = 7 * cfg.n_layers
    if counts != {"col_l1_scores": n_sites, "block_gather_matmul_fused": n_sites}:
        raise AssertionError(f"budget-0.999 step launched {counts}, want {n_sites} each")
    if len(plans) != n_sites:
        raise AssertionError(f"{len(plans)} fused calls, want {n_sites}")
    for nb, idx, scales in plans:
        if idx.numel() != nb or not torch.equal(idx.cpu(), torch.arange(nb)) \
                or not torch.all(scales == 1.0):
            raise AssertionError(f"budget 0.999 dropped or rescaled a block: {idx} {scales}")
    if not torch.allclose(loss_s, loss_e, rtol=1e-6, atol=0):
        raise AssertionError(f"loss differs: {loss_s.item()} vs {loss_e.item()}")
    worst = 0.0
    for a, b in zip(g_sk, g_exact):
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, rel)
    if not worst <= GRAD_RTOL:
        raise AssertionError(f"sketched@0.999 vs exact gradients: max rel err {worst:.3e} > {GRAD_RTOL}")
    print(f"[wiring] budget 0.999: {n_sites} sites, every block kept with scale 1, "
          f"launches {counts}, loss {loss_e.item():.6f}, "
          f"max rel grad err {worst:.3e} (tol {GRAD_RTOL})")
    del state, g_exact, g_sk


def main_path(dev):
    """The slice: Runtime.train of lm-100m for STEPS steps, pallas l1@0.2."""
    from repro_torch.api import Runtime
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.tree import tree_leaves

    cfg = lm100m()
    runtime = Runtime(policy=slice_policy(0.2), device=dev)
    opt = adamw(cosine_warmup(3e-4, 15, 300), weight_decay=0.1, clip=1.0)
    data = LMStream(vocab=cfg.vocab, seed=0).batches(BATCH, SEQ)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    state, history = runtime.train(cfg, opt, data, steps=STEPS, log_every=1)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = 7 * cfg.n_layers * STEPS
    if counts != {name: want for name in counts}:
        raise AssertionError(f"main path launched {counts}, want {want} each")
    losses = [h["loss"] for h in history]
    if len(history) != STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite or missing losses: {losses}")
    if not all(torch.isfinite(p).all() for p in tree_leaves(state.params)):
        raise AssertionError("non-finite parameters after training")
    n_params = lm.num_params(state.params)
    step_ms = [1e3 * h["step_s"] for h in history]
    print(f"[train] lm-100m ({n_params} params), batch {BATCH}x{SEQ}, pallas l1@0.2 "
          f"block {BLOCK}: losses {losses}")
    print(f"[train] step ms {step_ms} (first includes warm-up); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {counts}")
    return counts


def _device_us(evt) -> float:
    # the attribute's name changed across torch releases
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def step_breakdown(dev, reps=3):
    """Where a step's time goes: lm-100m steps with exact backprop beside the
    slice's sketched steps (host clock around synchronised steps), and a
    profiler trace of one step of each: device-busy share and top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import rng
    from repro_torch.api import Runtime
    from repro_torch.data.synthetic import LMStream
    from repro_torch.optim import adamw, cosine_warmup

    cfg = lm100m()
    batches = [b for b, _ in zip(LMStream(vocab=cfg.vocab, seed=3).batches(BATCH, SEQ),
                                 range(reps + 2))]
    for label, policy in (("exact", None), ("pallas-l1@0.2", slice_policy(0.2))):
        runtime = Runtime(policy=policy, device=dev)
        opt = adamw(cosine_warmup(3e-4, 15, 300), weight_decay=0.1, clip=1.0)
        state = runtime.init_state(rng.fold_in(3, 0), cfg, opt)
        fn = runtime.train_step(cfg, opt)
        state, m = fn(state, batches[0], 1)  # warm-up
        float(m["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            state, m = fn(state, batches[1 + i], 2 + i)
        float(m["loss"])
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / reps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = fn(state, batches[-1], 99)
            float(m["loss"])
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        evts = prof.key_averages()
        kern = [e for e in evts if e.device_type == DeviceType.CUDA]
        busy_ms = sum(_device_us(e) for e in kern) / 1e3
        host = [e for e in evts if e.device_type == DeviceType.CPU]
        print(f"[breakdown] {label}: {step_ms:.1f} ms/step over {reps} steps; profiled step: "
              f"{wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms in "
              f"{sum(e.count for e in kern)} device ops, "
              f"{sum(e.count for e in host)} host ops; busy share of an unprofiled step "
              f"{100 * busy_ms / step_ms:.0f}%")
        for e in sorted(kern, key=_device_us, reverse=True)[:6]:
            print(f"[breakdown]   device {_device_us(e) / 1e3:8.2f} ms x{e.count:<5d} {e.key[:80]}")
        for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]:
            print(f"[breakdown]   host   {e.self_cpu_time_total / 1e3:8.2f} ms x{e.count:<5d} "
                  f"{e.key[:80]}")
        del state


def per_step(rows, key):
    return sum(r["calls"] * r[key] for r in rows)


def kernel_entry(name, route, source, replaces, launches, rows, err_rows, library):
    """One kernel's JSON entry: float32 times summed over one step's calls."""
    return dict(name=name, route=route, source=source, replaces=replaces,
                launches=launches, max_abs_err=max(r["max_abs_err"] for r in err_rows),
                ms=per_step(rows, "ms"), plain_ms=per_step(rows, "plain_ms"),
                bound_ms=per_step(rows, "bound_ms"),
                bound_by=("bytes" if per_step(rows, "bytes_ms") >= per_step(rows, "ops_ms")
                          else "operations"),
                library_ms=per_step(rows, "library_ms") if library else None)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    smi = smi_line()
    print(smi)
    import triton

    print(f"torch {torch.__version__} cuda {torch.version.cuda} triton {triton.__version__} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[build] nvcc {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    score_rows = check_scores(gen, dev)
    fused_rows = check_fused(gen, dev)
    print(f"[kernel] checks and timings {time.perf_counter() - t0:.1f} s (first calls "
          f"include Triton's compile)")

    wiring_check(dev)
    counts = main_path(dev)
    step_breakdown(dev)

    f32s = [r for r in score_rows if r["dtype"] == "float32" and r["mode"] == "l1"]
    f32f = [r for r in fused_rows if r["dtype"] == "float32" and not r["with_scores"]]
    kernels = [
        kernel_entry("col_l1_scores", "triton", "src/repro_torch/kernels/col_scores.py",
                     "src/repro/kernels/col_scores.py:42", counts["col_l1_scores"], f32s,
                     [r for r in score_rows if r["dtype"] == "float32"], library=True),
        kernel_entry("block_gather_matmul_fused", "cuda",
                     "src/repro_torch/kernels/csrc/block_gather_matmul_fused.cu",
                     "src/repro/kernels/sketch_matmul.py:210",
                     counts["block_gather_matmul_fused"], f32f,
                     [r for r in fused_rows if r["dtype"] == "float32"], library=False),
    ]
    print("# kernels: times are float32, summed over one step's calls at the slice's shapes")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
