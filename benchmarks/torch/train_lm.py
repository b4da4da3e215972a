"""End-to-end driver: train a ~100M-parameter LM with sketched backprop (port
of ``examples/train_lm.py``).

    PYTHONPATH=src python -m benchmarks.torch.train_lm --steps 300    # lm-100m, the card
    PYTHONPATH=src python -m benchmarks.torch.train_lm --tiny --device cpu --steps 12 --ckpt /tmp/ck

Through the :class:`repro_torch.api.Runtime` front door: lm-100m (12 layers,
d_model 768, d_ff 2048, vocab 32000, float32), synthetic bigram LM data with
host prefetch onto the device, AdamW with a cosine schedule, the l1 @ 0.2
policy on the ``pallas`` backend with 128-column blocks (the policy of the
port's other lm-100m paths; ``--backend`` and ``--block`` change it), async
checkpoints with auto-resume (``--ckpt``; a second run prints ``[trainer]
resumed from step N``), and a budget schedule: reactive straggler buckets
(``--straggler``), exact warm-up (``--warmup-exact N``) or the closed-loop
SNR-adaptive schedule (``--adaptive-budget SNR``, probes included); add
``--telemetry-jsonl PATH`` for per-step records. It runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

from repro_torch.api import (BudgetSchedule, ExecutionConfig, Runtime, SketchConfig,
                             SketchPolicy, TelemetryConfig)
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import prefetch
from repro_torch.data.synthetic import LMStream
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.trainer import TrainerConfig


def arch_100m(tiny: bool) -> ArchConfig:
    if tiny:
        return ArchConfig(name="lm-tiny", family="dense", n_layers=2, d_model=128,
                          n_heads=4, n_kv=2, d_ff=512, vocab=512, q_chunk=64, kv_chunk=64)
    # ~100M params: 12L, d=768, ff=2048, vocab 32k
    return ArchConfig(name="lm-100m", family="dense", n_layers=12, d_model=768,
                      n_heads=12, n_kv=12, d_ff=2048, vocab=32000, q_chunk=128, kv_chunk=256)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--budget", type=float, default=0.2)
    ap.add_argument("--method", default="l1")
    ap.add_argument("--backend", default="pallas")
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--exact", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--straggler", action="store_true")
    ap.add_argument("--warmup-exact", type=int, default=0,
                    help="run exact backprop for N steps, then sketched")
    ap.add_argument("--adaptive-budget", type=float, default=0.0, metavar="SNR",
                    help="closed-loop budget control: run the cheapest pre-built bucket "
                         "whose probe-predicted gradient SNR stays above this target")
    ap.add_argument("--telemetry-jsonl", default=None,
                    help="write per-step telemetry records to this JSONL file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = arch_100m(args.tiny)
    policy = None if args.exact else SketchPolicy(base=SketchConfig(
        method=args.method, budget=args.budget, backend=args.backend, block=args.block))
    if args.straggler and policy is not None:
        schedule = BudgetSchedule.straggler((1.0, 0.5, 0.2))
    elif args.warmup_exact and policy is not None:
        schedule = BudgetSchedule.warmup_exact(args.warmup_exact)
    elif args.adaptive_budget > 0 and policy is not None:
        schedule = BudgetSchedule.adaptive(target_snr=args.adaptive_budget,
                                           budgets=(1.0, 0.5, 0.2, 0.1))
    else:
        schedule = BudgetSchedule()
    execution = ExecutionConfig()
    if args.telemetry_jsonl or (args.adaptive_budget > 0 and policy is not None):
        execution = ExecutionConfig(telemetry=TelemetryConfig(jsonl=args.telemetry_jsonl))
    runtime = Runtime(policy=policy, schedule=schedule, execution=execution,
                      device=args.device)
    opt = adamw(cosine_warmup(3e-4, max(10, args.steps // 20), args.steps),
                weight_decay=0.1, clip=1.0)
    stream = LMStream(vocab=cfg.vocab, seed=0)
    data = prefetch(stream.batches(args.batch, args.seq), size=2, device=runtime.device)
    tcfg = TrainerConfig(steps=args.steps, log_every=max(1, args.steps // 30),
                         ckpt_dir=args.ckpt, ckpt_every=max(10, args.steps // 5))
    state, history = runtime.train(cfg, opt, data, tcfg)
    if history:
        first, last = history[0]["loss"], history[-1]["loss"]
        print(f"\nloss: {first:.4f} -> {last:.4f} over {args.steps} steps "
              f"({'exact' if args.exact else f'{args.method}@{args.budget}'})")
    return state, history


if __name__ == "__main__":
    main()
