"""Continuous-batching serving example: queue -> slots -> paged KV decode (port
of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m benchmarks.torch.serve_lm                 # the card
    PYTHONPATH=src python -m benchmarks.torch.serve_lm --device cpu

Builds the example's small LM with random weights from seed 0 and submits
its mixed workload (heterogeneous prompt lengths and generation lengths)
through the :class:`repro_torch.api.Runtime` front door: ``Runtime.serve``
builds the continuous engine, and the :class:`repro_torch.api.ServeConfig`
fixes its built surface (slot count, per-slot KV budget, paged-cache geometry
and prefill buckets: one built prefill per bucket, see docs/port.md). Prints
what the JAX example prints, in the same format. It runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import Runtime, ServeConfig
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.serve.engine import Request


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = ArchConfig(name="serve-demo", family="dense", n_layers=4, d_model=256,
                     n_heads=8, n_kv=4, d_ff=1024, vocab=1024,
                     q_chunk=64, kv_chunk=64)
    params = lm.init_params(0, cfg, device=args.device)
    serve = ServeConfig(n_slots=4, max_len=96, page_size=16)
    eng = Runtime(device=args.device).serve(params, cfg, serve=serve)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, size=n).astype(np.int32),
                    max_new=m)
            for n, m in ((9, 12), (17, 3), (5, 12), (30, 2), (11, 8))]
    eng.run(reqs)
    for i, r in enumerate(reqs):
        print(f"req {i}: prompt_len={len(r.prompt)} stop={r.stop} "
              f"-> {r.out.tolist()}")

    t = eng.telemetry()
    print(f"served {len(reqs)} requests on {serve.n_slots} slots "
          f"({t['layout']} KV) | decode {t['decode_tok_per_s']:.0f} tok/s | "
          f"wasted decode steps {t['wasted_decode_steps']} | "
          f"compiles {t['trace_counts']} | "
          f"p50 latency {t['latency_p50_s'] * 1e3:.0f} ms")
    return t


if __name__ == "__main__":
    main()
