#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the CUDA
toolkit (every kernel is CUDA C++; Triton is not needed). Phases, each of
which raises on failure:

1. print the card (``nvidia-smi``) and the torch and CUDA versions;
2. build the kernels from the checkout's sources (``nvcc`` per CUDA source,
   all at once), print the build time and each kernel's registers, static
   shared memory and spills (``-Xptxas -v``);
3. hold each kernel against its plain PyTorch version at every shape of the
   slices' paths, in float32 and bfloat16, printing the error against the
   stated tolerance and the kernel's, the plain version's, the bound's and the
   library call's times: the score kernel (one launch, the same on a second
   call); the fused kernel with and without its score output, with the
   streaming kernel's time at the same shape beside it; the unfused dX / dW
   pair, which must equal the fused kernel's dX and dWc bit for bit; the
   streaming kernel (the fused kernel's pipelined dW and dX roles, from
   ``csrc/block_roles.cuh``, plus its own score role), whose dX, dWc, db and
   kept scores must equal the fused kernel's bit for bit, every output the
   same on a second call, and whose time is printed beside the fused
   kernel's; the flash-attention kernel (8 x 8 register microtiles, cp.async
   K/V) at the serving path's prefill shapes, at GQA, window and dh-128 sets,
   at the head widths it runs padded (dh 20, 24, 96) or at 256, and at one
   gemma3_1b-shaped prefill (4096 tokens, dh 256, window 512, bf16), the same
   on two calls, beside SDPA; the score kernel at vocabulary widths
   ([2048, 262144] and [2048, 151936]: more strips than one counter slot),
   against ``G.abs().sum(0)`` and bit for bit between eager and CUDA-graph
   replay, and on more than 64 streams at once;
4. wiring check: one lm-100m step at budget 0.999 under each of the
   ``pallas``, ``onepass`` and ``stale`` policies keeps every block of every
   sketched site with scale 1, launches each path's kernels at every site and
   no other kernel, gives the exact-backprop gradients within tolerance, and
   (plan carry) returns every site's plain column reduction of G as its
   refreshed carry;
5. the main paths: ``Runtime(...).train`` of lm-100m for 5 steps with the
   block-128 l1@0.2 policy under ``pallas``, ``onepass`` and ``stale``, and
   under ``pallas`` with compact gradients (``ExecutionConfig(compact_grads=
   True)``) and lazy AdamW, each with the launch counts set to 0 just before
   it and read just after; the carry's refresh checked after the plan-carry
   runs, and no sketched site's weight given a dense gradient on the compact
   path; then one lm-100m step with compact gradients on and off from the
   same parameters, batch and seed (AdamW), under ``pallas`` and ``stale``,
   whose parameters must agree;
6. a step breakdown: exact-backprop steps beside the three sketched ones and
   the compact-gradient ``pallas`` step (lazy AdamW), and a profiler trace of
   one step of each (device busy time, device ops, peak memory and the
   memory held when the optimizer starts, top device and host ops, and each
   of the path's kernels' in-step device time per step beside its warm-L2
   replay time from phase 3);
7. the serving main path: ``Runtime.prefill_step`` / ``decode_step`` of
   lm-100m with ``attn_impl="pallas"``, two waves of same-length prompts
   (8 x 1024, then 4 x 1000 tokens) and 32 greedy decode steps each, with the
   launch counts set to 0 just before it and read after each prefill and
   decode; the prefill logits held against the plain-attention forward, and
   every decode step's logits against the same generation with the plain
   attention, teacher-forced on the kernel run's tokens;
8. a serving breakdown: a profiler trace of one prefill and one decode step;
9. the paper's §5 models at App. B.2's widths (the 784-64-64-10 MLP at batch
   128, ViT d 192 depth 9 at batch 64, BagNet width 64 at batch 64): the
   score and fused kernels against their plain versions at every shape the
   models give them (N up to 65,536 rows, float32 tolerance by the sqrt(K)
   rule of ``sum_tol``); per model, one gradient at budget 0.999 equal to
   exact backprop's with exactly its listed launches and kernel shapes (MLP
   3 score / 0 fused, ViT 54 / 9, BagNet 12 / 9), and an exact-context
   evaluation that launches nothing; each model's main path, 5 training
   steps with its optimizer and the l1@0.2 block-128 pallas policy (the MLP
   through ``Runtime.train``), launch counts set to 0 just before and read
   just after, every loss finite; ``benchmarks/torch/quickstart.py``'s exact
   and sketched runs on seed 0; and a step breakdown per model, exact against
   sketched;
10. the trainer loop (``examples/train_lm.py``'s features) on lm-100m at
   batch 8 x 256 with AdamW and cosine warm-up: ``Runtime.train`` for 12
   steps under ``BudgetSchedule.adaptive`` (buckets exact, 1.0, 0.5, 0.1)
   with the ``pallas`` policy and a JSONL sink, launch counts read after
   every step: every budget one of the controller's buckets, two or more
   sketched buckets, 84 score and 84 fused launches per sketched step and
   none per exact step, a finite ``probe_snr`` at every sketched step, one
   record per step with the same ``probe_sites`` keys; the controller's
   per-step fetch against a constant schedule; one step of each backend
   with probes on and off from the same state (bit for bit, the same
   launches; device ops, busy and wall time, interleaved); a ``stale`` step
   at accum 2 (168 fused launches) against the mean of its two
   microbatches; and ``warmup_exact(2)`` for 6 steps straight against the
   same run stopped at step 3 and resumed by a fresh Runtime (losses, both
   checkpoints verified, a corrupted one refused with ``restore`` falling
   back, bytes and seconds per checkpoint);
11. the serving engines on lm-100m (``attn_impl="pallas"``, random weights
   from a seed): 32 requests from numpy (prompts of 16-768 tokens, max_new
   8-64) and one 1,100-token prompt that is left-truncated, no stop token,
   through ``Runtime.serve(params, cfg, serve=ServeConfig(n_slots=8,
   max_len=1024, page_size=16)).run`` (paged), the contiguous engine
   (``page_size=None``) and ``RunToCompletionEngine(batch=8,
   max_len=1024)``, each with the launch counts set to 0 just before ``run``
   and read after: every kernel 0 (every prefill batch carries segments);
   each engine's counters equal to what the scheduler's rules give for
   these requests; one build per prefill bucket used and one decode and
   insert; the telemetry printed (tokens/s, TTFT and latency percentiles,
   wasted decode steps); a sequential reference of 8 requests; greedy
   tokens equal in every run, or the first differing step a float32 near
   tie of the reference's teacher-forced logits; paged runs with
   ``ObsConfig`` on and off interleaved (identical tokens; a Chrome trace
   with one ``request`` span per request and its queued, prefill and decode
   children; ``serve.requests_done`` 33; the wall overhead); 3 ``pallas``
   training steps with ``ObsConfig`` on (``train_loop`` and ``train_step``
   spans, one compile-ledger entry per bucket, a memory-ledger peak above
   0); and a profiler trace of one engine decode step (device ops, busy
   time, exactly one device-to-host copy, the page gather's and scatter's
   device time and bytes) beside phase 8's plain decode step;
12. resilience around the lm-100m trainer (batch 8 x 256, block-128 l1@0.2,
   ``examples/train_lm.py``'s AdamW, ``ResilienceConfig(max_grad_norm=1e13)``:
   the sketched estimator's own norm reaches ~1e9-1e11 at this budget): under
   ``pallas`` and ``stale``, 4 steps with resilience off (``Runtime.train``)
   and on with no fault (``Supervisor``), in the order off, on, on, off:
   final states equal bit for bit, no trip, the same launches; under
   ``pallas``, ``onepass``, ``stale`` and compact ``pallas``, a ``nonfinite``
   and a ``spike`` fault through ``Supervisor``: each trips, the parameters,
   moments and carry are bit-identical through each tripped step, the next
   ``escalate_steps`` steps run exact with 0 launches, every leaf finite at
   the end; then ``FaultPlan.drill(ckpt_every=3)`` over 18 ``pallas`` steps
   with a checkpoint directory, a JSONL sink and ``ObsConfig`` on, against
   the same run with no fault: every fault fired, the failed checkpoint write
   retried synchronously and verified, one rollback to step 12 (3 steps
   lost), the final loss within JAX's rule of the clean run's, the records in
   the sink, the launches equal to what the sentinel's rules give on the host
   (0 on the exact steps), one step build per bucket across both attempts,
   the allocator back at the clean run's level; the synchronous save's and
   the rollback's seconds and the wasted-work fraction printed;
13. the model families from the named-config registry: all ten named configs
   pass the decoder check and their smoke configs build on the card, an
   unknown family refused by name;
   ``sample_independent`` on NaN probabilities on the card (nothing kept, no
   assert); the score, fused and stream kernels at olmoe-1b-7b's and
   gemma3-1b's l1@0.2 shapes (expert buckets of 320 rows, an all-zero bucket
   among them) and flash at their prefills, against the plain versions;
   olmoe-1b-7b (d 2048, 64 experts top-8, expert d_ff 1024, vocab 50,304;
   cut to 2 of 16 layers and float32) and gemma3-1b (its full 26 layers,
   vocab 262,144; float32), each at batch 4 x 512: one gradient at budget
   0.999 equal to exact backprop's for every leaf (olmoe under ``pallas``,
   ``onepass`` and ``stale``, gemma3 under ``pallas``), then
   ``Runtime.train`` for 3 steps at l1@0.2 block 128 under each of those
   backends with the launch counts set to 0 before and read after (olmoe
   392 per kernel per step, 2 x (4 + 3 x 64) sites; gemma3 182), finite
   losses and aux, the replicas dropped by the capacity printed; one exact
   step beside one pallas step (ms, device-busy ms, device ops, idle share,
   peak memory; olmoe's pallas step timed but not profiled); serving
   through ``Runtime.prefill_step`` / ``decode_step`` with
   ``attn_impl="pallas"``: olmoe at its full 16 layers (4 x 512 prompts), gemma3 (2 x 2048 prompts, its local layers windowed at
   512 with ring caches), 16 greedy decode steps each, one flash launch per
   layer in prefill and none in decode, logits within LOGIT_RTOL of the same
   calls under plain attention (teacher-forced), MoE prompts whose routing
   swapped at a near tie (router margin below ROUTER_TIE) counted and left
   out of the comparison;
14. the SSM and hybrid families at full width (float32): the score, fused
   and stream kernels at rwkv6-3b's and zamba2-7b's l1@0.2 shapes (G up to
   [2048, 14336]) and flash at zamba's prefill (dh 112, run padded to 128),
   against the plain versions; rwkv6-3b (d 2560, 40 heads of 64, channel
   mix 8960, vocab 65,536; cut to 4 of 32 layers) and zamba2-7b (81 Mamba2
   layers at d 3584 with one shared attention block every 6; cut to 13
   layers, two periods and a one-layer remainder), each at batch 4 x 512
   and the full configs' chunk of 256: one gradient at budget 0.999 equal
   to exact backprop's for every leaf under ``pallas``, ``onepass`` and
   ``stale``, every exact gradient finite; ``Runtime.train`` for 3 steps per
   backend with the launch counts set to 0 before and read after (rwkv 32
   sites per step, zamba 53); one profiled ``pallas`` step each (ms,
   device-busy ms, device ops, idle share, peak memory); serving at full
   depth (rwkv 32 layers, zamba 81 with 13 shared applications) of 4 x 512
   prompts and 16 greedy decode steps: zamba's 13 flash launches per
   prefill and none in decode, logits against plain attention
   (teacher-forced), and prefill + one decode step against the full
   forward's last logits (JAX's prefill/decode consistency rule);
15. the VLM and audio families at full width (float32): the score, fused
   and stream kernels at qwen2-vl-2b's and seamless-m4t-large-v2's l1@0.2
   shapes (seamless's encoder and cross k/v sites at N 3,072) and flash at
   their prefills (qwen causal GQA 12:2 at dh 128; seamless's encoder
   without the causal mask at 768 x 768, its decoder's causal 512 x 512 and
   its cross-attention without the mask at Sq 512, Skv 768), against the
   plain versions; qwen2-vl-2b (14 of 28 layers, d 1536, M-RoPE, the vision
   stub's embeds and a 16 x 16 grid's positions [3, B, S]) and
   seamless-m4t-large-v2 (12 + 12 of 24 encoder + 24 decoder layers, d 1024,
   the audio stub's 768 frames) at batch 4 x 512 (the depths halved since
   layer remat, PR 29): one gradient at budget
   0.999 equal to exact backprop's for every leaf under each backend, every
   exact gradient finite; ``Runtime.train`` for 3 steps per backend with the
   launch counts set to 0 before and read after (qwen 98 sites per step,
   seamless 192), and a qwen ``stale`` step at accum 2 whose split takes
   the positions on axis 1 (2 x 98); one exact and one profiled ``pallas``
   step each; serving of 4 x 512 prompts (seamless over its 768 frames) and
   16 greedy decode steps: 28 (qwen) and 72 (seamless) flash launches per
   prefill and none in decode, logits against plain attention
   (teacher-forced), and prefill + one decode step against the forward;
16. the serving engines over every decoder family at full width and about
   a quarter of its depth (``FE_LAYERS``; float32, random weights from a
   seed), one family at a time: olmoe-1b-7b (4 of 16 layers, paged),
   gemma3-1b (8 of 26, contiguous over its 512-slot rings), rwkv6-3b (8 of
   32) and zamba2-7b (21 of 81), each prompt prefilled alone at its exact
   length, and qwen2-vl-2b (7 of 28, paged,
   text prompts at ``[3, 1, S]`` positions); 10 requests each from numpy
   (prompts of 16-768 tokens, the first two longer than 512, max_new 4-24)
   through ``Runtime.serve(..., ServeConfig(n_slots=4, max_len=1024,
   page_size=16)).run``, the same with ``page_size=None`` and
   ``RunToCompletionEngine(batch=4, max_len=1024)``, with the launch counts
   set to 0 before ``run`` and read after: every kernel 0; every counter
   equal to the scheduler's rules; the telemetry printed; the greedy tokens
   of 4 requests (the two long ones among them) against a sequential
   reference, equal or differing first at a float32 near tie of the
   reference's teacher-forced logits (olmoe at a capacity factor of
   E / top_k, where no replica drops; one more paged run at the published
   1.25 prints its dropped replicas and is not compared); and a profiler
   trace of one engine decode step of zamba2-7b and of gemma3-1b (device
   ops, busy time, exactly one device-to-host copy);
17. the distributed runtime on a one-rank NCCL mesh (lm-100m): one step with
   ``tp_sketch`` off equal to the single-device step bit for bit, the TP plans'
   sites and launches, their collective payloads (the local plan's equal to
   its count from the shapes), a checkpoint restored bit for bit, ms per
   step (``distributed(dev)``);
18. the analysis tooling (``analysis(dev)``): the lint over
   ``src/repro_torch`` with no finding and exactly the reviewed waivers;
   ``analyze_runtime`` on the card for lm-100m, olmoe-1b-7b (4 layers),
   gemma3-1b, rwkv6-3b (8), zamba2-7b (13), qwen2-vl-2b,
   seamless-m4t-large-v2, yi-6b (4) and mixtral-8x22b (1) at full width
   under the block-128 l1@0.2 ``pallas`` policy, the baseline gate green;
   and one forward and backward of each at 1 x 256 whose score and fused
   kernels each launch exactly the analyzer's count of sketched site
   applications;
19. every family under a one-rank NCCL mesh (``families_mesh(dev)``):
   olmoe-1b-7b (1 layer), mixtral-8x22b (1), gemma3-1b (6), rwkv6-3b (2),
   zamba2-7b (6 and the shared block), qwen2-vl-2b (2) and
   seamless-m4t-large-v2 (2 + 2) at full width, float32, block-128 l1@0.2:
   one mesh step bit for bit the single-device step with equal score and
   fused launches; the TP plans' sites, launches and loss; olmoe's mesh
   checkpoint restored bit for bit; ms per step, single against mesh;
20. serving under a one-rank NCCL mesh (``serving_mesh(dev)``): lm-100m's
   serving main path (``attn_impl="pallas"``, waves 8 x 1024 and 4 x 1000,
   32 greedy steps) through ``Runtime(execution=ExecutionConfig(mesh=))``:
   12 flash_attention launches per prefill and none in decode, logits and
   tokens bit for bit the single device's, every prefill's and decode
   step's collective payload equal to ``serve_payload``'s count from the
   shapes; phase 11's paged and run-to-completion engines and one
   contiguous engine per phase-16 family (at its depth) on the mesh, their
   tokens equal to the single-device engines';
21. the dry run (``dry_run(dev)``; ``repro_torch.launch.dryrun``), run in a
   child process on the host CPU on fake tensors over a fake process group
   (started after the kernel checks, so it runs beside the card's phases):
   (a) lm-100m's training cell (batch 8 x 256, block-128 l1@0.2 ``pallas``,
   AdamW, a one-rank mesh) at remat "full" and "none", held against the
   same step on the card: payload equal to phase 17's formula and to the
   card's to the byte, 84 + 84 launches of rows 1 and 4, FlopCounterMode
   totals equal, the peak within ``DRY_PEAK_RTOL`` of the card's
   ``max_memory_allocated`` above what was allocated before the state, the
   card's steps at remat "full", "dots" and "none" bit for bit, with each
   one's ms per step, device-busy ms and peak side by side; the roofline
   terms beside them; (b) llama3-405b's
   ``train_4k`` cell on the (16, 16) mesh, ``mask``, sequence-parallel,
   from the depth model: per-rank peak GB, whether it fits the card's
   usable bytes (``HW.hbm_bytes``; the card's own ``total_memory`` printed
   beside it), the dominant term, the wire GB and the seconds it took;
22. one JSON line listing the ported kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Every profiled step whose kernels are counted is traced again (up to twice)
when its trace misses a launch that the counters saw: the profiler can drop
a kernel's event (``traced_step``; ``benchmarks/torch/trace_drops.py``
counts how often). The counters stay exact assertions.

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
sys.path.insert(0, ROOT)  # benchmarks/torch (the quickstart)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# lm-100m, the repo's end-to-end trainer config (examples/train_lm.py)
BATCH, SEQ, STEPS = 8, 256, 5
N_ROWS = BATCH * SEQ
# the slice's kernel shapes and their calls per step (84 sketched sites)
SCORE_SHAPES = {(N_ROWS, 768): 60, (N_ROWS, 2048): 24}
# (n, d, rb): the fused kernel under pallas and stale, the streaming kernel
# under onepass, and the unfused pair that would replace the fused kernel
FUSED_SHAPES = {(768, 768, 1): 48, (2048, 768, 3): 24, (768, 2048, 1): 12}
BLOCK = 128
BACKENDS = ("pallas", "onepass", "stale")
# the kernels each sketched site launches, per backend
SITE_KERNELS = {"pallas": ("col_l1_scores", "block_gather_matmul_fused"),
                "onepass": ("block_stream_matmul_fused",),
                "stale": ("block_gather_matmul_fused",)}
# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# float32: the kernels and the plain versions sum in different orders; the
# relative error of a K-term float32 dot product is ~sqrt(K)*2^-24 (3e-6 at
# K = 2048), so 1e-5 of the output's scale leaves headroom. bfloat16 outputs
# (dX, dWc) round the float32 result to 8 bits: one ulp is 2^-8 of the value.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
GRAD_RTOL = 2e-4  # lm-100m gradients: 12 layers of float32 reorderings
# the serving main path: (prompts, tokens per prompt) per wave, and the decode
# steps after each prefill (each gives one greedy token per prompt)
SERVE_WAVES = ((8, 1024), (4, 1000))
DECODE_STEPS = 32
SERVE_SEED = 5
# lm-100m logits, flash kernel against plain attention: 12 layers of float32
# sums in another order (~1e-6 relative each), compared to the largest logit
LOGIT_RTOL = 1e-4
# flash attention, (B, Sq, Skv, H, Kv, dh, causal, window) -> calls per
# prefill of its wave (one per layer); the last three are off the path
FLASH_SHAPES = {(8, 1024, 1024, 12, 12, 64, True, None): 12,
                (4, 1000, 1000, 12, 12, 64, True, None): 12,
                (2, 512, 1024, 12, 4, 64, True, None): 0,  # GQA, right-aligned
                (2, 1000, 1000, 12, 12, 64, True, 256): 0,  # window, ragged
                (2, 1024, 1024, 8, 8, 128, True, None): 0,  # dh 128
                # head widths run in the next instantiated one (64, 128, 256)
                # with zero-filled columns: gemma3_1b's smoke width 24, 96,
                # 20 (rows of 40 bytes in bf16: plain loads), and 256
                (2, 512, 512, 4, 2, 24, True, None): 0,
                (2, 512, 512, 4, 4, 96, True, 128): 0,
                (2, 384, 512, 4, 4, 96, False, None): 0,
                (2, 300, 300, 4, 2, 20, True, None): 0,
                (2, 512, 512, 4, 1, 256, True, None): 0,
                (1, 500, 500, 4, 1, 256, True, 100): 0,
                (1, 256, 512, 2, 2, 256, False, None): 0,
                # gemma3_1b's prefill: 4096 tokens, H 4, Kv 1, dh 256, window 512
                (1, 4096, 4096, 4, 1, 256, True, 512): 0}
GEMMA_FLASH = (1, 4096, 4096, 4, 1, 256, True, 512)
# the score kernel at vocabulary widths (a sketched lm_head): gemma3_1b's
# 262,144 in float32 and bf16, qwen2_vl_2b's 151,936 in float32; wider than
# the 1,024 strips of one counter slot in float32
SCORE_WIDE = ((N_ROWS, 262_144, torch.float32), (N_ROWS, 262_144, torch.bfloat16),
              (N_ROWS, 151_936, torch.float32))
SCORE_STREAMS = 80  # streams launching the score kernel at once (one slot each)
# compact against dense gradients, one lm-100m step: the JAX package's own
# tolerance for the same equivalence (tests/test_compact_grad.py)
COMPACT_RTOL, COMPACT_ATOL = 2e-5, 2e-6
# the training paths' kernels by (part of) their device function's name, as
# the profiler lists it
KERNEL_SYMBOLS = {"col_l1_scores": "col_scores_kernel", "block_gather_matmul_fused": "bgm_kernel",
                  "block_stream_matmul_fused": "stream_kernel"}


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph and
    replayed between two events, so the host's launch cost (ctypes, the
    wrappers' checks) does not leave the card idle between calls. Inputs stay
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


def check_scores_wide(gen, dev):
    """The score kernel at vocabulary widths (more strips than one counter
    slot holds, still one launch): against ``G.abs().sum(0)``, and bit for
    bit between the eager call and a CUDA-graph replay."""
    from repro_torch.kernels import col_scores

    rows = []
    for N, n, dtype in SCORE_WIDE:
        G = torch.randn((N, n), generator=gen, device=dev).to(dtype)
        before = col_scores.col_l1_scores.launches
        eager = col_scores.col_l1_scores(G)
        if col_scores.col_l1_scores.launches != before + 1:
            raise AssertionError("col_l1_scores took more than one launch")
        err, tol = max_err(eager, G.abs().sum(0, dtype=torch.float32), 1e-5)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = col_scores.col_l1_scores(G)
        for _ in range(2):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(out, eager):
                raise AssertionError(f"col_l1_scores at {[N, n]}: graph replay differs from "
                                     "the eager call")
        row = dict(shape=[N, n], dtype=str(dtype).split(".")[-1], mode="l1", calls=0,
                   max_abs_err=err, tol=tol, replay_bit_identical=True,
                   ms=cuda_ms(lambda: col_scores.col_l1_scores(G)),
                   plain_ms=cuda_ms(lambda: col_scores.col_l1_scores_plain(G)),
                   library_ms=cuda_ms(lambda: G.abs().sum(0, dtype=torch.float32)),
                   **bound(N * n * G.element_size() + 4 * n, 2 * N * n, torch.float32))
        print(f"[kernel] col_l1_scores wide {row}")
        rows.append(row)
        del G, eager, out, graph
    return rows


def check_score_streams(gen, dev):
    """The score kernel launched on SCORE_STREAMS streams at once (each
    stream's counters its own, allocated at its first launch), then captured
    on one more stream, whose counters are allocated during the capture, and
    replayed: every result the default stream's bits."""
    import ctypes

    from repro_torch.kernels import col_scores

    def new_stream():
        handle = ctypes.c_ulonglong(0)
        if torch.cuda.cudart().cudaStreamCreate(ctypes.addressof(handle)) != 0:
            raise RuntimeError("cudaStreamCreate failed")
        return torch.cuda.ExternalStream(handle.value, device=dev)

    Gs = [torch.randn((N_ROWS, 768), generator=gen, device=dev) for _ in range(4)]
    want = [col_scores.col_l1_scores(G) for G in Gs]
    torch.cuda.synchronize()
    streams = [new_stream() for _ in range(SCORE_STREAMS + 1)]
    try:
        outs = []
        for i, st in enumerate(streams[:-1]):
            st.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(st):
                outs.append(col_scores.col_l1_scores(Gs[i % 4]))
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=streams[-1]):
            out = col_scores.col_l1_scores(Gs[1])
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
    finally:
        torch.cuda.synchronize()
        for st in streams:
            torch.cuda.cudart().cudaStreamDestroy(st.cuda_stream)
    differ = sum(not torch.equal(o, want[i % 4]) for i, o in enumerate(outs))
    if differ or not torch.equal(out, want[1]):
        raise AssertionError(f"col_l1_scores on {SCORE_STREAMS} streams: {differ} results "
                             "differ from the default stream's")
    print(f"[kernel] col_l1_scores on {SCORE_STREAMS} streams at once and one more captured "
          f"in a graph: every result the default stream's bits ({len(col_scores._slots)} "
          f"counter slots in use)")


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
                stream = cuda_ms(lambda: sm.block_stream_matmul_fused(*args, block=BLOCK,
                                                                      score_mode="l1"))
                isz = G.element_size()
                kept = rb * BLOCK
                n_bytes = (isz * (N_ROWS * kept + kept * d + 2 * N_ROWS * d + kept * d)
                           + 8 * rb + 4 * kept * (2 if with_scores else 1))
                n_ops = 4 * N_ROWS * kept * d + 2 * N_ROWS * kept * (2 if with_scores else 1)
                row = dict(shape=[N_ROWS, n, d, rb], dtype=str(dtype).split(".")[-1],
                           with_scores=with_scores, calls=calls, max_abs_err=max(errs),
                           ms=ms, stream_ms=stream, plain_ms=plain,
                           **bound(n_bytes, n_ops, dtype))
                print(f"[kernel] block_gather_matmul_fused {row}")
                rows.append(row)
    return rows


def _block_problem(gen, dev, n, d, rb, dtype):
    nb = n // BLOCK
    idx = torch.sort(torch.randperm(nb, generator=gen, device=dev)[:rb]).values.to(torch.int32)
    scales = 1.0 + 4.0 * torch.rand(rb, generator=gen, device=dev)
    G = torch.randn((N_ROWS, n), generator=gen, device=dev).to(dtype)
    W = (torch.randn((n, d), generator=gen, device=dev) * d ** -0.5).to(dtype)
    X = torch.randn((N_ROWS, d), generator=gen, device=dev).to(dtype)
    return G, idx, scales, W, X


def check_unfused(gen, dev):
    """The unfused dX and dW kernels: against their plain versions, and bit
    for bit against the fused kernel's dX and dWc. ``calls`` is the fused
    kernel's count at the shape, the calls the pair would replace."""
    from repro_torch.kernels import sketch_matmul as sm

    rows = {"block_gather_matmul": [], "block_gather_matmul_dw": []}
    for (n, d, rb), calls in FUSED_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            G, idx, scales, W, X = _block_problem(gen, dev, n, d, rb, dtype)
            fused = sm.block_gather_matmul_fused(G, idx, scales, W, X, block=BLOCK)
            isz, kept = G.element_size(), rb * BLOCK
            for name, operand, out in (("block_gather_matmul", W, fused[0]),
                                       ("block_gather_matmul_dw", X, fused[1])):
                kern, plain = getattr(sm, name), getattr(sm, name + "_plain")
                got = kern(G, idx, scales, operand, block=BLOCK)
                torch.cuda.synchronize()
                err = max_err(got, plain(G, idx, scales, operand, block=BLOCK), TOL[dtype])[0]
                if not torch.equal(got, out):
                    raise AssertionError(f"{name} differs from the fused kernel's output")
                n_bytes = isz * (N_ROWS * kept + kept * d + N_ROWS * d) + 8 * rb
                row = dict(shape=[N_ROWS, n, d, rb], dtype=str(dtype).split(".")[-1],
                           calls=calls, max_abs_err=err, bit_identical_to_fused=True,
                           ms=cuda_ms(lambda: kern(G, idx, scales, operand, block=BLOCK)),
                           plain_ms=cuda_ms(lambda: plain(G, idx, scales, operand,
                                                          block=BLOCK)),
                           **bound(n_bytes, 2 * N_ROWS * kept * d, dtype))
                print(f"[kernel] {name} {row}")
                rows[name].append(row)
    return rows


def check_stream(gen, dev):
    """The streaming kernel: against its plain version in both score modes;
    dX, dWc and db bit for bit the fused kernel's for the same keeps (the kept
    columns' scores too); every score the same on a second call."""
    from repro_torch.kernels import sketch_matmul as sm

    rows = []
    for (n, d, rb), calls in FUSED_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            G, idx, scales, W, X = _block_problem(gen, dev, n, d, rb, dtype)
            args = (G, idx, scales, W, X)
            kept_cols = (idx.long()[:, None] * BLOCK
                         + torch.arange(BLOCK, device=dev)[None, :]).reshape(-1)
            for mode in ("l1", "l2"):
                got = sm.block_stream_matmul_fused(*args, block=BLOCK, score_mode=mode)
                want = sm.block_stream_matmul_fused_plain(*args, block=BLOCK, score_mode=mode)
                fused = sm.block_gather_matmul_fused(*args, block=BLOCK, with_scores=True,
                                                     score_mode=mode)
                again = sm.block_stream_matmul_fused(*args, block=BLOCK, score_mode=mode)
                torch.cuda.synchronize()
                errs = [max_err(g, w, TOL[dtype] if name in ("dX", "dWc") else 1e-5)[0]
                        for name, g, w in zip(("dX", "dWc", "db", "scores"), got, want)]
                if not all(torch.equal(a, b) for a, b in zip(got[:3], fused[:3])):
                    raise AssertionError("stream kernel's dX, dWc or db differ from the "
                                         "fused kernel's for the same keeps")
                if not torch.equal(got[3][kept_cols], fused[3].reshape(-1)):
                    raise AssertionError("stream kernel's kept scores differ from the fused "
                                         "kernel's")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError("block_stream_matmul_fused is not deterministic")
                isz, kept = G.element_size(), rb * BLOCK
                n_bytes = (isz * (N_ROWS * n + kept * d + 2 * N_ROWS * d + kept * d)
                           + 8 * rb + 4 * kept + 4 * n)
                n_ops = 4 * N_ROWS * kept * d + 2 * N_ROWS * n
                row = dict(shape=[N_ROWS, n, d, rb], dtype=str(dtype).split(".")[-1],
                           mode=mode, calls=calls, max_abs_err=max(errs),
                           bit_identical_to_fused=True, deterministic=True,
                           ms=cuda_ms(lambda: sm.block_stream_matmul_fused(
                               *args, block=BLOCK, score_mode=mode)),
                           fused_ms=cuda_ms(lambda: sm.block_gather_matmul_fused(
                               *args, block=BLOCK, with_scores=True, score_mode=mode)),
                           plain_ms=cuda_ms(lambda: sm.block_stream_matmul_fused_plain(
                               *args, block=BLOCK, score_mode=mode)),
                           **bound(n_bytes, n_ops, dtype))
                print(f"[kernel] block_stream_matmul_fused {row}")
                rows.append(row)
    return rows


def attend_mask(Sq, Skv, causal, window, device="cpu"):
    """[Sq, Skv] bool, True where a query attends a key, as the kernel masks
    them (causal right-aligned; the window only when causal)."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=device)[None, :]
    if not causal:
        return torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    mask = qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def unmasked_pairs(Sq, Skv, causal, window) -> int:
    """(query, key) pairs one head of one prompt attends."""
    return int(attend_mask(Sq, Skv, causal, window).sum())


def sdpa_call(q, k, v, causal, window):
    """One ``scaled_dot_product_attention`` call computing what the kernel
    computes on these inputs (is_causal where that is the mask, else an
    explicit boolean mask), for its time beside the kernel's."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    Sq, Skv = q.shape[1], k.shape[1]
    if causal and window is None and Sq == Skv:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)
    mask = None if not causal else attend_mask(Sq, Skv, causal, window, q.device)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def check_flash(gen, dev):
    """The flash kernel against its plain version; the same on a second call;
    SDPA on the same inputs beside it."""
    from repro_torch.kernels import flash_attention as fa

    rows = []
    for (B, Sq, Skv, H, Kv, dh, causal, window), calls in FLASH_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, Sq, H, dh), generator=gen, device=dev).to(dtype)
            k = torch.randn((B, Skv, Kv, dh), generator=gen, device=dev).to(dtype)
            v = torch.randn((B, Skv, Kv, dh), generator=gen, device=dev).to(dtype)
            kw = dict(causal=causal, window=window)
            got = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            again = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError("flash_attention is not deterministic")
            err, tol = max_err(got, want, TOL[dtype])
            lib = cuda_ms(sdpa_call(q, k, v, causal, window))
            n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
            n_ops = 4 * dh * B * H * unmasked_pairs(Sq, Skv, causal, window)
            row = dict(shape=[B, Sq, Skv, H, Kv, dh], causal=causal, window=window,
                       dtype=str(dtype).split(".")[-1], calls=calls, max_abs_err=err, tol=tol,
                       deterministic=True, ms=cuda_ms(lambda: fa.flash_attention(q, k, v, **kw)),
                       plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw)),
                       library_ms=lib, **bound(n_bytes, n_ops, dtype))
            print(f"[kernel] flash_attention {row}")
            rows.append(row)
            del q, k, v, got, want, again
    return rows


def lm100m():
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name="lm-100m", family="dense", n_layers=12, d_model=768,
                      n_heads=12, n_kv=12, d_ff=2048, vocab=32000,
                      q_chunk=128, kv_chunk=256)


def slice_policy(budget, backend="pallas"):
    from repro_torch.api import SketchConfig, SketchPolicy

    return SketchPolicy(base=SketchConfig(method="l1", budget=budget, backend=backend,
                                          block=BLOCK))


def expected_counts(backend, per_site):
    """Launches of every kernel, zeros included, when each sketched site runs
    ``per_site`` backwards under ``backend``."""
    from repro_torch.kernels import ops

    return {name: per_site * 7 * lm100m().n_layers if name in SITE_KERNELS[backend] else 0
            for name in ops.KERNELS}


def wiring_check(dev):
    """One lm-100m step at budget 0.999 under each backend: every block kept
    with scale 1, the backend's kernels at every site and no other, gradients
    equal to exact backprop, and (plan carry) every site's refreshed carry
    equal to the plain column reduction of that site's G."""
    from repro_torch import rng
    from repro_torch.api import Runtime
    from repro_torch.core import plan_state as pstate
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.optim import sgd
    from repro_torch.train.train_step import batch_to_device, init_state
    from repro_torch.tree import tree_leaves

    cfg = lm100m()
    state = init_state(rng.fold_in(11, 0), cfg, sgd(0.0), device=dev,
                       policy=slice_policy(0.999, "onepass"))
    batch = batch_to_device(next(LMStream(vocab=cfg.vocab, seed=11).batches(BATCH, SEQ)), dev)
    _, carry = pstate.collect_plan_state(state.params)  # path -> carry leaf
    carry_ids = {id(t) for t in carry.values()}
    weights = [p for p in tree_leaves(state.params) if id(p) not in carry_ids]
    # a site's weight -> the path of its carry leaf, to name the spied G
    site_of = {}
    for i, layer in enumerate(state.params["layers"]):
        for group in ("attn", "mlp"):
            for name, site in layer[group].items():
                site_of[site["w"].data_ptr()] = f"layers/{i}/{group}/{name}/{pstate.PLAN_SLOT}"
    if len(carry) != 7 * cfg.n_layers or set(carry) != set(site_of.values()):
        raise AssertionError(f"init_state seeded {len(carry)} carry leaves")
    step_key = rng.fold_in(11, 1)

    def grads(policy):
        ctx = Runtime(policy=policy, device=dev).ctx(step_key, n_layers=cfg.n_layers)
        loss, _ = lm.lm_loss(state.params, batch, ctx, cfg, step_key)
        paths = sorted(carry) if pstate.policy_uses_carry(policy) else []
        gs = torch.autograd.grad(loss, weights + [carry[p] for p in paths])
        return loss.detach(), gs[:len(weights)], dict(zip(paths, gs[len(weights):]))

    loss_e, g_exact, _ = grads(None)
    n_sites = 7 * cfg.n_layers
    for backend in BACKENDS:
        kernel = SITE_KERNELS[backend][-1]
        plans, plain_scores = [], {}
        real = getattr(ops, kernel)

        def spy(G, block_idx, scales, W, X, **kw):
            plans.append((G.shape[1] // kw["block"], block_idx.clone(), scales.clone()))
            plain_scores[site_of[W.data_ptr()]] = ref.col_scores_ref(G, mode="l1")
            return real(G, block_idx, scales, W, X, **kw)

        ops.reset_launch_counts()
        setattr(ops, kernel, spy)
        try:
            loss_s, g_sk, fresh = grads(slice_policy(0.999, backend))
        finally:
            setattr(ops, kernel, real)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if counts != expected_counts(backend, 1):
            raise AssertionError(f"{backend} budget-0.999 step launched {counts}, "
                                 f"want {expected_counts(backend, 1)}")
        if len(plans) != n_sites:
            raise AssertionError(f"{len(plans)} {kernel} calls, want {n_sites}")
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
            raise AssertionError(f"{backend}@0.999 vs exact gradients: max rel err "
                                 f"{worst:.3e} > {GRAD_RTOL}")
        carry_err = 0.0
        if backend != "pallas":
            if set(fresh) != set(carry) or set(plain_scores) != set(carry):
                raise AssertionError(f"{backend}: {len(fresh)} refreshed carries, "
                                     f"{len(plain_scores)} spied sites, want {len(carry)}")
            for path, got in fresh.items():
                carry_err = max(carry_err, max_err(got, plain_scores[path], 1e-5)[0])
            if not all(torch.equal(v, torch.ones_like(v)) for v in carry.values()):
                raise AssertionError(f"{backend}: a backward alone changed a carry leaf")
        print(f"[wiring] {backend} budget 0.999: {n_sites} sites, every block kept with "
              f"scale 1, launches {counts}, loss {loss_e.item():.6f}, max rel grad err "
              f"{worst:.3e} (tol {GRAD_RTOL}), max carry err {carry_err:.3e} "
              f"(tol 1e-5 of the largest score)")
        del g_sk, fresh
    del state, g_exact


def compact_sites(grads) -> tuple:
    """(sketched sites whose w gradient is a CompactGrad without a dense
    part, sketched sites) of an lm-100m gradient tree."""
    from repro_torch.core.compact_grad import CompactGrad

    sites = [site["w"] for layer in grads["layers"] for group in ("attn", "mlp")
             for site in layer[group].values()]
    return sum(isinstance(g, CompactGrad) and g.dense is None for g in sites), len(sites)


def main_path(dev, backend, compact=False):
    """A slice's main path: Runtime.train of lm-100m for STEPS steps, l1@0.2
    block 128 under ``backend``, with the launch counts read around it; with
    ``compact``, compact gradients and lazy AdamW, and every step's sketched
    weight gradients checked to be compact."""
    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.core import plan_state as pstate
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.optim import Optimizer, adamw, cosine_warmup
    from repro_torch.train.trainer import TrainerConfig
    from repro_torch.tree import tree_leaves

    cfg = lm100m()
    label = backend + ("-compact" if compact else "")
    runtime = Runtime(policy=slice_policy(0.2, backend), device=dev,
                      execution=ExecutionConfig(compact_grads=compact))
    opt = adamw(cosine_warmup(3e-4, 15, 300), weight_decay=0.1, clip=1.0, lazy=compact)
    seen = []  # (compact sites, sketched sites) of each update's gradients

    def update(grads, state, params, step):
        seen.append(compact_sites(grads))
        return opt.update(grads, state, params, step)

    data = LMStream(vocab=cfg.vocab, seed=0).batches(BATCH, SEQ)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    state, history = runtime.train(cfg, Optimizer(opt.init, update), data,
                                   TrainerConfig(steps=STEPS, log_every=1))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts != expected_counts(backend, STEPS):
        raise AssertionError(f"{label} main path launched {counts}, "
                             f"want {expected_counts(backend, STEPS)}")
    n_sites = 7 * cfg.n_layers
    if seen != [(n_sites if compact else 0, n_sites)] * STEPS:
        raise AssertionError(f"{label}: compact sketched weight gradients per step {seen}")
    losses = [h["loss"] for h in history]
    if len(history) != STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite or missing losses: {losses}")
    if not all(torch.isfinite(p).all() for p in tree_leaves(state.params)):
        raise AssertionError("non-finite parameters after training")
    _, carry = pstate.collect_plan_state(state.params)
    if backend == "pallas" and carry:
        raise AssertionError("the pallas policy seeded carry leaves")
    if backend != "pallas":
        if len(carry) != 7 * cfg.n_layers:
            raise AssertionError(f"{len(carry)} carry leaves, want {7 * cfg.n_layers}")
        for path, v in carry.items():
            prior = v == 1.0
            if backend == "onepass" and prior.any():
                raise AssertionError(f"onepass left prior values in {path}")
            # stale refreshes only the kept blocks: at l1@0.2 five steps keep
            # at most 5 of 6 (or 15 of 16) blocks, so some prior must remain
            if backend == "stale" and (prior.all() or not prior.any()):
                raise AssertionError(f"stale carry {path}: {int(prior.sum())} of "
                                     f"{v.numel()} entries still hold the prior")
    n_params = lm.num_params(state.params)
    step_ms = [1e3 * h["step_s"] for h in history]
    print(f"[train] {label}: lm-100m ({n_params} params incl. "
          f"{sum(v.numel() for v in carry.values())} carried scores), batch {BATCH}x{SEQ}, "
          f"l1@0.2 block {BLOCK}" + (", compact gradients, lazy AdamW" if compact else "")
          + f": losses {losses}")
    print(f"[train] {label}: step ms {step_ms} (first includes warm-up); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {counts}; "
          f"sketched sites with a compact w gradient per step {[c for c, _ in seen]} "
          f"of {n_sites}")
    del state
    return counts


def compact_step_check(dev):
    """One lm-100m step from the same parameters, batch and seed with compact
    gradients on and off (AdamW, not lazy), under ``pallas`` and ``stale``:
    the parameters (carry leaves included) must agree within COMPACT_RTOL /
    COMPACT_ATOL, and the compact step must launch the dense step's kernels."""
    from repro_torch import rng
    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves

    cfg = lm100m()
    batch = next(LMStream(vocab=cfg.vocab, seed=21).batches(BATCH, SEQ))
    for backend in ("pallas", "stale"):
        out = {}
        for compact in (False, True):
            runtime = Runtime(policy=slice_policy(0.2, backend), device=dev,
                              execution=ExecutionConfig(compact_grads=compact))
            opt = adamw(3e-4, weight_decay=0.1, clip=1.0)
            # the same parameters each time: the update writes them in place
            params = lm.init_params(rng.fold_in(21, 0), cfg, device=dev)
            state = runtime.init_state(0, cfg, opt, params=params)
            ops.reset_launch_counts()
            state, m = runtime.train_step(cfg, opt)(state, batch, 22)
            torch.cuda.synchronize()
            out[compact] = (float(m["loss"]), ops.launch_counts(),
                            [p.detach() for p in tree_leaves(state.params)])
            del state
        (loss_d, counts_d, p_d), (loss_c, counts_c, p_c) = out[False], out[True]
        if counts_c != counts_d or counts_c != expected_counts(backend, 1):
            raise AssertionError(f"{backend}: compact step launched {counts_c}, dense {counts_d}")
        worst = 0.0  # the largest |a - b| / (atol + rtol |b|)
        for a, b in zip(p_c, p_d):
            worst = max(worst, ((a - b).abs() / (COMPACT_ATOL + COMPACT_RTOL * b.abs()))
                        .max().item())
            if not worst <= 1.0 or not torch.isfinite(a).all():
                raise AssertionError(f"{backend}: compact and dense steps disagree beyond "
                                     f"rtol {COMPACT_RTOL}, atol {COMPACT_ATOL}")
        print(f"[compact] {backend}: one lm-100m step, compact gradients on and off "
              f"(AdamW): losses {loss_c:.6f} / {loss_d:.6f}, {len(p_c)} parameter leaves "
              f"agree (largest error {worst:.3f} of the tolerance rtol {COMPACT_RTOL}, "
              f"atol {COMPACT_ATOL}), launches {counts_c}")
        del out, p_c, p_d


def _device_us(evt) -> float:
    # the attribute's name changed across torch releases
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def traced_step(run, want, label, tries=3):
    """Profile ``run(attempt)`` (one step, synchronised) and return its
    device events, once the trace holds ``want[name]`` events of each
    kernel. The launch counters count every launch; the profiler can drop a
    kernel's event (a trace of the MLP's step once held 2 of its 3 score
    launches), so a trace that misses one is retried, up to ``tries``
    traces, each retry printed with what the trace's raw device events and
    its aggregate saw. Fails only if every trace misses a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        # device activity alone: the same kernels and device time as with the
        # host's ops recorded too, and a shorter post-processing (PERF.md §6)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(attempt)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        seen = {name: sum(e.count for e in kern if KERNEL_SYMBOLS[name] in e.key)
                for name in want}
        if seen == want:
            return kern
        raw = {name: sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                         and KERNEL_SYMBOLS[name] in e.name) for name in want}
        print(f"[trace-retry] {label}: trace {attempt + 1} of {tries} holds {seen} kernel "
              f"events (raw device events {raw}), the counters {want}")
    raise AssertionError(f"{label}: every one of {tries} traces missed a launch the counters "
                         f"saw ({want})")


def step_breakdown(dev, replay, reps=3):
    """Where a step's time goes: lm-100m steps with exact backprop beside the
    sketched steps of each backend and the compact-gradient ``pallas`` step
    with lazy AdamW, as its main path runs it (host clock around
    synchronised steps), and a
    profiler trace of one step of each: device-busy share, device ops, peak
    memory, top kernels, and each of the backend's kernels' device time in
    the step beside ``replay[backend][kernel]``, its warm-L2 replay time per
    step (phase 3)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import rng
    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.data.synthetic import LMStream
    from repro_torch.optim import Optimizer, adamw, cosine_warmup

    cfg = lm100m()
    batches = [b for b, _ in zip(LMStream(vocab=cfg.vocab, seed=3).batches(BATCH, SEQ),
                                 range(reps + 2))]
    # (label, policy, backend, compact gradients, lazy AdamW)
    runs = ([("exact", None, None, False, False)]
            + [(f"{b}-l1@0.2", slice_policy(0.2, b), b, False, False) for b in BACKENDS]
            + [("pallas-l1@0.2-compact-lazy", slice_policy(0.2), "pallas", True, True)])
    for label, policy, backend, compact, lazy in runs:
        runtime = Runtime(policy=policy, device=dev,
                          execution=ExecutionConfig(compact_grads=compact))
        opt = adamw(cosine_warmup(3e-4, 15, 300), weight_decay=0.1, clip=1.0, lazy=lazy)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        at_update = []  # memory allocated when the optimizer update starts

        def update(grads, st, params, step, opt=opt, at_update=at_update):
            at_update.append(torch.cuda.memory_allocated(dev))
            return opt.update(grads, st, params, step)

        opt = Optimizer(opt.init, update)
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
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[breakdown] {label}: {step_ms:.1f} ms/step over {reps} steps; profiled step: "
              f"{wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms in "
              f"{sum(e.count for e in kern)} device ops, "
              f"{sum(e.count for e in host)} host ops; busy share of an unprofiled step "
              f"{100 * busy_ms / step_ms:.0f}%; peak memory {peak / 2**30:.3f} GiB "
              f"({(peak - before) / 2**30:.3f} GiB above the {before / 2**30:.3f} GiB "
              f"allocated before the run), {(at_update[-1] - before) / 2**30:.3f} GiB above it "
              f"when the optimizer update starts")
        for e in sorted(kern, key=_device_us, reverse=True)[:6]:
            print(f"[breakdown]   device {_device_us(e) / 1e3:8.2f} ms x{e.count:<5d} {e.key[:80]}")
        for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]:
            print(f"[breakdown]   host   {e.self_cpu_time_total / 1e3:8.2f} ms x{e.count:<5d} "
                  f"{e.key[:80]}")
        for name, replay_ms in replay.get(backend, {}).items():
            evs = [e for e in kern if KERNEL_SYMBOLS[name] in e.key]
            launched = sum(e.count for e in evs)
            if launched != 7 * cfg.n_layers:
                raise AssertionError(f"{label}: {launched} {name} launches in the traced step")
            print(f"[breakdown]   kernel {name}: {sum(_device_us(e) for e in evs) / 1e3:.3f} ms "
                  f"in the step ({launched} launches), warm-L2 replay {replay_ms:.3f} ms per step")
        del state


def serve_path(dev):
    """The serving main path: lm-100m with attn_impl="pallas" through
    Runtime.prefill_step / decode_step, two waves, the launch counts read
    after every prefill and every decode; then the checks against plain
    attention. Returns the launch counts of the run."""
    from repro_torch.api import Runtime
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.nn.common import Ctx
    from repro_torch.serve import greedy_sample

    cfg = lm100m().replace(attn_impl="pallas")
    params = lm.init_params(SERVE_SEED, cfg, device=dev)
    runtime = Runtime(device=dev)
    gen = np.random.default_rng(SERVE_SEED)
    waves = [gen.integers(1, cfg.vocab, size=(B, S)) for B, S in SERVE_WAVES]
    L = cfg.n_layers

    def generate(prompts, forced=None):
        """Prefill, then DECODE_STEPS greedy steps; ``forced``: feed these
        tokens instead of the run's own. Returns (prefill logits, tokens
        fed, step logits, launches after prefill and after decode, ms)."""
        B, S = prompts.shape
        prefill = runtime.prefill_step(cfg, S + DECODE_STEPS)
        decode = runtime.decode_step(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after_prefill = ops.launch_counts()
        cur = greedy_sample(logits[:, -1:])
        fed, step_logits = [], []
        for i in range(DECODE_STEPS):
            if forced is not None:
                cur = forced[i]
            fed.append(cur)
            lg, caches = decode(params, caches, cur, S + i)
            step_logits.append(lg)
            cur = greedy_sample(lg)
        fed.append(cur)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for c in caches:
            if tuple(c["k"].shape) != (B, S + DECODE_STEPS, cfg.n_kv, cfg.head_dim):
                raise AssertionError(f"cache shape {tuple(c['k'].shape)}")
        return (logits, fed, step_logits, after_prefill, ops.launch_counts(),
                1e3 * (t1 - t0), 1e3 * (t2 - t1))

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    runs = []
    for w, prompts in enumerate(waves):
        out = generate(prompts)
        logits, fed, step_logits, after_prefill, after_decode = out[:5]
        want = {name: 0 for name in ops.KERNELS}
        want["flash_attention"] = L * (w + 1)
        if after_prefill != want or after_decode != want:
            raise AssertionError(f"wave {w + 1}: launches after prefill {after_prefill}, after "
                                 f"decode {after_decode}, want {want} ({L} per prefill, 0 in "
                                 f"decode)")
        if not torch.isfinite(logits).all() or not all(torch.isfinite(x).all()
                                                       for x in step_logits):
            raise AssertionError(f"wave {w + 1}: non-finite logits")
        runs.append(out)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    # checks: the prefill against the plain-attention forward, and the
    # generation against the plain attention, teacher-forced
    plain_cfg = cfg.replace(attn_impl="chunked")
    for w, (prompts, out) in enumerate(zip(waves, runs)):
        B, S = prompts.shape
        logits, fed, step_logits = out[:3]
        toks = torch.as_tensor(prompts, device=dev).long()
        if w == 0:
            with torch.no_grad():
                want = lm.forward(params, {"tokens": toks}, Ctx(), plain_cfg)
            fwd_err, fwd_tol = max_err(logits, want, LOGIT_RTOL)
            del want
        real = ops.flash_attention
        ops.flash_attention = fa.flash_attention_plain
        try:
            p_logits, _, p_steps, _, _, _, _ = generate(prompts, forced=fed[:DECODE_STEPS])
        finally:
            ops.flash_attention = real
        pre_err, _ = max_err(logits, p_logits, LOGIT_RTOL)
        step_err = max(max_err(a, b, LOGIT_RTOL)[0] for a, b in zip(step_logits, p_steps))
        differ = int((greedy_sample(p_logits[:, -1:]) != fed[0]).sum())
        differ += sum(int((greedy_sample(b) != t).sum()) for b, t in zip(p_steps, fed[1:]))
        prefill_ms, decode_ms = out[5], out[6]
        print(f"[serve] wave {w + 1}: {B} prompts x {S} tokens, {DECODE_STEPS} greedy decode "
              f"steps: prefill {prefill_ms:.1f} ms ({B * S / prefill_ms * 1e3:.0f} prompt "
              f"tokens/s), decode {decode_ms / DECODE_STEPS:.2f} ms per step "
              f"({B * DECODE_STEPS / decode_ms * 1e3:.0f} tokens/s); launches after prefill "
              f"and decode {out[3]['flash_attention']}, {out[4]['flash_attention']} "
              f"flash_attention and "
              f"{sum(v for k, v in out[4].items() if k != 'flash_attention')} other")
        print(f"[serve] wave {w + 1}: against plain attention: prefill logits max|err| "
              f"{pre_err:.3e}, decode logits {step_err:.3e} (tol {LOGIT_RTOL} of the largest "
              f"logit), greedy tokens differing {differ} of {B * (DECODE_STEPS + 1)}"
              + (f"; prefill vs the plain forward {fwd_err:.3e} (tol {fwd_tol:.3e})"
                 if w == 0 else ""))
        print(f"[serve] wave {w + 1}: first tokens {[int(t[0, 0]) for t in fed[:8]]}")
    print(f"[serve] peak memory {peak:.2f} GiB; launches {counts}")
    del runs
    return counts


def serve_breakdown(dev, reps=3):
    """Where a serving step's time goes: one wave-1 prefill and one decode
    step, host clock around synced calls after a warm-up, and a profiler
    trace of one of each (device busy share, top device and host ops).
    Returns the decode step's device ops, busy ms and ms per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Runtime
    from repro_torch.models import lm
    from repro_torch.serve import greedy_sample

    cfg = lm100m().replace(attn_impl="pallas")
    params = lm.init_params(SERVE_SEED, cfg, device=dev)
    runtime = Runtime(device=dev)
    B, S = SERVE_WAVES[0]
    prompts = np.random.default_rng(SERVE_SEED + 1).integers(1, cfg.vocab, size=(B, S))
    prefill = runtime.prefill_step(cfg, S + DECODE_STEPS)
    decode = runtime.decode_step(cfg)
    logits, caches = prefill(params, {"tokens": prompts})
    cur = greedy_sample(logits[:, -1:])
    del logits
    calls = [(f"prefill {B}x{S}", lambda: prefill(params, {"tokens": prompts})),
             (f"decode step (batch {B})", lambda: decode(params, caches, cur, S))]
    for label, fn in calls:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        call_ms = 1e3 * (time.perf_counter() - t0) / reps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        evts = prof.key_averages()
        kern = [e for e in evts if e.device_type == DeviceType.CUDA]
        busy_ms = sum(_device_us(e) for e in kern) / 1e3
        host = [e for e in evts if e.device_type == DeviceType.CPU]
        stats = {"ops": sum(e.count for e in kern), "busy_ms": busy_ms, "call_ms": call_ms}
        print(f"[serve-breakdown] {label}: {call_ms:.2f} ms per call over {reps} calls; "
              f"profiled call: {wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms in "
              f"{sum(e.count for e in kern)} device ops, {sum(e.count for e in host)} host ops; "
              f"busy share of an unprofiled call {100 * busy_ms / call_ms:.0f}%")
        for e in sorted(kern, key=_device_us, reverse=True)[:6]:
            print(f"[serve-breakdown]   device {_device_us(e) / 1e3:8.3f} ms x{e.count:<5d} "
                  f"{e.key[:80]}")
        for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]:
            print(f"[serve-breakdown]   host   {e.self_cpu_time_total / 1e3:8.3f} ms "
                  f"x{e.count:<5d} {e.key[:80]}")
    return stats  # the last call's: the decode step


# ---------------------------------------------------------------------------
# The paper's §5 models (phase 9): the MLP, ViT and BagNet at App. B.2 widths
# ---------------------------------------------------------------------------

# each model's batch and its sketched sites' kernel shapes with their calls
# per step under the block-128 l1 pallas policy: the score kernel at every
# site (N, n), the fused kernel at the block-granular ones (N, n, d, rb).
# Widths below or no multiple of 128 run per column: the score kernel, then a
# plain gather and matmul. A site with one 128-wide block keeps it with
# scale 1 and still launches both kernels. ViT's patch projection and the
# ViT and BagNet classifiers stay exact (SketchPolicy's default exclusions);
# the MLP sketches every layer, its head included (exclude_roles=(), §5).
PAPER = {
    "mlp": dict(batch=128, score={(128, 64): 2, (128, 10): 1}, fused={}),
    "vit": dict(batch=64, score={(4160, 192): 45, (4160, 1024): 9},
                fused={(4160, 1024, 192, 2): 9}),
    "bagnet": dict(batch=64,
                   score={(65536, 64): 3, (65536, 128): 1, (16384, 128): 3, (16384, 256): 1,
                          (4096, 256): 4},
                   fused={(65536, 128, 64, 1): 1, (16384, 128, 128, 1): 3,
                          (16384, 256, 128, 1): 1, (4096, 256, 256, 1): 4}),
}
PAPER_SEED = 17
# budget 0.999 against exact backprop, every gradient of the model: float32
# reorderings through up to nine layers, as GRAD_RTOL for lm-100m
PAPER_GRAD_RTOL = 2e-4


def sum_tol(K: int) -> float:
    """float32 tolerance, relative to the output's largest magnitude, of sums
    of K terms taken in another order: the rule behind TOL, sqrt(K)*2^-24,
    with TOL's 1e-5 as its floor. The rule passes the floor above K = 28,147:
    of the models' shapes only at K = 65,536, where it gives 1.53e-5."""
    return max(TOL[torch.float32], math.sqrt(K) * 2.0 ** -24)


def rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want|: what max_err holds
    against its relative tolerance."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def paper_kernels(gen, dev):
    """The score and fused kernels at the §5 models' shapes, float32 and
    bf16, against their plain versions; their times beside the bound, the
    plain version and (score kernel) ``G.abs().sum(0)``. Returns
    {model: {kernel: rows}}."""
    from repro_torch.kernels import col_scores
    from repro_torch.kernels import sketch_matmul as sm

    out = {}
    for model, spec in PAPER.items():
        rows = {"col_l1_scores": [], "block_gather_matmul_fused": []}
        for (N, n), calls in spec["score"].items():
            for dtype in (torch.float32, torch.bfloat16):
                G = torch.randn((N, n), generator=gen, device=dev).to(dtype)
                got = col_scores.col_l1_scores(G)
                if not torch.equal(got, col_scores.col_l1_scores(G)):
                    raise AssertionError("col_l1_scores is not deterministic")
                err, tol = max_err(got, col_scores.col_l1_scores_plain(G), sum_tol(N))
                row = dict(model=model, shape=[N, n], dtype=str(dtype).split(".")[-1],
                           calls=calls, max_abs_err=err, tol=tol,
                           rel_err=rel_err(got, col_scores.col_l1_scores_plain(G)),
                           rel_tol=sum_tol(N),
                           ms=cuda_ms(lambda: col_scores.col_l1_scores(G)),
                           plain_ms=cuda_ms(lambda: col_scores.col_l1_scores_plain(G)),
                           library_ms=cuda_ms(lambda: G.abs().sum(0, dtype=torch.float32)),
                           **bound(N * n * G.element_size() + 4 * n, 2 * N * n, torch.float32))
                print(f"[paper-kernel] col_l1_scores {row}")
                rows["col_l1_scores"].append(row)
        for (N, n, d, rb), calls in spec["fused"].items():
            idx = torch.sort(torch.randperm(n // BLOCK, generator=gen, device=dev)[:rb]).values
            idx = idx.to(torch.int32)
            scales = 1.0 + 4.0 * torch.rand(rb, generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                G = torch.randn((N, n), generator=gen, device=dev).to(dtype)
                W = (torch.randn((n, d), generator=gen, device=dev) * d ** -0.5).to(dtype)
                X = torch.randn((N, d), generator=gen, device=dev).to(dtype)
                args = (G, idx, scales, W, X)
                got = sm.block_gather_matmul_fused(*args, block=BLOCK)
                want = sm.block_gather_matmul_fused_plain(*args, block=BLOCK)
                torch.cuda.synchronize()
                kept = rb * BLOCK
                # dX sums the kept columns, dWc and db the N rows; bf16 dX and
                # dWc round to 8 bits (TOL), db stays float32
                bf16 = dtype == torch.bfloat16
                tols = (TOL[dtype] if bf16 else sum_tol(kept),
                        TOL[dtype] if bf16 else sum_tol(N), sum_tol(N))
                err = max(max_err(g, w, t)[0] for g, w, t in zip(got, want, tols))
                n_bytes = (G.element_size() * (N * kept + kept * d + 2 * N * d + kept * d)
                           + 8 * rb + 4 * kept)
                row = dict(model=model, shape=[N, n, d, rb], dtype=str(dtype).split(".")[-1],
                           calls=calls, max_abs_err=err,
                           rel_err=[rel_err(g, w) for g, w in zip(got, want)],
                           rel_tol=list(tols),
                           ms=cuda_ms(lambda: sm.block_gather_matmul_fused(*args, block=BLOCK)),
                           plain_ms=cuda_ms(lambda: sm.block_gather_matmul_fused_plain(
                               *args, block=BLOCK)),
                           library_ms=None,
                           **bound(n_bytes, 4 * N * kept * d + 2 * N * kept, dtype))
                print(f"[paper-kernel] block_gather_matmul_fused {row}")
                rows["block_gather_matmul_fused"].append(row)
                del G, W, X, got, want
        out[model] = rows
    return out


def paper_policy(model, budget):
    from repro_torch.api import SketchConfig, SketchPolicy

    base = SketchConfig(method="l1", budget=budget, backend="pallas", block=BLOCK)
    return SketchPolicy(base=base, exclude_roles=()) if model == "mlp" else SketchPolicy(base=base)


def paper_setup(model, dev, n_batches):
    """(random parameters from PAPER_SEED, loss_fn(params, batch, ctx), the
    model's optimizer, n_batches batches on the card) at App. B.2's widths:
    the MLP 784-64-64-10 (SGD, constant lr 0.2, clip 1.0); ViT img 32, patch
    4, d 192, depth 9, heads 12, d_ff 1024 (AdamW, cosine 3e-4 with 20 warm-up
    of 400 steps, weight decay 0.05, clip 1.0); BagNet width 64, blocks (2, 2,
    2) (SGD momentum 0.9, cosine 0.03 with 10 warm-up of 400 steps, clip
    1.0); 10 classes each, data from ``data/synthetic.classification``."""
    import functools

    from repro_torch.data.synthetic import classification
    from repro_torch.models import mlp, vision
    from repro_torch.optim import adamw, constant, cosine_warmup, sgd

    B = PAPER[model]["batch"]
    if model == "mlp":
        x, y = classification(B * n_batches, 784, 10, seed=PAPER_SEED)
        params = mlp.mlp_init(PAPER_SEED, device=dev)
        loss_fn, opt = mlp.mlp_loss, sgd(constant(0.2), clip=1.0)
    else:
        x, y = classification(B * n_batches, (32, 32, 3), 10, seed=PAPER_SEED, noise=0.8,
                              flatten=False)
        if model == "vit":
            params = vision.vit_init(PAPER_SEED, device=dev)
            apply_fn = functools.partial(vision.vit_apply, heads=12)
            opt = adamw(cosine_warmup(3e-4, 20, 400), weight_decay=0.05, clip=1.0)
        else:
            params = vision.bagnet_init(PAPER_SEED, device=dev)
            apply_fn = vision.bagnet_apply
            opt = sgd(cosine_warmup(0.03, 10, 400), momentum=0.9, clip=1.0)
        loss_fn = functools.partial(vision.cls_loss, apply_fn)
    batches = [{"x": torch.as_tensor(x[i * B:(i + 1) * B], device=dev),
                "y": torch.as_tensor(y[i * B:(i + 1) * B], device=dev).long()}
               for i in range(n_batches)]
    return params, loss_fn, opt, batches


def paper_grads(params, loss_fn, batch, ctx):
    """(loss, the gradient of every parameter leaf, in tree_leaves order)."""
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = loss_fn(params, batch, ctx)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def paper_step_fn(model, runtime, params, loss_fn, opt):
    """``step(i, batch) -> loss``: one training step of the model under
    ``runtime``. The MLP takes ``Runtime.train_step`` (the step of
    ``Runtime.train``: the ``family="mlp"`` dispatch of ``lm``); ViT and
    BagNet, which have no ArchConfig family, are driven by hand as
    ``benchmarks/torch/fig3_larger_archs.py`` drives them:
    ``runtime.ctx(key)``, ``torch.autograd.grad``, ``opt.update``."""
    from repro_torch import rng
    from repro_torch.models.mlp import mlp_arch
    from repro_torch.tree import tree_map

    if model == "mlp":
        fn = runtime.train_step(mlp_arch(), opt)
        box = [runtime.init_state(0, mlp_arch(), opt, params=params)]

        def step(i, batch):
            box[0], m = fn(box[0], batch, rng.fold_in(PAPER_SEED, i + 1))
            return m["loss"]

        return step
    state = [opt.init(params)]

    def step(i, batch):
        loss, grads = paper_grads(params, loss_fn, batch,
                                  runtime.ctx(rng.fold_in(PAPER_SEED, i + 1)))
        it = iter(grads)
        _, state[0] = opt.update(tree_map(lambda _: next(it), params), state[0], params, i)
        return loss

    return step


def paper_counts(model, steps):
    from repro_torch.kernels import ops

    want = {name: 0 for name in ops.KERNELS}
    want["col_l1_scores"] = steps * sum(PAPER[model]["score"].values())
    want["block_gather_matmul_fused"] = steps * sum(PAPER[model]["fused"].values())
    return want


def paper_wiring(dev):
    """Per model, one gradient at budget 0.999 (block 128, pallas): every
    block and column kept with scale 1, the launches per step exactly as
    PAPER lists them (and at its shapes), every parameter's gradient equal to
    exact backprop's within PAPER_GRAD_RTOL; then an exact-context evaluation
    (``runtime.ctx(budget=None)``) that launches no kernel."""
    from collections import Counter

    from repro_torch import rng
    from repro_torch.api import Runtime
    from repro_torch.kernels import ops

    for model in PAPER:
        params, loss_fn, _, (batch,) = paper_setup(model, dev, 1)
        key = rng.fold_in(PAPER_SEED, 1)
        loss_e, g_exact = paper_grads(params, loss_fn, batch, Runtime(device=dev).ctx(key))
        seen = {"score": Counter(), "fused": Counter()}
        real_s, real_f = ops.col_l1_scores, ops.block_gather_matmul_fused

        def spy_s(G, **kw):
            seen["score"][tuple(G.shape)] += 1
            return real_s(G, **kw)

        def spy_f(G, block_idx, scales, W, X, **kw):
            if not torch.all(scales == 1.0) or block_idx.numel() != G.shape[1] // kw["block"]:
                raise AssertionError(f"{model}: budget 0.999 dropped or rescaled a block")
            seen["fused"][(*G.shape, W.shape[1], block_idx.numel())] += 1
            return real_f(G, block_idx, scales, W, X, **kw)

        runtime = Runtime(policy=paper_policy(model, 0.999), device=dev)
        ops.reset_launch_counts()
        ops.col_l1_scores, ops.block_gather_matmul_fused = spy_s, spy_f
        try:
            loss_s, g_sk = paper_grads(params, loss_fn, batch, runtime.ctx(key))
        finally:
            ops.col_l1_scores, ops.block_gather_matmul_fused = real_s, real_f
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if counts != paper_counts(model, 1):
            raise AssertionError(f"{model} budget-0.999 step launched {counts}, "
                                 f"want {paper_counts(model, 1)}")
        # at 0.999 every block is kept: rb is the block count
        want_fused = Counter({(N, n, d, n // BLOCK): c
                              for (N, n, d, _), c in PAPER[model]["fused"].items()})
        if seen["score"] != Counter(PAPER[model]["score"]) or seen["fused"] != want_fused:
            raise AssertionError(f"{model}: kernel shapes {dict(seen['score'])} "
                                 f"{dict(seen['fused'])}")
        worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                    for a, b in zip(g_sk, g_exact))
        if not worst <= PAPER_GRAD_RTOL or not torch.isfinite(loss_s):
            raise AssertionError(f"{model}@0.999 vs exact gradients: max rel err {worst:.3e} "
                                 f"> {PAPER_GRAD_RTOL}")
        ops.reset_launch_counts()
        with torch.no_grad():
            loss_v, acc_v = loss_fn(params, batch, runtime.ctx(key, budget=None))
        torch.cuda.synchronize()
        if any(ops.launch_counts().values()) or not torch.allclose(loss_v, loss_e, rtol=1e-6):
            raise AssertionError(f"{model}: the exact-context evaluation launched "
                                 f"{ops.launch_counts()} or changed the loss")
        print(f"[paper-wiring] {model} budget 0.999: launches {counts}, score shapes "
              f"{dict(seen['score'])}, fused shapes {dict(seen['fused'])}, every block kept "
              f"with scale 1, {len(g_exact)} gradients, max rel err {worst:.3e} (tol "
              f"{PAPER_GRAD_RTOL}); exact evaluation: 0 launches, loss {loss_v.item():.6f} "
              f"acc {acc_v.item():.4f}")
        del params, g_exact, g_sk


def paper_train(dev, model):
    """A model's main path: STEPS training steps with its optimizer and
    l1@0.2 block-128 pallas policy, launch counts set to 0 just before and
    read just after; the MLP through ``Runtime.train``. Returns the counts."""
    from repro_torch import rng
    from repro_torch.api import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models.mlp import mlp_arch
    from repro_torch.train.trainer import TrainerConfig
    from repro_torch.tree import tree_leaves

    params, loss_fn, opt, batches = paper_setup(model, dev, STEPS)
    runtime = Runtime(policy=paper_policy(model, 0.2), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    if model == "mlp":
        state = runtime.init_state(rng.fold_in(PAPER_SEED, 0), mlp_arch(), opt, params=params)
        state, hist = runtime.train(mlp_arch(), opt, batches,
                                    TrainerConfig(steps=STEPS, log_every=1, seed=PAPER_SEED),
                                    state=state, on_metrics=lambda m: None)
        losses = [h["loss"] for h in hist]
    else:
        step = paper_step_fn(model, runtime, params, loss_fn, opt)
        losses = [float(step(i, b)) for i, b in enumerate(batches)]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    if counts != paper_counts(model, STEPS):
        raise AssertionError(f"{model} main path launched {counts}, "
                             f"want {paper_counts(model, STEPS)}")
    if len(losses) != STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{model}: non-finite or missing losses {losses}")
    if not all(torch.isfinite(p).all() for p in tree_leaves(params)):
        raise AssertionError(f"{model}: non-finite parameters after training")
    print(f"[paper-train] {model}: {sum(p.numel() for p in tree_leaves(params))} params, "
          f"batch {PAPER[model]['batch']}, l1@0.2 block {BLOCK} pallas, {STEPS} steps in "
          f"{wall:.2f} s: losses {losses}; launches {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    return counts


def paper_quickstart(dev):
    """``benchmarks/torch/quickstart.py`` on one seed: the exact and the
    sketched (l1 @ 0.2, every layer) 10-epoch runs, exact evaluation."""
    from benchmarks.torch.quickstart import run
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    res = run(0, device=dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # the exact run launches nothing; the sketched one 3 per step
    if counts["col_l1_scores"] != 3 * res["sketched"]["steps"] or sum(counts.values()) != \
            counts["col_l1_scores"]:
        raise AssertionError(f"quickstart launched {counts}")
    for run_ in ("exact", "sketched"):
        if not all(0.0 <= a <= 1.0 for a in res[run_]["test_acc_per_epoch"]):
            raise AssertionError(f"quickstart {run_}: accuracies {res[run_]}")
    print(f"[quickstart] seed 0, 10 epochs: test accuracy exact {res['exact']['test_acc']:.4f}, "
          f"sketched l1@0.2 {res['sketched']['test_acc']:.4f} (gap {res['gap']:.4f}); "
          f"train s exact {res['exact']['train_s']:.2f}, sketched "
          f"{res['sketched']['train_s']:.2f}; launches {counts}")


def paper_breakdown(dev, replay, reps=3):
    """Per model, exact backprop beside the sketched step (l1@0.2 block 128
    pallas): ms/step (host clock around synchronised steps after a warm-up),
    and a profiler trace of one step: device busy time, device ops, peak
    memory, and each kernel's in-step device time beside
    ``replay[model][kernel]``, its warm-L2 replay time per step (this phase's
    kernel rows)."""
    from repro_torch.api import Runtime

    for model in PAPER:
        for label, policy in (("exact", None), ("l1@0.2", paper_policy(model, 0.2))):
            params, loss_fn, opt, batches = paper_setup(model, dev, reps + 2)
            step = paper_step_fn(model, Runtime(policy=policy, device=dev), params, loss_fn,
                                 opt)
            float(step(0, batches[0]))  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            for i in range(reps):
                loss = step(1 + i, batches[1 + i])
            float(loss)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / reps
            want = ({} if policy is None else
                    {name: paper_counts(model, 1)[name] for name in replay[model]})
            kern = traced_step(lambda a: float(step(reps + 1 + a, batches[-1])), want,
                               f"{model} {label}")
            busy_ms = sum(_device_us(e) for e in kern) / 1e3
            print(f"[paper-breakdown] {model} {label}: {step_ms:.2f} ms/step over {reps} steps; "
                  f"profiled step: device busy {busy_ms:.2f} ms in "
                  f"{sum(e.count for e in kern)} device ops; busy share "
                  f"{100 * busy_ms / step_ms:.0f}%; peak memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
            for e in sorted(kern, key=_device_us, reverse=True)[:5]:
                print(f"[paper-breakdown]   device {_device_us(e) / 1e3:8.3f} ms x{e.count:<5d} "
                      f"{e.key[:80]}")
            for name, n in want.items():
                evs = [e for e in kern if KERNEL_SYMBOLS[name] in e.key]
                print(f"[paper-breakdown]   kernel {name}: "
                      f"{sum(_device_us(e) for e in evs) / 1e3:.3f} ms in the step "
                      f"({n} launches), warm-L2 replay {replay[model][name]:.3f} ms per step")
            del params, batches


# ---------------------------------------------------------------------------
# The trainer loop (phase 10): examples/train_lm.py's features on lm-100m
# ---------------------------------------------------------------------------

# the adaptive run: the controller's buckets (exact first: it starts there
# and must step down) and the target SNR, low enough that it leaves the
# exact bucket and walks down to the cheaper ones
ADAPTIVE_BUDGETS = (None, 1.0, 0.5, 0.1)
ADAPTIVE_SNR = 0.02
LOOP_STEPS = 12
COST_STEPS = 6  # each run of the controller's per-step fetch against a constant schedule
CKPT_STEPS, CKPT_EVERY = 6, 3
RESUME_RTOL = 1e-5  # resumed losses against the straight run's
# accumulation against the hand-averaged microbatches: the same operations
# in the same order; float32 tolerances, should a library reduction on the
# card (the embedding's gradient) sum in another order
ACCUM_RTOL, ACCUM_ATOL = 1e-5, 1e-6
ACCUM_CARRY_RTOL = 1e-6  # of the site's largest score
LOOP_SEED = 31


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def loop_opt(steps, lazy=False):
    """examples/train_lm.py's optimizer: AdamW, cosine warm-up, clip 1.0
    (``lazy``: LazyAdam, for compact gradients)."""
    from repro_torch.optim import adamw, cosine_warmup

    return adamw(cosine_warmup(3e-4, max(10, steps // 20), steps), weight_decay=0.1, clip=1.0,
                 lazy=lazy)


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def adaptive_loop(dev, total):
    """The trainer loop's main path: Runtime.train with the adaptive
    schedule and a JSONL sink, LOOP_STEPS steps; every step's budget one of
    the controller's buckets, two or more sketched buckets, per step 84 score
    and 84 fused launches when sketched and none when exact, a finite
    probe_snr at every sketched step, one JSONL record per step. Then the
    controller's per-step fetch against a constant schedule, interleaved."""
    import tempfile

    from repro_torch import rng
    from repro_torch.api import BudgetSchedule, ExecutionConfig, Runtime, TelemetryConfig
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import TrainerConfig

    cfg = lm100m()
    schedule = BudgetSchedule.adaptive(target_snr=ADAPTIVE_SNR, budgets=ADAPTIVE_BUDGETS,
                                       window=2)
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "telemetry.jsonl")
        runtime = Runtime(policy=slice_policy(0.2), schedule=schedule, device=dev,
                          execution=ExecutionConfig(telemetry=TelemetryConfig(jsonl=jsonl)))
        buckets = schedule.make_controller(runtime.policy).budgets
        seen = []  # (history entry, launch counts after its step)

        data = LMStream(vocab=cfg.vocab, seed=0).batches(BATCH, SEQ)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, hist = runtime.train(cfg, loop_opt(LOOP_STEPS), data,
                                TrainerConfig(steps=LOOP_STEPS, log_every=1),
                                on_metrics=lambda m: seen.append((m, ops.launch_counts())))
        sync(dev)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        with open(jsonl) as f:
            records = [json.loads(line) for line in f]
    add_counts(total, counts)
    sketched = [h for h in hist if h["budget"] is not None]
    if len(hist) != LOOP_STEPS or not all(h["budget"] in buckets for h in hist):
        raise AssertionError(f"budgets {[h['budget'] for h in hist]} outside {buckets}")
    if len({h["budget"] for h in sketched}) < 2:
        raise AssertionError(f"fewer than two sketched buckets ran: {[h['budget'] for h in hist]}")
    prev = {k: 0 for k in counts}
    for h, c in seen:
        delta = {k: c[k] - prev[k] for k in c}
        prev = c
        want = (expected_counts("pallas", 1)
                if h["budget"] is not None else expected_counts("pallas", 0))
        if delta != want:
            raise AssertionError(f"step {h['step']} (budget {h['budget']}) launched {delta}, "
                                 f"want {want}")
    if counts != expected_counts("pallas", len(sketched)):
        raise AssertionError(f"the adaptive run launched {counts} over {len(sketched)} "
                             "sketched steps")
    if not all(math.isfinite(h.get("probe_snr", math.nan)) for h in sketched):
        raise AssertionError(f"probe_snr not finite: {[h.get('probe_snr') for h in sketched]}")
    if [r["step"] for r in records] != list(range(LOOP_STEPS)):
        raise AssertionError(f"JSONL records for steps {[r['step'] for r in records]}")
    keys = [sorted(r["probe_sites"]) for r in records if r["budget"] is not None]
    if any(k != keys[0] for k in keys) or len(keys[0]) != 7 or \
            any("probe_sites" in r for r in records if r["budget"] is None):
        raise AssertionError(f"JSONL probe_sites keys differ: {keys}")
    print(f"[loop] adaptive lm-100m, batch {BATCH}x{SEQ}, pallas l1@0.2 block {BLOCK}, target "
          f"SNR {ADAPTIVE_SNR}, buckets {list(ADAPTIVE_BUDGETS)} (controller order "
          f"{list(buckets)}), {LOOP_STEPS} steps in {wall:.2f} s: budgets "
          f"{[h['budget'] for h in hist]}")
    snr = [round(h.get("probe_snr", math.nan), 4) for h in hist]
    var = [float("%.4g" % h.get("probe_var", math.nan)) for h in hist]
    print(f"[loop]   probe_snr {snr}; probe_var {var}; losses "
          f"{[round(h['loss'], 4) for h in hist]}")
    print(f"[loop]   step ms {[round(1e3 * h['step_s'], 1) for h in hist]}; launches {counts} "
          f"({len(sketched)} sketched steps x {7 * cfg.n_layers} each); {len(records)} JSONL "
          f"records, probe_sites keys {keys[0]}")

    # the adaptive controller fetches the scalars after every step (a host
    # sync); a constant schedule does not. One bucket (0.1) in both, probes on
    # in both, histories only at the first and last step; three interleaved
    # pairs, and the controller's fetches timed (the host waiting for the card)
    from repro_torch.train import trainer as trainer_mod

    runs = {"adaptive": BudgetSchedule.adaptive(target_snr=ADAPTIVE_SNR, budgets=(0.1,)),
            "constant": BudgetSchedule.constant(0.1)}
    ms, waits = {k: [] for k in runs}, []
    real_fetch = trainer_mod._host_metrics

    def timed_fetch(metrics, *, scalars_only=False):
        t0 = time.perf_counter()
        out = real_fetch(metrics, scalars_only=scalars_only)
        if scalars_only:
            waits.append(1e3 * (time.perf_counter() - t0))
        return out

    trainer_mod._host_metrics = timed_fetch
    try:
        for name in ("adaptive", "constant", "constant", "adaptive", "adaptive", "constant"):
            runtime = Runtime(policy=slice_policy(0.2), schedule=runs[name], device=dev,
                              execution=ExecutionConfig(telemetry=TelemetryConfig(
                                  per_site=False)))
            state = runtime.init_state(rng.fold_in(LOOP_SEED, 0), cfg, loop_opt(COST_STEPS))
            data = LMStream(vocab=cfg.vocab, seed=1).batches(BATCH, SEQ)
            ops.reset_launch_counts()
            sync(dev)
            t0 = time.perf_counter()
            runtime.train(cfg, loop_opt(COST_STEPS), data,
                          TrainerConfig(steps=COST_STEPS, log_every=10 * COST_STEPS),
                          state=state, on_metrics=lambda m: None)
            sync(dev)
            ms[name].append(1e3 * (time.perf_counter() - t0) / COST_STEPS)
            add_counts(total, ops.launch_counts())
            del state
    finally:
        trainer_mod._host_metrics = real_fetch
    if len(waits) != 3 * COST_STEPS:
        raise AssertionError(f"{len(waits)} per-step fetches in 3 adaptive runs")
    print(f"[loop] the adaptive controller's per-step fetch (budget 0.1, probes on, "
          f"{COST_STEPS} steps per run, order A C C A A C): ms/step adaptive "
          f"{[round(v, 1) for v in ms['adaptive']]}, constant "
          f"{[round(v, 1) for v in ms['constant']]}; the fetch waits {np.mean(waits):.2f} ms "
          f"per step (median {np.median(waits):.2f}, max {max(waits):.2f})")


def profiled_step(dev, fn, state, batch, key):
    """One step under the profiler: (state, metrics, device ops, device busy
    ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = fn(state, batch, key)
        float(m["loss"])
        sync(dev)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return state, m, sum(e.count for e in kern), sum(_device_us(e) for e in kern) / 1e3


def probes_on_off(dev, total):
    """Per backend, one lm-100m step with and without probes from the same
    parameters, batch and seed: parameters, carry and optimizer state equal
    bit for bit, the same launches; then paired, interleaved steps (off, on,
    on, off): wall ms, and device ops and busy ms from a profiled step each."""
    from repro_torch import rng
    from repro_torch.api import ExecutionConfig, Runtime, TelemetryConfig
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    cfg = lm100m()
    batches = [b for b, _ in zip(LMStream(vocab=cfg.vocab, seed=LOOP_SEED).batches(BATCH, SEQ),
                                 range(4))]
    for backend in BACKENDS:
        fns, states, counts, metrics = {}, {}, {}, {}
        for probes in (False, True):
            runtime = Runtime(policy=slice_policy(0.2, backend), device=dev,
                              execution=ExecutionConfig(
                                  telemetry=TelemetryConfig() if probes else None))
            opt = loop_opt(LOOP_STEPS)
            params = lm.init_params(rng.fold_in(LOOP_SEED, 0), cfg, device=dev)
            states[probes] = runtime.init_state(0, cfg, opt, params=params)
            fns[probes] = runtime.train_step(cfg, opt)
        for probes in (False, True):
            ops.reset_launch_counts()
            states[probes], metrics[probes] = fns[probes](states[probes], batches[0], 32)
            sync(dev)
            counts[probes] = ops.launch_counts()
            add_counts(total, counts[probes])
        want = expected_counts(backend, 1)
        if counts[False] != want or counts[True] != want:
            raise AssertionError(f"{backend}: launches without / with probes {counts[False]} / "
                                 f"{counts[True]}, want {want}")
        pairs = list(zip(tree_leaves(states[False].params) + tree_leaves(states[False].opt_state),
                         tree_leaves(states[True].params) + tree_leaves(states[True].opt_state)))
        differ = [i for i, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
        if differ or not torch.equal(metrics[False]["loss"], metrics[True]["loss"]):
            worst = max((a - b).abs().max().item() for a, b in pairs)
            raise AssertionError(f"{backend}: leaves {differ} of {len(pairs)} (params, then the "
                                 f"AdamW moments) differ with probes on (largest |diff| "
                                 f"{worst:.3e})")
        m = metrics[True]
        snr = float(m["probe_snr"])
        if not math.isfinite(snr) or len(m["probe_sites"]) != 7:
            raise AssertionError(f"{backend}: probe summary {snr}, {len(m['probe_sites'])} sites")
        wall = {False: [], True: []}
        ops.reset_launch_counts()
        for i, probes in enumerate((False, True, True, False)):
            sync(dev)
            t0 = time.perf_counter()
            states[probes], mm = fns[probes](states[probes], batches[1 + i % 2], 33 + i)
            float(mm["loss"])
            sync(dev)
            wall[probes].append(1e3 * (time.perf_counter() - t0))
        # the profiler, on the main path's backend only: each traced step
        # takes seconds to summarise (~20,000 device ops)
        prof = {}
        for probes in (False, True):
            if backend == "pallas":
                states[probes], last, n_ops, busy = profiled_step(
                    dev, fns[probes], states[probes], batches[3], 40)
                prof[probes] = f"{n_ops} device ops, busy {busy:.2f} ms"
            else:
                states[probes], last = fns[probes](states[probes], batches[3], 40)
                prof[probes] = "not traced"
        add_counts(total, ops.launch_counts())
        print(f"[probes] {backend}: one lm-100m step with probes on and off: {len(pairs)} leaves "
              f"(params, carry, AdamW moments) equal bit for bit, loss "
              f"{float(metrics[True]['loss']):.6f}, launches {counts[True]} both; probe_snr "
              f"{snr:.4f}, probe_var {float(m['probe_var']):.6g}, probe_gsq "
              f"{float(m['probe_gsq']):.6g}")
        print(f"[probes]   wall ms off / on (order off, on, on, off): "
              f"{[round(v, 1) for v in wall[False]]} / {[round(v, 1) for v in wall[True]]}; "
              f"one more step off / on: {prof[False]} / {prof[True]}; at that step, the run's "
              f"{states[True].step}th: probe_snr {float(last['probe_snr']):.4f}, "
              f"probe_var {float(last['probe_var']):.6g}, probe_gsq "
              f"{float(last['probe_gsq']):.6g}")
        del states, fns


def _capture_opt():
    """An optimizer that leaves the parameters as they are and returns the
    gradients it was given as its state (the carry is still written back)."""
    from repro_torch.optim import Optimizer

    return Optimizer(lambda p: {}, lambda grads, state, params, step: (params, grads))


def accum_check(dev, total):
    """One ``stale`` lm-100m step at accum=2 (two microbatches of 4): 168
    fused launches; its gradients equal the mean of the two microbatches' run
    alone under their seeds (``micro_seed``) from the same state, within
    ACCUM_RTOL / ACCUM_ATOL, and its written-back carry the mean of their
    refreshed scores within ACCUM_CARRY_RTOL of the largest score."""
    from repro_torch import rng
    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.core import plan_state as pstate
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import TrainState, micro_seed
    from repro_torch.tree import tree_leaves, tree_map

    cfg = lm100m()
    opt = _capture_opt()
    policy = slice_policy(0.2, "stale")
    rt1 = Runtime(policy=policy, device=dev)
    rt2 = Runtime(policy=policy, device=dev, execution=ExecutionConfig(accum=2))
    step1, step2 = rt1.train_step(cfg, opt), rt2.train_step(cfg, opt)
    batches = [b for b, _ in zip(LMStream(vocab=cfg.vocab, seed=51).batches(BATCH, SEQ),
                                 range(2))]
    state0 = rt1.init_state(rng.fold_in(51, 0), cfg, opt)
    state0, _ = step1(state0, batches[0], 50)  # a carry that is not the prior

    def clone():
        return TrainState(params=tree_map(lambda t: t.detach().clone(), state0.params),
                          opt_state={}, step=state0.step)

    key = 52
    ops.reset_launch_counts()
    s_acc, m_acc = step2(clone(), batches[1], key)
    sync(dev)
    counts = ops.launch_counts()
    add_counts(total, counts)
    if counts != expected_counts("stale", 2):
        raise AssertionError(f"the accum=2 stale step launched {counts}")
    grads = [tree_leaves(s_acc.opt_state)]
    carries, losses = [], []
    half = BATCH // 2
    for m in range(2):
        mb = {k: v[m * half:(m + 1) * half] for k, v in batches[1].items()}
        ops.reset_launch_counts()
        s_m, m_m = step1(clone(), mb, micro_seed(key, m))
        add_counts(total, ops.launch_counts())
        grads.append(tree_leaves(s_m.opt_state))
        carries.append(pstate.collect_plan_state(s_m.params)[1])
        losses.append(float(m_m["loss"]))
    sync(dev)
    worst_g = 0.0  # the largest |a - b| / (atol + rtol |b|)
    for a, g0, g1 in zip(*grads):
        want = g0 / 2 + g1 / 2
        worst_g = max(worst_g, ((a - want).abs() / (ACCUM_ATOL + ACCUM_RTOL * want.abs()))
                      .max().item())
    got_carry = pstate.collect_plan_state(s_acc.params)[1]
    worst_c = 0.0
    for path, v in got_carry.items():
        want = carries[0][path] / 2 + carries[1][path] / 2
        worst_c = max(worst_c, ((v - want).abs().max() / want.abs().max()).item())
    if not worst_g <= 1.0 or not worst_c <= ACCUM_CARRY_RTOL or len(got_carry) != 7 * cfg.n_layers:
        raise AssertionError(f"accum=2 against the microbatches: gradients {worst_g:.3f} of the "
                             f"tolerance, carry {worst_c:.3e} (tol {ACCUM_CARRY_RTOL})")
    loss_err = abs(float(m_acc["loss"]) - (losses[0] + losses[1]) / 2)
    # wall time: the accum=2 step against one batch-8 step (no update in
    # either: the capture optimizer), interleaved
    wall = {1: [], 2: []}
    ops.reset_launch_counts()
    for k in (2, 1, 1, 2):
        st = clone()
        sync(dev)
        t0 = time.perf_counter()
        _, mm = (step2 if k == 2 else step1)(st, batches[1], key)
        float(mm["loss"])
        sync(dev)
        wall[k].append(1e3 * (time.perf_counter() - t0))
        del st
    add_counts(total, ops.launch_counts())
    print(f"[accum] stale accum=2 (two microbatches of {half}): launches {counts}; "
          f"{len(grads[0])} gradients equal the microbatches' mean (largest error {worst_g:.3f} "
          f"of rtol {ACCUM_RTOL} / atol {ACCUM_ATOL}); {len(got_carry)} carries their mean "
          f"(largest {worst_c:.3e} of the largest score, tol {ACCUM_CARRY_RTOL}); loss "
          f"{float(m_acc['loss']):.6f}, |diff| from the microbatches' mean {loss_err:.3e}")
    print(f"[accum]   wall ms per step (order accum 2, accum 1, accum 1, accum 2; batch "
          f"{BATCH}x{SEQ}, no optimizer update): accum 2 {[round(v, 1) for v in wall[2]]}, "
          f"accum 1 {[round(v, 1) for v in wall[1]]}")


def ckpt_resume(dev, total):
    """``warmup_exact(2)``, ``stale`` l1@0.2, CKPT_STEPS steps straight; then
    the same run stopped at CKPT_EVERY (one checkpoint) and resumed by a fresh
    Runtime to CKPT_STEPS (a second): the resumed losses equal the straight
    run's within RESUME_RTOL; both checkpoints verify; one with a leaf
    corrupted by hand is refused and ``restore`` falls back to the other."""
    import tempfile
    import warnings

    from repro_torch.api import BudgetSchedule, Runtime
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.train import checkpoint as ckmod
    from repro_torch.train.trainer import TrainerConfig

    cfg = lm100m()
    timings = []  # (what, step, seconds)
    real_snap, real_write = ckmod._snapshot, ckmod._write

    def snap(tree):
        t0 = time.perf_counter()
        out = real_snap(tree)
        timings.append(("snapshot", None, time.perf_counter() - t0))
        return out

    def write(ckpt_dir, step, host_flat, keep):
        t0 = time.perf_counter()
        real_write(ckpt_dir, step, host_flat, keep)
        timings.append(("write", step, time.perf_counter() - t0))

    def run(steps, ckpt_dir=None, start=0):
        runtime = Runtime(policy=slice_policy(0.2, "stale"),
                          schedule=BudgetSchedule.warmup_exact(2), device=dev)
        data = LMStream(vocab=cfg.vocab, seed=41).batches(BATCH, SEQ, start_step=start)
        ops.reset_launch_counts()
        state, hist = runtime.train(cfg, loop_opt(CKPT_STEPS), data,
                                    TrainerConfig(steps=steps, log_every=1, ckpt_dir=ckpt_dir,
                                                  ckpt_every=CKPT_EVERY),
                                    on_metrics=lambda m: None)
        sync(dev)
        add_counts(total, ops.launch_counts())
        return state, hist

    _, straight = run(CKPT_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        ckmod._snapshot, ckmod._write = snap, write
        try:
            run(CKPT_EVERY, tmp)
            state, resumed = run(CKPT_STEPS, tmp, start=CKPT_EVERY)
        finally:
            ckmod._snapshot, ckmod._write = real_snap, real_write
        if [h["step"] for h in resumed] != list(range(CKPT_EVERY, CKPT_STEPS)):
            raise AssertionError(f"the resumed run ran steps {[h['step'] for h in resumed]}")
        worst = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                    for a, b in zip(resumed, straight[CKPT_EVERY:]))
        if not worst <= RESUME_RTOL:
            raise AssertionError(f"resumed losses differ from the straight run's by {worst:.3e}")
        steps = sorted(ckmod._all_steps(tmp))
        if steps != [CKPT_EVERY, CKPT_STEPS] or not all(ckmod.verify(tmp, s) for s in steps):
            raise AssertionError(f"checkpoints {steps} do not all verify")
        sizes = {s: sum(os.path.getsize(os.path.join(tmp, f"step_{s:012d}", f))
                        for f in os.listdir(os.path.join(tmp, f"step_{s:012d}"))) for s in steps}
        last = os.path.join(tmp, f"step_{CKPT_STEPS:012d}")
        leaf = sorted(f for f in os.listdir(last) if f.endswith(".npy"))[0]
        with open(os.path.join(last, leaf), "r+b") as f:
            f.seek(-1, os.SEEK_END)
            byte = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0xFF]))
        if ckmod.verify(tmp, CKPT_STEPS) or ckmod.latest_verified_step(tmp) != CKPT_EVERY:
            raise AssertionError("a corrupted checkpoint passed verification")
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            restored, got = ckmod.restore(tmp, state, device=dev)
        if got != CKPT_EVERY or restored.step != CKPT_EVERY or \
                not any("falling back" in str(w.message) for w in rec):
            raise AssertionError(f"restore after corruption gave step {got}")
        del restored
    writes = [(s, t) for what, s, t in timings if what == "write"]
    snaps = [t for what, _, t in timings if what == "snapshot"]
    print(f"[ckpt] stale l1@0.2, warmup_exact(2), {CKPT_STEPS} steps straight and resumed at "
          f"{CKPT_EVERY} by a fresh Runtime: budgets {[h['budget'] for h in straight]}; losses "
          f"{[round(h['loss'], 6) for h in straight]}; resumed "
          f"{[round(h['loss'], 6) for h in resumed]}, largest relative difference {worst:.3e} "
          f"(tol {RESUME_RTOL})")
    print(f"[ckpt]   checkpoints {steps} verify; step {CKPT_STEPS} with leaf {leaf} corrupted is "
          f"refused and restore falls back to step {got}; written: "
          + ", ".join(f"step {s}: {sizes[s] / 1e9:.3f} GB in {t:.2f} s ({sizes[s] / 1e9 / t:.2f} "
                      f"GB/s)" for s, t in writes)
          + f"; snapshots to host {[round(t, 3) for t in snaps]} s")


def trainer_loop(dev):
    """Phase 10: the trainer loop's features on lm-100m. Returns the launches
    of all its runs."""
    total = {}
    for part in (adaptive_loop, probes_on_off, accum_check, ckpt_resume):
        t0 = time.perf_counter()
        part(dev, total)
        print(f"[time]   {part.__name__} {time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# The serving engines (phase 11): continuous batching over a paged KV cache
# and the run-to-completion engine, serving lm-100m
# ---------------------------------------------------------------------------

ENGINE_SLOTS = 8
ENGINE_MAX_LEN = 1024
ENGINE_PAGE = 16
ENGINE_REQUESTS = 32  # plus one over-long prompt, which is left-truncated
ENGINE_PROMPTS = (16, 768)  # prompt lengths, uniform, inclusive
ENGINE_NEW = (8, 64)  # max_new, uniform, inclusive
ENGINE_LONG = 1100
ENGINE_SEED = 0  # the requests
ENGINE_PARAM_SEED = 23
ENGINE_REF = 8  # requests decoded one at a time as the reference
ENGINE_TRAIN_STEPS = 3
# the single-device engines' tokens of phases 11 and 16, which phase 20's mesh
# engines must equal: {config: {engine: {request: tokens}}}
ENGINE_TOKENS: dict = {}


def engine_specs(vocab):
    """The phase's requests, from numpy with ENGINE_SEED: (prompt, max_new)
    pairs, the over-long prompt in the middle of the queue."""
    rng = np.random.default_rng(ENGINE_SEED)
    lens = rng.integers(ENGINE_PROMPTS[0], ENGINE_PROMPTS[1] + 1, size=ENGINE_REQUESTS)
    news = rng.integers(ENGINE_NEW[0], ENGINE_NEW[1] + 1, size=ENGINE_REQUESTS)
    specs = [(rng.integers(1, vocab, size=n).astype(np.int32), int(m)) for n, m in zip(lens, news)]
    long = (rng.integers(1, vocab, size=ENGINE_LONG).astype(np.int32),
            int(rng.integers(ENGINE_NEW[0], ENGINE_NEW[1] + 1)))
    specs.insert(ENGINE_REQUESTS // 2, long)
    return specs


def engine_requests(specs):
    from repro_torch.serve.engine import Request

    return [Request(prompt=p.copy(), max_new=m) for p, m in specs]


def engine_expected(specs, sv, *, paged, pack, exact=False):
    """The counters the scheduler's rules give for these requests with no
    stop token (each request emits exactly max_new tokens, the first from
    its prefill): strict FIFO, worst-case page reservation, prompts packed
    page-aligned into one max_len row when ``pack``, each wave prefilled at
    its bucket, or at its one prompt's length when ``exact`` (a recurrent
    layout). A restatement of the rules on the host, independent of the
    engine's code."""
    items, trunc = [], 0
    for p, m in specs:
        n = min(len(p), sv.max_len - m)
        trunc += len(p) - n
        items.append((n, m))
    P = sv.page_size
    align = P if pack else 1
    queue = list(items)
    free_pages = sv.pool_pages - 1 if paged else 0
    slots = []  # [emitted, max_new, pages] of the live requests
    out = dict(prefill_calls=0, prefill_tokens=0, decode_steps=0, wasted_decode_steps=0,
               tokens_out=sum(m for _, m in items), truncated_tokens=trunc,
               requests_done=len(items))

    def need(n, m):
        return -(-(n + m) // P)

    def admit(n, m):
        nonlocal free_pages
        pages = need(n, m) if paged else 0
        free_pages -= pages
        if m > 1:
            slots.append([1, m, pages])
        else:
            free_pages += pages

    while queue or slots:
        while len(slots) < sv.n_slots and queue:
            wave, used, left = [], 0, free_pages
            while queue and len(wave) < sv.n_slots - len(slots):
                n, m = queue[0]
                aligned = -(-n // align) * align
                if wave and (not pack or used + aligned > sv.max_len):
                    break
                if paged:
                    if need(n, m) > left:
                        break
                    left -= need(n, m)
                wave.append(queue.pop(0))
                used += aligned
            if not wave:
                break
            out["prefill_calls"] += 1
            out["prefill_tokens"] += used if exact else sv.bucket_for(used)
            for n, m in wave:
                admit(n, m)
        if slots:
            out["decode_steps"] += 1
            out["wasted_decode_steps"] += sv.n_slots - len(slots)
            for s in slots:
                s[0] += 1
            free_pages += sum(s[2] for s in slots if s[0] >= s[1])
            slots = [s for s in slots if s[0] < s[1]]
    return out


def legacy_expected(specs, batch, max_len, pad_ok=True):
    """The run-to-completion engine's counters: batches in arrival order, each
    prefilled right-padded to its longest prompt (``pad_ok``) or, for a
    recurrent layout, in one unpadded call per distinct prompt length, then
    decoding max(max_new) - 1 steps on every lane."""
    out = dict(prefill_calls=0, prefill_tokens=0, decode_steps=0, wasted_decode_steps=0,
               tokens_out=0, truncated_tokens=0)
    for i in range(0, len(specs), batch):
        part = specs[i:i + batch]
        M = max(m for _, m in part)
        lens = [min(len(p), max_len - m) for p, m in part]
        out["prefill_calls"] += 1 if pad_ok else len(set(lens))
        out["prefill_tokens"] += batch * max(lens) if pad_ok else sum(lens)
        out["decode_steps"] += M - 1
        out["tokens_out"] += sum(m for _, m in part)
        out["truncated_tokens"] += sum(max(len(p) - (max_len - m), 0) for p, m in part)
        out["wasted_decode_steps"] += (sum(sum(1 for _, m in part if t >= m) for t in range(1, M))
                                       + (batch - len(part)) * (M - 1))
    return out


def run_engine(dev, params, cfg, make, specs, label):
    """Build an engine with ``make()``, serve ``specs`` with the launch counts
    set to 0 just before ``run`` and read just after (every kernel must stay
    at 0: every prefill batch carries segments, decode runs the plain
    attention). Returns (engine, requests, wall seconds, launches)."""
    from repro_torch.kernels import ops

    eng = make()
    reqs = engine_requests(specs)
    sync(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{label}: the engine launched kernels {counts}, want none")
    if not all(r.out is not None and len(r.out) == r.max_new and r.stop == "length"
               for r in reqs):
        raise AssertionError(f"{label}: a request did not finish by length")
    return eng, reqs, wall, counts


def check_counters(label, got, want):
    have = {k: got[k] for k in want}
    print(f"[engine] {label}: counters {have}")
    if have != want:
        raise AssertionError(f"{label}: counters {have}, the scheduler's rules give {want}")


def reference_tokens(dev, params, cfg, specs, idx):
    """Sequential decoding of requests ``idx``, one at a time with plain
    attention: the left-truncated prompt's prefill, then greedy decode steps
    at batch 1."""
    from repro_torch.api import Runtime
    from repro_torch.serve import greedy_sample

    runtime = Runtime(device=dev)
    prefill = runtime.prefill_step(cfg, ENGINE_MAX_LEN)
    decode = runtime.decode_step(cfg)
    out = {}
    for i in idx:
        p, m = specs[i]
        p = p[-(ENGINE_MAX_LEN - m):]
        logits, caches = prefill(params, {"tokens": p[None]})
        cur = greedy_sample(logits[:, -1:])
        toks = []
        for t in range(m):
            toks.append(cur)
            if t + 1 < m:
                logits, caches = decode(params, caches, cur, len(p) + t)
                cur = greedy_sample(logits)
        out[i] = torch.cat(toks, dim=1)[0].cpu().tolist()
        del caches
    return out


def near_tie(dev, params, cfg, prompt, prefix, rtol=LOGIT_RTOL):
    """The reference's teacher-forced logits for the token after ``prompt`` +
    ``prefix`` (plain attention, one forward): (top-2 margin, tolerance
    ``rtol`` times the largest |logit|)."""
    from repro_torch.models import lm
    from repro_torch.nn.common import Ctx

    toks = torch.as_tensor(np.concatenate([prompt, np.asarray(prefix, np.int32)]),
                           device=dev).long()[None]
    with torch.no_grad():
        lg = lm.forward(params, {"tokens": toks}, Ctx(), cfg)[0, -1].float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1]), rtol * float(lg.abs().max())


def compare_tokens(dev, params, cfg, specs, runs, rtol=LOGIT_RTOL):
    """Every request's greedy tokens in every run against the first run's.
    Where two runs differ, the first differing step must be a float32 near
    tie of the reference's teacher-forced logits (``rtol`` of the largest).
    Returns the differences."""
    base_label, base = runs[0]
    diffs = []
    for label, toks in runs[1:]:
        for i, want in base.items():
            got = toks.get(i)
            if got is None or got == want:
                continue
            t = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
            p, m = specs[i]
            margin, tol = near_tie(dev, params, cfg, p[-(ENGINE_MAX_LEN - m):], want[:t], rtol)
            print(f"[engine]   request {i}: {label} differs from {base_label} first at step "
                  f"{t} ({got[t]} vs {want[t]}); the reference's top-2 margin there {margin:.3e}"
                  f", tol {tol:.3e}")
            if margin >= tol:
                raise AssertionError(f"request {i}: {label} and {base_label} differ at step {t} "
                                     f"where the logits are no near tie ({margin:.3e} >= "
                                     f"{tol:.3e})")
            diffs.append((label, i, t))
    return diffs


def legacy_latencies(eng, batch):
    """TTFT and latency of each request of the run-to-completion engine, from
    its per-batch ring (every request is submitted when the run starts; a
    batch starts when the one before it ends)."""
    ttft, lat, t = [], [], 0.0
    for rec in eng.ring.records:
        ttft += [t + rec["prefill_s"]] * rec["batch"]
        t += rec["prefill_s"] + rec["decode_s"]
        lat += [t] * rec["batch"]
    return {q: (float(np.percentile(ttft, q)), float(np.percentile(lat, q))) for q in (50, 99)}


def print_telemetry(label, t, extra=None):
    f = {k: t.get(k) for k in ("decode_tok_per_s", "prefill_tok_per_s", "ttft_p50_s", "ttft_p99_s",
                               "latency_p50_s", "latency_p99_s", "wasted_decode_steps")}
    if extra:
        f.update(extra)
    print(f"[engine] {label} telemetry: decode {f['decode_tok_per_s']:.1f} tok/s, prefill "
          f"{f['prefill_tok_per_s']:.1f} tok/s, TTFT p50/p99 {f['ttft_p50_s']:.4f} / "
          f"{f['ttft_p99_s']:.4f} s, latency p50/p99 {f['latency_p50_s']:.4f} / "
          f"{f['latency_p99_s']:.4f} s, wasted decode steps {f['wasted_decode_steps']}; "
          f"decode {t['decode_s']:.3f} s, prefill {t['prefill_s']:.3f} s, builds "
          f"{t['trace_counts']}")


def check_chrome(path, n_requests):
    """The exported Chrome trace holds one ``request`` span per request, each
    with its queued, prefill and decode children."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    reqs = [e for e in events if e["name"] == "request"]
    kids = {}
    for e in events:
        if e["name"] in ("queued", "prefill", "decode"):
            kids.setdefault(e["args"].get("parent_id"), set()).add(e["name"])
    ok = all(kids.get(e["args"]["span_id"]) == {"queued", "prefill", "decode"} for e in reqs)
    if len(reqs) != n_requests or not ok:
        raise AssertionError(f"{path}: {len(reqs)} request spans (want {n_requests}), "
                             f"children complete: {ok}")
    return len(events)


def engine_decode_trace(dev, params, cfg, specs, plain):
    """A profiler trace of one paged engine decode step (all slots live):
    device ops, busy ms, device-to-host copies (must be 1), the page gather's
    and scatter's device time and bytes; beside phase 8's plain decode step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Runtime, ServeConfig
    from repro_torch.obs import clock

    sv = ServeConfig(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN, page_size=ENGINE_PAGE)
    eng = Runtime(device=dev).serve(params, cfg, serve=sv)
    eng.scheduler.submit(engine_requests([(p[:200], 64) for p, _ in specs[:ENGINE_SLOTS]]),
                         clock.now())
    eng._refill()
    eng._decode_one_step()  # warm
    sync(dev)
    t0 = time.perf_counter()
    eng._decode_one_step()
    sync(dev)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng._decode_one_step()
        sync(dev)
    evts = prof.key_averages()
    kern = [e for e in evts if e.device_type == DeviceType.CUDA]
    d2h = sum(e.count for e in kern if e.key.startswith("Memcpy DtoH"))
    # every copy the profiler saw on the device, by kind (small pageable
    # host-to-device copies need not show as device activity)
    copies = {e.key: e.count for e in kern if e.key.startswith("Memcpy")}
    n_ops = sum(e.count for e in kern)
    busy = sum(_device_us(e) for e in kern) / 1e3
    cpu = {e.key: e for e in evts if e.device_type == DeviceType.CPU}

    def dev_ms(key):
        e = cpu.get(key)
        return (getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)) / 1e3 \
            if e is not None else 0.0

    # the gather reads each distinct page of the map once (the map's trash
    # entries all name page 0) and writes every slot's max_len positions
    L, kv = cfg.n_layers, cfg.n_kv * cfg.head_dim * 4
    pages = len(np.unique(eng.scheduler.page_map))
    read = 2 * L * pages * ENGINE_PAGE * kv
    written = 2 * L * ENGINE_SLOTS * ENGINE_MAX_LEN * kv
    scatter = 2 * L * ENGINE_SLOTS * kv
    print(f"[engine-trace] one paged decode step, {ENGINE_SLOTS} live slots at max_len "
          f"{ENGINE_MAX_LEN}: {wall_ms:.2f} ms wall (unprofiled), {n_ops} device ops, busy "
          f"{busy:.2f} ms; device-to-host copies {d2h} (device copies by kind: {copies}); "
          f"page gather (aten::index_select) {dev_ms('aten::index_select'):.3f} ms "
          f"device, {read / 1e6:.1f} MB read ({pages} distinct pages) + {written / 1e6:.1f} MB "
          f"written (bound {(read + written) / HBM_BYTES_PER_S * 1e3:.3f} ms); scatter "
          f"(aten::index_put_) {dev_ms('aten::index_put_'):.3f} ms device, "
          f"{scatter / 1e6:.3f} MB each way")
    print(f"[engine-trace]   phase 8's plain decode step (batch {SERVE_WAVES[0][0]}, cache "
          f"{SERVE_WAVES[0][1] + DECODE_STEPS}): {plain['ops']} device ops, busy "
          f"{plain['busy_ms']:.2f} ms, {plain['call_ms']:.2f} ms per call")
    for e in sorted(kern, key=_device_us, reverse=True)[:6]:
        print(f"[engine-trace]   device {_device_us(e) / 1e3:8.3f} ms x{e.count:<5d} {e.key[:80]}")
    if d2h != 1:
        raise AssertionError(f"an engine decode step made {d2h} device-to-host copies, want 1")
    del eng


def engine_trainer(dev, tmp, total):
    """Runtime.train of lm-100m for ENGINE_TRAIN_STEPS steps under the pallas
    policy with ObsConfig on: the exported trace holds train_loop and
    train_step for every step, the compile ledger one entry per bucket, the
    memory ledger a peak above 0."""
    from repro_torch.api import ExecutionConfig, ObsConfig, Runtime
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import TrainerConfig

    cfg = lm100m()  # plain attention: the flash kernel is forward-only
    chrome = os.path.join(tmp, "train_trace.json")
    runtime = Runtime(policy=slice_policy(0.2), device=dev,
                      execution=ExecutionConfig(obs=ObsConfig(chrome_trace=chrome,
                                                              crash_dir=tmp)))
    data = LMStream(vocab=cfg.vocab, seed=ENGINE_SEED).batches(BATCH, SEQ)
    ops.reset_launch_counts()
    _, hist = runtime.train(cfg, loop_opt(ENGINE_TRAIN_STEPS), data,
                            TrainerConfig(steps=ENGINE_TRAIN_STEPS, log_every=1))
    sync(dev)
    counts = ops.launch_counts()
    add_counts(total, counts)
    if counts != expected_counts("pallas", ENGINE_TRAIN_STEPS):
        raise AssertionError(f"trainer with obs on launched {counts}")
    with open(chrome) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events}
    steps = sorted(e["args"]["step"] for e in events if e["name"] == "train_step")
    if not {"train_loop", "build_buckets", "first_call"} <= names or \
            steps != list(range(ENGINE_TRAIN_STEPS)):
        raise AssertionError(f"trainer trace: names {sorted(names)}, train_step steps {steps}")
    rep = runtime.observability().report()
    entries = rep["compile"]["entries"]
    mem = rep["memory"]["by_key"]
    buckets = runtime.schedule.buckets()
    if len(entries) != len(buckets) or set(mem) != {e["key"] for e in entries} or \
            not all((v["peak_GB_per_dev"] or 0) > 0 for v in mem.values()):
        raise AssertionError(f"ledgers: {len(entries)} compile entries for {len(buckets)} "
                             f"buckets, memory {mem}")
    first = {e["key"]: e["first_call_s"] for e in entries}
    print(f"[engine-train] lm-100m pallas l1@0.2, {ENGINE_TRAIN_STEPS} steps with ObsConfig on: "
          f"losses {[round(h['loss'], 6) for h in hist]}; trace {len(events)} spans "
          f"(train_step steps {steps}); compile ledger {len(entries)} entry for "
          f"{len(buckets)} bucket, first_call_s {first}; memory ledger "
          + "; ".join(f"peak {v['peak_GB_per_dev']:.3f} GB (held before the call "
                      f"{v['argument_GB_per_dev']:.3f}, left {v['output_GB_per_dev']:.3f}, "
                      f"temp {v['temp_GB_per_dev']:.3f})" for v in mem.values())
          + f"; metrics {rep['metrics']}; launches {counts}")


def serving_engines(dev, plain_decode):
    """Phase 11: the serving engines on lm-100m (see the module docstring).
    Returns the launches of its runs."""
    import tempfile

    from repro_torch.api import ExecutionConfig, ObsConfig, Runtime, ServeConfig
    from repro_torch.models import lm
    from repro_torch.serve.legacy import RunToCompletionEngine

    cfg = lm100m().replace(attn_impl="pallas")
    plain_cfg = cfg.replace(attn_impl="chunked")
    params = lm.init_params(ENGINE_PARAM_SEED, cfg, device=dev)
    specs = engine_specs(cfg.vocab)
    sv = ServeConfig(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN, page_size=ENGINE_PAGE)
    total = {}
    runtime = Runtime(device=dev)
    kv_bytes = sv.pool_pages * sv.page_size * 2 * cfg.n_layers * cfg.n_kv * cfg.head_dim * 4
    print(f"[engine] lm-100m, attn_impl pallas, {len(specs)} requests (prompts "
          f"{[len(p) for p, _ in specs]}, max_new {[m for _, m in specs]}), eos None; "
          f"ServeConfig(n_slots={sv.n_slots}, max_len={sv.max_len}, page_size={sv.page_size}): "
          f"{sv.pool_pages} pages, {kv_bytes / 1e9:.3f} GB of K/V")
    t_phase = time.perf_counter()

    def paged(rt=runtime):
        return rt.serve(params, cfg, serve=sv)

    eng, reqs, wall, counts = run_engine(dev, params, cfg, paged, specs, "paged")
    add_counts(total, counts)
    tele = eng.telemetry()
    check_counters("paged", tele, engine_expected(specs, sv, paged=True, pack=True))
    buckets = {k for k in tele["trace_counts"] if k.startswith("prefill[")}
    if tele["trace_counts"].get("decode") != 1 or tele["trace_counts"].get("insert") != 1 or \
            any(tele["trace_counts"][k] != 1 for k in buckets) or \
            not all(int(k[8:-1]) in sv.buckets() for k in buckets):
        raise AssertionError(f"builds {tele['trace_counts']}")
    print_telemetry("paged", tele)
    paged_tokens = {i: r.out.tolist() for i, r in enumerate(reqs)}
    walls = {"off": [wall], "on": []}
    del eng

    eng, reqs, wall, counts = run_engine(
        dev, params, cfg, lambda: runtime.serve(params, cfg, serve=sv.replace(page_size=None)),
        specs, "contiguous")
    add_counts(total, counts)
    tele = eng.telemetry()
    check_counters("contiguous", tele, engine_expected(specs, sv.replace(page_size=None),
                                                       paged=False, pack=False))
    print_telemetry("contiguous", tele)
    contig_tokens = {i: r.out.tolist() for i, r in enumerate(reqs)}
    del eng

    eng, reqs, wall_l, counts = run_engine(
        dev, params, cfg,
        lambda: RunToCompletionEngine(params, cfg, batch=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                                      runtime=runtime), specs, "run-to-completion")
    add_counts(total, counts)
    tele = eng.telemetry()
    want = legacy_expected(specs, ENGINE_SLOTS, ENGINE_MAX_LEN)
    check_counters("run-to-completion", tele, want)
    lat = legacy_latencies(eng, ENGINE_SLOTS)
    print_telemetry("run-to-completion", tele, {
        "ttft_p50_s": lat[50][0], "ttft_p99_s": lat[99][0], "latency_p50_s": lat[50][1],
        "latency_p99_s": lat[99][1]})
    print("[engine]   (the run-to-completion TTFT and latency come from its per-batch ring: "
          "every request submitted when the run starts)")
    legacy_tokens = {i: r.out.tolist() for i, r in enumerate(reqs)}
    ENGINE_TOKENS["lm-100m"] = {"paged": paged_tokens, "run-to-completion": legacy_tokens}
    del eng

    t0 = time.perf_counter()
    ref_idx = list(range(0, len(specs), len(specs) // ENGINE_REF))[:ENGINE_REF]
    if ENGINE_REQUESTS // 2 not in ref_idx:
        ref_idx[-1] = ENGINE_REQUESTS // 2  # the truncated request
    ref = reference_tokens(dev, params, plain_cfg, specs, ref_idx)
    print(f"[engine] sequential reference of requests {ref_idx}: "
          f"{time.perf_counter() - t0:.1f} s")

    # obs on and off, interleaved after the first (off) run: off, on, on, off
    obs_tokens = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, on in enumerate((True, True, False)):
            obs = None
            if on:
                d = os.path.join(tmp, f"run{i}")
                obs = ObsConfig(chrome_trace=os.path.join(d, "serve.json"),
                                trace_jsonl=os.path.join(d, "serve.jsonl"), crash_dir=d)
            rt = Runtime(device=dev, execution=ExecutionConfig(obs=obs))
            eng, reqs, wall, counts = run_engine(dev, params, cfg, lambda rt=rt: paged(rt),
                                                 specs, f"obs {'on' if on else 'off'}")
            add_counts(total, counts)
            walls["on" if on else "off"].append(wall)
            obs_tokens.append((f"paged, obs {'on' if on else 'off'} (run {i + 2})",
                               {j: r.out.tolist() for j, r in enumerate(reqs)}))
            if on:
                ob = rt.observability()
                snap = ob.metrics_snapshot()
                n_events = check_chrome(obs.chrome_trace, len(specs))
                with open(obs.trace_jsonl) as f:
                    n_lines = sum(1 for line in f if line.strip())
                if snap.get("serve.requests_done") != len(specs) or n_lines != n_events:
                    raise AssertionError(f"obs run {i}: requests_done "
                                         f"{snap.get('serve.requests_done')}, JSONL {n_lines} "
                                         f"lines for {n_events} Chrome events")
                print(f"[engine] obs on (run {i + 2}): Chrome trace {n_events} spans, "
                      f"{len(specs)} request spans with queued/prefill/decode children, "
                      f"JSONL {n_lines} lines; serve.requests_done "
                      f"{snap['serve.requests_done']:.0f}, serve.decode_steps "
                      f"{snap['serve.decode_steps']:.0f}")
            del eng
        engine_trainer(dev, tmp, total)
    off, on = walls["off"], walls["on"]
    print(f"[engine] wall s per run, obs off {[round(w, 3) for w in off]} / on "
          f"{[round(w, 3) for w in on]} (order off, on, on, off): mean on over mean off "
          f"{100 * (sum(on) / len(on) / (sum(off) / len(off)) - 1):+.2f}%")

    for label, toks in obs_tokens:
        if toks != paged_tokens:
            raise AssertionError(f"{label}: tokens differ from the first paged run's")
    diffs = compare_tokens(dev, params, plain_cfg, specs, [
        ("paged", paged_tokens), ("contiguous", contig_tokens),
        ("run-to-completion", legacy_tokens), ("sequential reference", ref)])
    print(f"[engine] greedy tokens: {len(specs)} requests equal in the paged runs with obs off "
          f"and on; against the contiguous and run-to-completion engines and, for {len(ref)} of "
          f"them, the sequential reference: {len(diffs)} differing (run, request, step)"
          + (f" {diffs}, each a float32 near tie" if diffs else ""))
    engine_decode_trace(dev, params, cfg, specs, plain_decode)
    print(f"[time]   serving engines {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Resilience (phase 12): the gradient sentinel, fault injection and the
# supervisor's rollback around the lm-100m trainer
# ---------------------------------------------------------------------------

# the sentinel's norm threshold for lm-100m at l1@0.2: the sketched
# estimator's own gradient norm spans ~4e3 (stale's first steps, sampled from
# the uniform prior) to ~1e9-1e11 (1/p-scaled blocks, compounded over 84
# sites), so JAX's default 1e3 would trip every sketched step; 1e13 sits two
# orders above the largest, and a spike of RES_SPIKE lands four orders or
# more beyond it, or overflows float32 (a non-finite norm: a trip too)
RES_MAX_GRAD_NORM = 1e13
RES_SPIKE = 1e14
RES_STEPS = 4  # steps of each run of the on/off comparison
RES_FAULT_AT = 1  # the nonfinite fault; the spike follows the escalation window
DRILL_STEPS, DRILL_EVERY = 18, 3
RES_SEED = 61
# a failed attempt left alive would hold its state, ~1.6 GB. After a run whose
# final state is deleted the allocator must be back where it started (to a
# few blocks); holding it, the figure moves by the caching allocator's block
# rounding (an allocation may take a cached block up to 1 MB larger)
MEM_SLACK = 16 << 20
HELD_SLACK = 256 << 20


def res_config(**kw):
    from repro_torch.api import ResilienceConfig

    return ResilienceConfig(max_grad_norm=RES_MAX_GRAD_NORM, **kw)


def state_leaves(state):
    from repro_torch.tree import tree_leaves

    return tree_leaves(state.params) + tree_leaves(state.opt_state)


def res_on_off(dev, total):
    """Per backend (pallas, stale): RES_STEPS lm-100m steps through
    Runtime.train with resilience off and through Supervisor with it on and no
    fault, in the order off, on, on, off: every final state equal bit for bit,
    sentinel_trip 0 at every step, the same launches; ms per step."""
    from repro_torch.api import ExecutionConfig, Runtime, Supervisor
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import TrainerConfig

    cfg = lm100m()
    tcfg = TrainerConfig(steps=RES_STEPS, log_every=1, seed=RES_SEED)
    for backend in ("pallas", "stale"):
        finals, ms, norms = {}, {False: [], True: []}, []
        for on in (False, True, True, False):
            runtime = Runtime(policy=slice_policy(0.2, backend), device=dev,
                              execution=ExecutionConfig(resilience=res_config() if on else None))
            data = LMStream(vocab=cfg.vocab, seed=RES_SEED).batches(BATCH, SEQ)
            ops.reset_launch_counts()
            sync(dev)
            t0 = time.perf_counter()
            if on:
                state, hist = Supervisor(runtime, cfg, loop_opt(RES_STEPS), tcfg).run(
                    data, on_metrics=lambda m: None)
            else:
                state, hist = runtime.train(cfg, loop_opt(RES_STEPS), data, tcfg,
                                            on_metrics=lambda m: None)
            sync(dev)
            ms[on].append(1e3 * (time.perf_counter() - t0) / RES_STEPS)
            counts = ops.launch_counts()
            add_counts(total, counts)
            if counts != expected_counts(backend, RES_STEPS):
                raise AssertionError(f"{backend} resilience {on}: launched {counts}")
            if on and any(h["sentinel_trip"] != 0.0 for h in hist):
                raise AssertionError(f"{backend}: the sentinel tripped with no fault: "
                                     f"{[(h['grad_norm'], h['sentinel_trip']) for h in hist]}")
            norms += [h["grad_norm"] for h in hist]
            if on not in finals:
                finals[on] = state
            del state
        pairs = list(zip(state_leaves(finals[False]), state_leaves(finals[True])))
        differ = [i for i, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"{backend}: leaves {differ} of {len(pairs)} differ with "
                                 "resilience on and no fault")
        del finals, pairs
        print(f"[res] {backend}: {RES_STEPS} lm-100m steps, resilience off (Runtime.train) and "
              f"on (Supervisor, no fault, max_grad_norm {RES_MAX_GRAD_NORM:g}): final states "
              f"equal bit for bit, sentinel_trip 0 at every step, launches "
              f"{expected_counts(backend, RES_STEPS)} each; grad_norm "
              f"{min(norms):.4g}..{max(norms):.4g}; ms per step (order off, on, on, off) off "
              f"{[round(v, 1) for v in ms[False]]}, on {[round(v, 1) for v in ms[True]]}")


def res_faults(dev, total):
    """Per backend (pallas, onepass, stale, compact pallas): a nonfinite fault
    at step RES_FAULT_AT and a spike (x RES_SPIKE) once its escalation window
    has closed, through Supervisor: each trips (sentinel_trip 1); the
    parameters, moments and carry are bit-identical through each tripped
    step; the next escalate_steps steps run exact with 0 launches, every
    sketched step its backend's; every leaf finite at the end."""
    from repro_torch import rng
    from repro_torch.api import ExecutionConfig, FaultPlan, FaultSpec, Runtime, Supervisor
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import TrainerConfig

    cfg = lm100m()
    rcfg = res_config()
    k = rcfg.escalate_steps
    spike_at = RES_FAULT_AT + 1 + k
    steps = spike_at + k + 2
    faulted = (RES_FAULT_AT, spike_at)
    want_budgets = [None if (RES_FAULT_AT < s <= RES_FAULT_AT + k or spike_at < s <= spike_at + k)
                    else 1.0 for s in range(steps)]
    plan = FaultPlan(faults=(FaultSpec(step=RES_FAULT_AT, kind="nonfinite"),
                             FaultSpec(step=spike_at, kind="spike", scale=RES_SPIKE)))
    for label in ("pallas", "onepass", "stale", "pallas-compact"):
        backend, compact = label.split("-")[0], label.endswith("compact")
        runtime = Runtime(policy=slice_policy(0.2, backend), device=dev,
                          execution=ExecutionConfig(resilience=rcfg, compact_grads=compact))
        opt = loop_opt(steps, lazy=compact)
        state = runtime.init_state(rng.fold_in(RES_SEED, 0), cfg, opt)
        live = state_leaves(state)  # updated in place by the optimizer and the carry write
        before, same, seen = {}, {}, []

        def on_metrics(m, live=live, before=before, same=same, seen=seen):
            seen.append((m, ops.launch_counts()))
            if m["step"] + 1 in faulted:
                before[m["step"] + 1] = [t.detach().clone() for t in live]
            if m["step"] in faulted:
                same[m["step"]] = all(torch.equal(a, b) for a, b in zip(before.pop(m["step"]),
                                                                        live))

        sup = Supervisor(runtime, cfg, opt, TrainerConfig(steps=steps, log_every=1,
                                                          seed=RES_SEED), fault_plan=plan)
        data = LMStream(vocab=cfg.vocab, seed=RES_SEED).batches(BATCH, SEQ)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = sup.run(data, on_metrics=on_metrics)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        add_counts(total, counts)
        budgets = [h["budget"] for h in hist]
        trips = [h["sentinel_trip"] for h in hist]
        if budgets != want_budgets or [s for s, t in enumerate(trips) if t] != list(faulted):
            raise AssertionError(f"{label}: budgets {budgets}, sentinel_trip {trips}")
        if not (same.get(RES_FAULT_AT) and same.get(spike_at)):
            raise AssertionError(f"{label}: a tripped step changed the state: {same}")
        prev = {k2: 0 for k2 in counts}
        for h, c in seen:
            delta = {k2: c[k2] - prev[k2] for k2 in c}
            prev = c
            if delta != expected_counts(backend, 0 if h["budget"] is None else 1):
                raise AssertionError(f"{label} step {h['step']} (budget {h['budget']}) "
                                     f"launched {delta}")
        if [e["event"] for e in sup.events] != ["fault_injected", "sentinel_trip"] * 2:
            raise AssertionError(f"{label}: events {sup.events}")
        if not all(torch.isfinite(t).all() for t in state_leaves(state)):
            raise AssertionError(f"{label}: a non-finite leaf after the run")
        n_leaves = len(live)
        del state, live
        causes = [e["cause"] for e in sup.events if e["event"] == "sentinel_trip"]
        print(f"[res-fault] {label}: nonfinite at step {RES_FAULT_AT}, spike x{RES_SPIKE:g} at "
              f"{spike_at}: both tripped ({causes}; loss, grad_norm at the spike "
              f"{hist[spike_at]['loss']:.4g}, {hist[spike_at]['grad_norm']:.4g}); {n_leaves} "
              f"leaves (params, carry, moments) bit-identical through each; budgets {budgets} "
              f"(exact steps 0 launches); launches {counts}; every leaf finite; "
              f"{steps} steps in {wall:.2f} s")


def sentinel_budgets(rcfg, trip_steps, start, steps):
    """The sentinel's rules on the host: ``[(step, budget)]`` of one attempt
    that starts at ``start`` (a fresh sentinel, a policy at budget 1.0) when
    the steps in ``trip_steps`` trip, and the step it rolls back at (or
    None)."""
    from repro_torch.api import GradSentinel

    sent, out = GradSentinel(rcfg), []
    for step in range(start, steps):
        out.append((step, sent.override(1.0)))
        sent.observe(step, {"loss": 1.0, "sentinel_trip": float(step in trip_steps)})
        if sent.should_rollback:
            return out, step
    return out, None


def res_drill(dev, total):
    """FaultPlan.drill(ckpt_every=DRILL_EVERY) over DRILL_STEPS steps under
    pallas with a checkpoint directory, a JSONL sink and ObsConfig on, through
    Supervisor, against the same run with no fault (see the module
    docstring)."""
    import tempfile

    from repro_torch.api import (ExecutionConfig, FaultPlan, ObsConfig, Runtime, Supervisor,
                                 TelemetryConfig)
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.resilience.faults import SOFT_KINDS
    from repro_torch.train import checkpoint as ckmod
    from repro_torch.train.trainer import TrainerConfig

    cfg = lm100m()
    rcfg = res_config()
    plan = FaultPlan.drill(ckpt_every=DRILL_EVERY)
    real_save = ckmod.save
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fault_plan in (("clean", None), ("drill", plan)):
            jsonl = os.path.join(tmp, f"{name}.jsonl")
            runtime = Runtime(policy=slice_policy(0.2), device=dev, execution=ExecutionConfig(
                resilience=rcfg, telemetry=TelemetryConfig(jsonl=jsonl, probes=False),
                obs=ObsConfig(crash_dir=os.path.join(tmp, f"{name}-crash"))))
            ckpt_dir = os.path.join(tmp, name)
            sup = Supervisor(runtime, cfg, loop_opt(DRILL_STEPS), TrainerConfig(
                steps=DRILL_STEPS, log_every=1, ckpt_dir=ckpt_dir, ckpt_every=DRILL_EVERY,
                seed=RES_SEED), fault_plan=fault_plan)
            saves = []  # the synchronous saves: (step, seconds, verified)

            def save(d, step, tree, keep=3, mesh=None, saves=saves):
                t0 = time.perf_counter()
                real_save(d, step, tree, keep=keep, mesh=mesh)
                saves.append((step, time.perf_counter() - t0, ckmod.verify(d, step)))

            seen = []
            data = LMStream(vocab=cfg.vocab, seed=RES_SEED).batches(BATCH, SEQ)
            sync(dev)
            mem0 = torch.cuda.memory_allocated(dev)
            ops.reset_launch_counts()
            ckmod.save = save
            t0 = time.perf_counter()
            try:
                state, hist = sup.run(data, on_metrics=lambda m, seen=seen: seen.append(
                    (m["step"], m["budget"], ops.launch_counts())))
            finally:
                ckmod.save = real_save
            sync(dev)
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            add_counts(total, counts)
            held = torch.cuda.memory_allocated(dev)
            final_step = state.step
            del state
            sync(dev)
            after = torch.cuda.memory_allocated(dev)
            with open(jsonl) as f:
                records = [json.loads(line) for line in f if line.strip()]
            ob = runtime.observability()
            out[name] = dict(sup=sup, hist=hist, seen=seen, counts=counts, wall=wall,
                             mem=(mem0, held, after), records=records, saves=saves,
                             final_step=final_step, ob=ob,
                             bundles=sorted(os.listdir(os.path.join(tmp, f"{name}-crash")))
                             if os.path.isdir(os.path.join(tmp, f"{name}-crash")) else [])
    clean, drill = out["clean"], out["drill"]
    sup = drill["sup"]
    events = sup.events
    kinds = [e["event"] for e in events]
    fired = sorted(e["step"] for e in events if e["event"] == "fault_injected")
    if fired != sorted(f.step for f in plan.faults) or clean["sup"].events:
        raise AssertionError(f"faults fired at {fired}; the clean run's events "
                             f"{clean['sup'].events}")
    rb = [e for e in events if e["event"] == "rollback"]
    if len(rb) != 1 or rb[0]["resume_step"] != 12 or rb[0]["steps_lost"] != 3 or \
            "ckpt_io_recovered" not in kinds or sup.recoveries != 1:
        raise AssertionError(f"drill events {events}")
    sync_saves = drill["saves"]
    if len(sync_saves) != 1 or not sync_saves[0][2]:
        raise AssertionError(f"synchronous checkpoint saves (step, s, verified) {sync_saves}")
    loss_c, loss_d = clean["hist"][-1]["loss"], drill["hist"][-1]["loss"]
    if not abs(loss_d - loss_c) < 0.5 * loss_c + 0.1 or drill["final_step"] != DRILL_STEPS:
        raise AssertionError(f"final loss {loss_d} against the clean run's {loss_c}")
    sunk = {r["event"] for r in drill["records"] if "event" in r}
    if not {"fault_injected", "sentinel_trip", "ckpt_io_recovered", "rollback"} <= sunk:
        raise AssertionError(f"JSONL sink events {sorted(sunk)}")
    # the launches by the sentinel's rules, on the host: the soft faults trip
    trip_steps = {f.step for f in plan.faults if f.kind in SOFT_KINDS}
    got_trips = {e["step"] for e in events if e["event"] == "sentinel_trip"}
    first, rolled_at = sentinel_budgets(rcfg, trip_steps, 0, DRILL_STEPS)
    retry, again = sentinel_budgets(rcfg, set(), rb[0]["resume_step"], DRILL_STEPS)
    want = [sb for sb in first if sb[0] != rolled_at] + retry
    got = [(h["step"], h["budget"]) for h in drill["hist"]]
    n_sketched = sum(b is not None for _, b in first + retry)
    if got_trips != trip_steps or rolled_at != rb[0]["step"] or again is not None or \
            got != want or drill["counts"] != expected_counts("pallas", n_sketched) or \
            clean["counts"] != expected_counts("pallas", DRILL_STEPS):
        raise AssertionError(f"trips {sorted(got_trips)} (faults {sorted(trip_steps)}), rollback "
                             f"at {rolled_at}; budgets {got}, by the rules {want}; launches "
                             f"{drill['counts']} for {n_sketched} sketched steps")
    prev = {k: 0 for k in drill["counts"]}
    for step, budget, c in drill["seen"]:
        delta = {k: c[k] - prev[k] for k in c}
        prev = c
        if delta != expected_counts("pallas", 0 if budget is None else 1):
            raise AssertionError(f"drill step {step} (budget {budget}) launched {delta}")
    builds = drill["ob"].report()["compile"]["entries"]
    if len(builds) != 2:
        raise AssertionError(f"{len(builds)} step builds across the attempts, want 2 (1.0, exact)")
    (m0c, heldc, afterc), (m0d, heldd, afterd) = clean["mem"], drill["mem"]
    if abs(heldd - heldc) > HELD_SLACK or abs(afterd - m0d) > MEM_SLACK or \
            abs(afterc - m0c) > MEM_SLACK:
        raise AssertionError(f"memory allocated (before, holding the final state, after): clean "
                             f"{clean['mem']}, drill {drill['mem']}")
    if "crash_000_ckpt_io" not in drill["bundles"] or \
            not any(b.endswith("_rollback") for b in drill["bundles"]):
        raise AssertionError(f"crash bundles {drill['bundles']}")
    [span] = drill["ob"].tracer.spans("recovery.rollback")
    [sync_span] = drill["ob"].tracer.spans("ckpt_save_sync")
    lost = sum(e["steps_lost"] for e in rb)
    wasted = lost / (DRILL_STEPS + lost)
    print(f"[drill] lm-100m pallas l1@0.2, FaultPlan.drill(ckpt_every={DRILL_EVERY}) "
          f"{[(f.step, f.kind) for f in plan.faults]} over {DRILL_STEPS} steps, through "
          f"Supervisor: events {kinds}")
    print(f"[drill]   every fault fired; sentinel trips at {sorted(got_trips)} (causes "
          f"{[e['cause'] for e in events if e['event'] == 'sentinel_trip']}); one rollback at "
          f"step {rb[0]['step']} to step {rb[0]['resume_step']}, steps_lost "
          f"{rb[0]['steps_lost']}; budgets {[b for _, b in got]}; launches {drill['counts']} = "
          f"{n_sketched} sketched steps by the sentinel's rules, 0 on the exact ones; step builds "
          f"{len(builds)} across both attempts")
    print(f"[drill]   ckpt_save_sync of step {sync_saves[0][0]}: {sync_saves[0][1]:.3f} s "
          f"(its span {sync_span.duration_s:.3f} s includes this check's CRC re-read), "
          f"verified; the rollback's wall "
          f"{rb[0]['wall_s']:.4f} s (recovery.rollback span {span.duration_s:.4f} s); "
          f"wasted_work_frac {wasted:.4f} ({lost} of {DRILL_STEPS + lost} steps)")
    print(f"[drill]   final loss {loss_d:.6f} against the clean run's {loss_c:.6f} "
          f"(|diff| {abs(loss_d - loss_c):.4g} < {0.5 * loss_c + 0.1:.4g}); wall s clean "
          f"{clean['wall']:.2f}, drill {drill['wall']:.2f}; memory allocated GB (before, holding "
          f"the final state, after) clean {[round(v / 1e9, 6) for v in clean['mem']]}, drill "
          f"{[round(v / 1e9, 6) for v in drill['mem']]}; crash bundles {drill['bundles']}; "
          f"JSONL {len(drill['records'])} records with events {sorted(sunk)}")


def resilience(dev):
    """Phase 12: resilience around the lm-100m trainer. Returns the launches
    of all its runs."""
    total = {}
    t_phase = time.perf_counter()
    for part in (res_on_off, res_faults, res_drill):
        t0 = time.perf_counter()
        part(dev, total)
        print(f"[time]   {part.__name__} {time.perf_counter() - t0:.1f} s")
    print(f"[time]   resilience {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Model families (phase 13): the named-config registry, olmoe-1b-7b (64
# experts top-8) and gemma3-1b (5 local : 1 global), trained and served
# ---------------------------------------------------------------------------

# training batch of both models: 2,048 token rows (olmoe's expert capacity is
# then ceil(2048 * 8 * 1.25 / 64) = 320 rows per bucket)
FAM_BATCH, FAM_SEQ = 4, 512
FAM_STEPS = 3
# olmoe trains at 2 of its 16 layers: float32 weights, gradients and AdamW's
# two moments take 16 B per parameter (~110 GB at 16); 4 until layer remat
# (PR 29), whose recompute of the host-bound steps took the script's time
OLMOE_TRAIN_LAYERS = 2
# serving (prompts, tokens per prompt): olmoe at full depth; gemma3 with
# prompts four times its 512-token window
FAM_SERVE = {"olmoe-1b-7b": (4, 512), "gemma3-1b": (2, 2048), "rwkv6-3b": (4, 512),
             "zamba2-7b": (4, 512), "qwen2-vl-2b": (4, 512), "seamless-m4t-large-v2": (4, 512)}
FAM_DECODE = 16
FAM_SEED = 41
# routing near ties (olmoe serving, flash against plain attention): float32
# reorderings move the router's probabilities by ~1e-7 (inputs ~1e-6 relative,
# probabilities ~1e-2); a token's k-th and (k+1)-th experts can swap only
# when their probabilities are closer than that. A swap whose margin in the
# plain run is below ROUTER_TIE is a near tie; a larger one fails the run
ROUTER_TIE = 1e-5
# the shapes of the families' kernels at l1@0.2, block 128, and their calls
# per step: (N, n, d, rb) -> calls (olmoe: 2 layers, 4 attention and 3 x 64
# expert sites each; gemma3: 26 layers of 7 sites)
FAM_BLOCK_SHAPES = {
    "olmoe-1b-7b": {(2048, 2048, 2048, 3): 8, (320, 1024, 2048, 2): 256,
                    (320, 2048, 1024, 3): 128},
    "gemma3-1b": {(2048, 1024, 1152, 2): 26, (2048, 256, 1152, 1): 52,
                  (2048, 1152, 1024, 2): 26, (2048, 6912, 1152, 11): 52,
                  (2048, 1152, 6912, 2): 26}}
# flash per prefill: (B, Sq, Skv, H, Kv, dh, causal, window) -> calls
FAM_FLASH_SHAPES = {
    "olmoe-1b-7b": {(4, 512, 512, 16, 16, 128, True, None): 16},
    "gemma3-1b": {(2, 2048, 2048, 4, 1, 256, True, 512): 22,
                  (2, 2048, 2048, 4, 1, 256, True, None): 4}}


def family_cfgs():
    """(olmoe training, olmoe serving, gemma3) configs from the registry:
    float32 (published bfloat16); olmoe's training depth cut to
    OLMOE_TRAIN_LAYERS; gemma3 at its full config."""
    from repro_torch.configs.registry import get_config

    f32 = dict(dtype="float32", param_dtype="float32")
    olmoe = get_config("olmoe-1b-7b").replace(**f32)
    return (olmoe.replace(n_layers=OLMOE_TRAIN_LAYERS), olmoe,
            get_config("gemma3-1b").replace(**f32))


def family_registry(dev):
    """Every named config from the registry passes the decoder check and its
    smoke config builds on the card; an unknown family is refused by name."""
    from repro_torch.configs import registry
    from repro_torch.models import lm

    names = []
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch.replace("_", "-"))
        lm.check_decoder(cfg)
        smoke = registry.smoke_config(arch)
        n = lm.num_params(lm.init_params(0, smoke, device=dev))
        names.append(f"{cfg.name} (smoke {n})")
    if len(names) != 10:
        raise AssertionError(f"{len(names)} named configs, want 10")
    odd = registry.get_config("yi-6b").replace(name="odd", family="diffusion")
    try:
        lm.check_decoder(odd)
    except NotImplementedError as e:
        if "odd: the diffusion family" not in str(e):
            raise AssertionError(f"the refusal does not name the config and family: {e}")
    else:
        raise AssertionError("an unknown family passed the decoder check")
    print(f"[families] registry: all {len(names)} named configs pass the decoder check and "
          f"their smoke configs build on the card: {names}; an unknown family refused by name")


def sites_per_step(cfg) -> int:
    """Sketched sites of one step of ``cfg``: every linear but the head and
    Mamba's ``ssm_small`` in_B/in_C/in_dt (the default policy leaves them
    exact); an RWKV layer's r, k, v, g, out, cm_k, cm_v and cm_r; an
    encoder-decoder's encoder layers, and its decoder's cross q, k, v, o."""
    from repro_torch.models import lm

    ffn = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    per = {"rwkv": 8, "mamba": 3}
    return sum(per.get(k.kind, 4 + 4 * k.cross + (3 * cfg.n_experts if k.moe else ffn))
               for k in lm.layer_kinds(cfg) + lm.encoder_kinds(cfg))


def family_counts(cfg, backend, steps):
    from repro_torch.kernels import ops

    n = steps * sites_per_step(cfg)
    return {name: n if name in SITE_KERNELS[backend] else 0 for name in ops.KERNELS}


def family_kernels(gen, dev, block_shapes, flash_shapes):
    """The score, fused and stream kernels at the families' ``block_shapes``
    (float32, the paths' type), an all-zero expert bucket among them, and
    flash at their prefills (``flash_shapes``), against the plain versions.
    Returns rows per kernel."""
    from repro_torch.kernels import col_scores
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sketch_matmul as sm

    f32 = torch.float32
    rows = {"col_l1_scores": [], "block_gather_matmul_fused": [],
            "block_stream_matmul_fused": [], "flash_attention": []}
    for model, shapes in block_shapes.items():
        for (N, n, d, rb), calls in shapes.items():
            idx = torch.sort(torch.randperm(n // BLOCK, generator=gen,
                                            device=dev)[:rb]).values.to(torch.int32)
            scales = 1.0 + 4.0 * torch.rand(rb, generator=gen, device=dev)
            W = torch.randn((n, d), generator=gen, device=dev) * d ** -0.5
            for zero in ((False, True) if N == 320 else (False,)):
                if zero:  # an expert no token chose: its bucket is zeros
                    G, X = torch.zeros((N, n), device=dev), torch.zeros((N, d), device=dev)
                else:
                    G = torch.randn((N, n), generator=gen, device=dev)
                    X = torch.randn((N, d), generator=gen, device=dev)
                args = (G, idx, scales, W, X)
                checks = [("col_l1_scores", col_scores.col_l1_scores(G),
                           col_scores.col_l1_scores_plain(G))]
                for name, kw in (("block_gather_matmul_fused", dict(with_scores=False)),
                                 ("block_gather_matmul_fused", dict(with_scores=True)),
                                 ("block_stream_matmul_fused", {})):
                    outs = getattr(sm, name)(*args, block=BLOCK, **kw)
                    want = getattr(sm, name + "_plain")(*args, block=BLOCK, **kw)
                    checks.extend((name, a, b) for a, b in zip(outs, want))
                torch.cuda.synchronize()
                errs = {}
                for name, a, b in checks:
                    if zero:
                        if a.any() or not torch.equal(a, b):
                            raise AssertionError(f"{name} on an all-zero bucket: not zeros")
                        e = 0.0
                    else:
                        e = max_err(a, b, 1e-5)[0]
                    errs[name] = max(errs.get(name, 0.0), e)
                if zero:
                    print(f"[family-kernel] {model} all-zero bucket {[N, n, d, rb]}: every "
                          "kernel gives its plain version's zeros")
                    continue
                tag = dict(model=model, shape=[N, n, d, rb], dtype="float32", calls=calls)
                kept = rb * BLOCK
                rows["col_l1_scores"].append(dict(
                    tag, shape=[N, n], mode="l1", max_abs_err=errs["col_l1_scores"],
                    ms=cuda_ms(lambda: col_scores.col_l1_scores(G)),
                    plain_ms=cuda_ms(lambda: col_scores.col_l1_scores_plain(G)),
                    library_ms=cuda_ms(lambda: G.abs().sum(0)),
                    **bound(4 * N * n + 4 * n, 2 * N * n, f32)))
                rows["block_gather_matmul_fused"].append(dict(
                    tag, with_scores=False, max_abs_err=errs["block_gather_matmul_fused"],
                    ms=cuda_ms(lambda: sm.block_gather_matmul_fused(*args, block=BLOCK)),
                    plain_ms=cuda_ms(lambda: sm.block_gather_matmul_fused_plain(
                        *args, block=BLOCK)),
                    **bound(4 * (N * kept + 2 * kept * d + 2 * N * d) + 8 * rb + 4 * kept,
                            4 * N * kept * d + 2 * N * kept, f32)))
                rows["block_stream_matmul_fused"].append(dict(
                    tag, mode="l1", max_abs_err=errs["block_stream_matmul_fused"],
                    ms=cuda_ms(lambda: sm.block_stream_matmul_fused(*args, block=BLOCK)),
                    plain_ms=cuda_ms(lambda: sm.block_stream_matmul_fused_plain(
                        *args, block=BLOCK)),
                    **bound(4 * (N * n + 2 * kept * d + 2 * N * d) + 8 * rb + 4 * kept + 4 * n,
                            4 * N * kept * d + 2 * N * n, f32)))
                for name in ("col_l1_scores", "block_gather_matmul_fused",
                             "block_stream_matmul_fused"):
                    print(f"[family-kernel] {name} {rows[name][-1]}")
                del G, X, args
    for model, shapes in flash_shapes.items():
        for (B, Sq, Skv, H, Kv, dh, causal, window), calls in shapes.items():
            q = torch.randn((B, Sq, H, dh), generator=gen, device=dev)
            k = torch.randn((B, Skv, Kv, dh), generator=gen, device=dev)
            v = torch.randn((B, Skv, Kv, dh), generator=gen, device=dev)
            kw = dict(causal=causal, window=window)
            got = fa.flash_attention(q, k, v, **kw)
            err, tol = max_err(got, fa.flash_attention_plain(q, k, v, **kw), TOL[f32])
            row = dict(model=model, shape=[B, Sq, Skv, H, Kv, dh], causal=causal,
                       window=window, dtype="float32", calls=calls, max_abs_err=err, tol=tol,
                       ms=cuda_ms(lambda: fa.flash_attention(q, k, v, **kw)),
                       plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw)),
                       library_ms=cuda_ms(sdpa_call(q, k, v, causal, window)),
                       **bound(4 * (2 * q.numel() + k.numel() + v.numel()),
                               4 * dh * B * H * unmasked_pairs(Sq, Skv, causal, window), f32))
            print(f"[family-kernel] flash_attention {row}")
            rows["flash_attention"].append(row)
            del q, k, v, got
    for name, rs in rows.items():
        for model in block_shapes:
            mine = [r for r in rs if r["model"] == model]
            if mine:
                print(f"[family-kernel] {name} {model}: {per_step(mine, 'ms'):.3f} ms per "
                      f"{'prefill' if name == 'flash_attention' else 'step'} (bound "
                      f"{per_step(mine, 'bound_ms'):.3f}, plain {per_step(mine, 'plain_ms'):.3f}"
                      + (f", library {per_step(mine, 'library_ms'):.3f}"
                         if "library_ms" in mine[0] else "") + ")")
    return rows


class RouteSpy:
    """Wraps ``nn.moe._moe_local`` and records, per call, each token's top-k
    expert set, its router margin (k-th against (k+1)-th probability), which
    of its replicas the capacity keeps, and the replicas dropped. The
    records are the router's own computation repeated; nothing of the
    layer's output changes."""

    def __init__(self):
        from repro_torch.nn import moe

        self.moe, self.real, self.calls = moe, moe._moe_local, []

    def __enter__(self):
        self.moe._moe_local = self
        return self

    def __exit__(self, *exc):
        self.moe._moe_local = self.real

    def __call__(self, router_w, wi, wg, wo, x2d, ctx, cfg, e_offset, n_total, cap):
        k = cfg.top_k
        with torch.no_grad():
            probs = torch.softmax(x2d.float() @ router_w.float().t(), dim=-1)
            top = torch.topk(probs, k + 1, dim=-1)
            ids = top.indices[:, :k]
            flat = ids.reshape(-1)
            order = torch.argsort(flat, stable=True)
            starts = torch.searchsorted(flat[order], torch.arange(n_total, device=flat.device))
            ranks = torch.empty_like(flat).scatter_(
                0, order, torch.arange(flat.numel(), device=flat.device) - starts[flat[order]])
            # each token's experts and their kept flags in expert order: the
            # top-k order of two equal sets may differ
            sets, by_expert = torch.sort(ids, dim=-1)
            keep = (ranks < cap).reshape(ids.shape).gather(-1, by_expert)
            self.calls.append(dict(sets=sets, keep=keep,
                                   margin=top.values[:, k - 1] - top.values[:, k],
                                   dropped=(~keep).sum()))
        return self.real(router_w, wi, wg, wo, x2d, ctx, cfg, e_offset, n_total, cap)


def family_grads(dev, cfg, backends, batch, seed):
    """Every exact gradient leaf finite; budget 0.999 under each backend
    against exact backprop: the loss, every gradient leaf (expert stacks and
    router included) within GRAD_RTOL of the leaf's largest magnitude, and
    exactly the backend's kernels at every site."""
    from repro_torch.api import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    params = lm.init_params(seed, cfg, device=dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    # the one leaf the loss may leave unread: the embedding table of a model
    # fed embeds and no tokens (the VLM), when no tied head reads it; every
    # other leaf must get a gradient
    unread = ([i for i, p in enumerate(leaves) if p is params["embed"]]
              if "embeds" in batch and "tokens" not in batch and not cfg.tie_embeddings
              else [])

    def grads(policy, key=7):
        ctx = Runtime(policy=policy, device=dev).ctx(key, n_layers=cfg.n_layers)
        loss, m = lm.lm_loss(params, batch, ctx, cfg, key if policy else None)
        gs = torch.autograd.grad(loss, leaves, allow_unused=bool(unread))
        none = [i for i, g in enumerate(gs) if g is None]
        if none != unread:
            raise AssertionError(f"{cfg.name}: leaves {none} got no gradient, want {unread}")
        return loss.detach(), m["aux"].detach(), [g for g in gs if g is not None]

    loss_e, aux_e, g_exact = grads(None)
    bad = sum(not bool(torch.isfinite(g).all()) for g in g_exact)
    if bad:
        raise AssertionError(f"{cfg.name}: {bad} of {len(g_exact)} exact gradient leaves are "
                             "not finite")
    print(f"[families] {cfg.name} ({cfg.n_layers} layers): all {len(g_exact)} exact gradient "
          "leaves finite" + (f" at SSM chunk {cfg.ssm_chunk}" if cfg.block_kind != "attn" else "")
          + (" (the embedding table, fed embeds, is unread)" if unread else ""))
    for backend in backends:
        ops.reset_launch_counts()
        loss_s, aux_s, g_sk = grads(slice_policy(0.999, backend))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if counts != family_counts(cfg, backend, 1):
            raise AssertionError(f"{cfg.name} {backend}@0.999 launched {counts}, want "
                                 f"{family_counts(cfg, backend, 1)}")
        if not (torch.equal(loss_s, loss_e) and torch.equal(aux_s, aux_e)):
            raise AssertionError(f"{cfg.name}: the forward changed under sketching: loss "
                                 f"{loss_s.item()} vs {loss_e.item()}")
        worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                    for a, b in zip(g_sk, g_exact))
        if not worst <= GRAD_RTOL:
            raise AssertionError(f"{cfg.name} {backend}@0.999 vs exact gradients: max rel err "
                                 f"{worst:.3e} > {GRAD_RTOL}")
        print(f"[families] {cfg.name} ({cfg.n_layers} layers) {backend} budget 0.999: "
              f"{len(g_sk)} gradient leaves equal exact backprop's, max rel err {worst:.3e} "
              f"(tol {GRAD_RTOL}); loss {loss_e.item():.6f} aux {aux_e.item():.6f}; "
              f"launches {counts}")
        del g_sk
    del params, leaves, g_exact


def grid_positions(B, S, grid):
    """[3, B, S] int64 M-RoPE positions in Qwen2-VL's layout for one grid x
    grid image and then text: the image's tokens at (t 0, h the row, w the
    column), text token i at grid + i in all three streams."""
    n = grid * grid
    pos = np.empty((3, S), np.int64)
    cells = np.arange(n)
    pos[0, :n], pos[1, :n], pos[2, :n] = 0, cells // grid, cells % grid
    pos[:, n:] = grid + np.arange(S - n)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, S)))


def stub_inputs(cfg, rs, batch):
    """``batch`` with a stub frontend's inputs drawn from the numpy generator
    ``rs`` (the frontends themselves are not modelled, as in JAX): the VLM's
    embeds (normal x 0.02) in place of its tokens, with the positions of one
    VLM_GRID x VLM_GRID image and then text; an encoder-decoder's
    src_embeds, AUDIO_FRAMES frames per row (normal x 0.02)."""
    B, S = batch["labels"].shape
    out = dict(batch)
    if cfg.frontend == "vision":
        out.pop("tokens", None)
        out["embeds"] = rs.standard_normal((B, S, cfg.d_model), dtype=np.float32) * 0.02
        out["positions"] = grid_positions(B, S, VLM_GRID)
    if cfg.is_encdec:
        out["src_embeds"] = rs.standard_normal((B, AUDIO_FRAMES, cfg.d_model),
                                               dtype=np.float32) * 0.02
    return out


def family_batches(cfg, seed):
    """The training batches of ``cfg``: LMStream's FAM_BATCH x FAM_SEQ tokens
    and labels from ``seed``; a stub frontend's inputs from numpy with the
    same seed (``stub_inputs``)."""
    from repro_torch.data.synthetic import LMStream

    rs = np.random.default_rng(seed)
    for batch in LMStream(vocab=cfg.vocab, seed=seed).batches(FAM_BATCH, FAM_SEQ):
        yield stub_inputs(cfg, rs, batch)


def family_train(dev, cfg, backend, data_seed, accum=1, steps=FAM_STEPS):
    """The main path of one family and backend: Runtime.train for ``steps``
    steps at l1@0.2, block 128, AdamW, accumulating over ``accum``
    microbatches, the launch counts set to 0 just before and read just
    after; losses and aux finite; the replicas dropped by the capacity
    counted."""
    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.trainer import TrainerConfig
    from repro_torch.tree import tree_leaves

    runtime = Runtime(policy=slice_policy(0.2, backend), execution=ExecutionConfig(accum=accum),
                      device=dev)
    opt = adamw(cosine_warmup(3e-4, 15, 300), weight_decay=0.1, clip=1.0)
    torch.cuda.reset_peak_memory_stats(dev)
    with RouteSpy() as spy:
        ops.reset_launch_counts()
        state, history = runtime.train(cfg, opt, family_batches(cfg, data_seed), TrainerConfig(
            steps=steps, log_every=1, seed=FAM_SEED))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    want = family_counts(cfg, backend, steps * accum)
    if counts != want:
        raise AssertionError(f"{cfg.name} {backend} accum {accum} main path launched {counts}, "
                             f"want {want}")
    losses = [h["loss"] for h in history]
    auxes = [h["aux"] for h in history]
    if len(history) != steps or not all(map(math.isfinite, losses + auxes)):
        raise AssertionError(f"{cfg.name} {backend}: losses {losses}, aux {auxes}")
    if not all(torch.isfinite(p).all() for p in tree_leaves(state.params)):
        raise AssertionError(f"{cfg.name} {backend}: non-finite parameters")
    replicas = sum(c["sets"].numel() for c in spy.calls)
    print(f"[families] {cfg.name} train {backend} l1@0.2 block {BLOCK}, batch "
          f"{FAM_BATCH}x{FAM_SEQ}" + (f" in {accum} microbatches" if accum > 1 else "")
          + f", {cfg.n_layers} layers, {sites_per_step(cfg)} sketched "
          f"sites per step: losses {losses}, aux {auxes}, step ms "
          f"{[round(1e3 * h['step_s'], 1) for h in history]} (first includes warm-up), peak "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {counts}"
          + (f", token replicas dropped by the capacity "
             f"{sum(int(c['dropped']) for c in spy.calls)} of {replicas}"
             if cfg.n_experts else ""))
    del state
    return counts


def family_breakdown(dev, cfg, data_seed, exact=True, profile_sketched=True):
    """One exact step (unless ``exact`` is False) beside one pallas l1@0.2
    step (AdamW, after a warm-up step each): synced ms per step, and under
    the profiler (the sketched step only if ``profile_sketched``)
    device-busy ms, device ops and the device-idle share; peak memory. The
    profiled sketched step's trace must hold every launch the counters
    count (``traced_step``)."""
    from repro_torch.api import Runtime
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw, cosine_warmup

    batches = [b for b, _ in zip(family_batches(cfg, data_seed), range(3))]
    runs = (("exact", None), ("pallas-l1@0.2", slice_policy(0.2)))
    for label, policy in runs if exact else runs[1:]:
        runtime = Runtime(policy=policy, device=dev)
        opt = adamw(cosine_warmup(3e-4, 15, 300), weight_decay=0.1, clip=1.0)
        torch.cuda.reset_peak_memory_stats(dev)
        state = runtime.init_state(FAM_SEED, cfg, opt)
        fn = runtime.train_step(cfg, opt)
        state, m = fn(state, batches[0], 1)
        float(m["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, batches[1], 2)
        float(m["loss"])
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        if policy is not None and not profile_sketched:
            print(f"[families] {cfg.name} breakdown {label}: {step_ms:.1f} ms/step (synced, one "
                  f"step); not profiled; peak memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
            del state, fn, opt
            torch.cuda.empty_cache()
            continue
        want = {} if policy is None else {name: n for name, n in
                                          family_counts(cfg, "pallas", 1).items() if n}
        box = [state]

        def run(attempt):
            ops.reset_launch_counts()
            box[0], m = fn(box[0], batches[2], 3 + attempt)
            float(m["loss"])
            torch.cuda.synchronize()
            counts = {name: n for name, n in ops.launch_counts().items() if n}
            if counts != want:
                raise AssertionError(f"{cfg.name} {label}: the traced step launched {counts}, "
                                     f"want {want}")

        kern = traced_step(run, want, f"{cfg.name} {label}")
        state = box.pop()  # the list must not keep this state alive past the label
        busy = sum(_device_us(e) for e in kern) / 1e3
        print(f"[families] {cfg.name} breakdown {label}: {step_ms:.1f} ms/step (synced, one "
              f"step); profiled step: device busy {busy:.1f} ms in "
              f"{sum(e.count for e in kern)} device ops, device idle "
              f"{100 * max(0.0, 1 - busy / step_ms):.0f}% of the unprofiled step; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        for e in sorted(kern, key=_device_us, reverse=True)[:4]:
            print(f"[families]   device {_device_us(e) / 1e3:8.2f} ms x{e.count:<6d} "
                  f"{e.key[:80]}")
        del state, fn, opt
        torch.cuda.empty_cache()


def _routing_divergence(ref_calls, run_calls, B, diverged):
    """Walk the MoE calls of two runs (layer by layer, in order) and mark in
    ``diverged`` the rows whose routing first differs. A row's first
    difference must be a top-k swap whose margin in the reference is below
    ROUTER_TIE, or a kept replica that differs in a call where some row's
    top-k set differs (the capacity is shared across rows). Returns
    (near-tie swaps, largest such margin)."""
    swaps, worst = 0, 0.0
    for ref, run in zip(ref_calls, run_calls, strict=True):
        rows = torch.arange(ref["sets"].shape[0], device=ref["sets"].device) // (
            ref["sets"].shape[0] // B)
        live = ~diverged[rows]
        differs = (ref["sets"] != run["sets"]).any(-1)
        flip = differs & live
        keepd = (ref["keep"] != run["keep"]).any(-1) & live & ~differs
        if flip.any():
            m = ref["margin"][flip]
            if not bool((m < ROUTER_TIE).all()):
                raise AssertionError(f"a top-k swap with router margin {m.max().item():.3e} "
                                     f">= {ROUTER_TIE}: not a near tie")
            swaps += int(flip.sum())
            worst = max(worst, m.max().item())
        if keepd.any() and not differs.any():
            raise AssertionError("kept replicas differ in a call whose routing does not")
        diverged[rows[flip | keepd]] = True
    return swaps, worst


def family_serve(dev, cfg, rtol=LOGIT_RTOL):
    """Serving of one family at its FAM_SERVE prompts (an encoder-decoder's
    over AUDIO_FRAMES source frames): Runtime.prefill_step with
    attn_impl="pallas" (one flash launch per attention: each layer's, the
    local layers' with their window, an encoder layer's and a decoder
    layer's cross-attention without the causal mask) and FAM_DECODE greedy
    decode_steps (no launch), the counts set to 0 before and read after
    each; then, for a model with attention, the same calls under plain
    attention, teacher-forced on the kernel run's tokens. Logits must agree
    within ``rtol`` of the largest logit, and a greedy token may differ only
    at a near tie (the plain run's logits of the two tokens closer than
    ``rtol`` of its largest). For MoE, rows whose routing diverged at a near
    tie (``_routing_divergence``) are counted and left out of the
    comparison. For a recurrent model (SSM or hybrid) and a stub-frontend
    family (VLM, audio), prefill plus the first decode step must also give
    the full forward's last logits within ``rtol`` (JAX's prefill/decode
    consistency rule). Returns the launch counts."""
    from repro_torch.api import Runtime
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.nn import moe
    from repro_torch.nn.common import Ctx
    from repro_torch.serve import greedy_sample

    def dropped(calls):
        return sum(int(c["dropped"]) for c in calls)

    decode_cap = moe.capacity(FAM_SERVE[cfg.name][0], moe.MoECfg(
        cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.capacity_factor)) if cfg.n_experts else 0

    cfg = cfg.replace(attn_impl="pallas")
    B, S = FAM_SERVE[cfg.name]
    attn = [k for k in lm.layer_kinds(cfg) if k.kind in ("attn", "shared_attn")]
    n_flash = len(attn) + sum(k.cross for k in attn) + len(lm.encoder_kinds(cfg))
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_params(FAM_SEED, cfg, device=dev)
    n_params = lm.num_params(params)
    rs = np.random.default_rng(FAM_SEED)
    prompts = rs.integers(1, cfg.vocab, size=(B, S))
    # the serving prompts are tokens at text positions; an encoder-decoder's
    # come with its source frames
    extra = {k: v for k, v in stub_inputs(cfg, rs, {"labels": prompts}).items()
             if k == "src_embeds"}
    runtime = Runtime(device=dev)
    prefill = runtime.prefill_step(cfg, S + FAM_DECODE)
    decode = runtime.decode_step(cfg)
    want = {name: 0 for name in ops.KERNELS}

    def generate(forced=None):
        with RouteSpy() as spy:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits, caches = prefill(params, {"tokens": prompts, **extra})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            after_prefill = ops.launch_counts()
            ops.reset_launch_counts()
            n_prefill = len(spy.calls)
            cur = greedy_sample(logits[:, -1:])
            fed, steps = [], []
            for i in range(FAM_DECODE):
                if forced is not None:
                    cur = forced[i]
                fed.append(cur)
                lg, caches = decode(params, caches, cur, S + i)
                steps.append(lg)
                cur = greedy_sample(lg)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            after_decode = ops.launch_counts()
        sizes = [c["k"].shape[1] for c in caches if "k" in c]
        return dict(logits=logits, fed=fed, steps=steps, counts=(after_prefill, after_decode),
                    calls=spy.calls, n_prefill=n_prefill, sizes=sizes,
                    ms=(1e3 * (t1 - t0), 1e3 * (t2 - t1)))

    run = generate()
    want["flash_attention"] = n_flash
    if run["counts"] != (want, {name: 0 for name in ops.KERNELS}):
        raise AssertionError(f"{cfg.name} serving launched {run['counts']} (prefill, decode); "
                             f"want {n_flash} flash per prefill, 0 in decode")
    want_sizes = [S + FAM_DECODE if k.window is None else min(k.window, S + FAM_DECODE)
                  for k in attn]
    if run["sizes"] != want_sizes:
        raise AssertionError(f"cache sizes {run['sizes']}, want {want_sizes}")
    consistency = None
    if cfg.block_kind != "attn" or cfg.frontend is not None:
        with torch.no_grad():
            full = lm.forward(params, {"tokens": torch.cat(
                [torch.as_tensor(prompts, device=dev), run["fed"][0].long()], dim=1),
                **{k: torch.as_tensor(v, device=dev) for k, v in extra.items()}}, Ctx(), cfg)
        last = full[:, -1]
        consistency = ((run["steps"][0][:, 0] - last).abs().max() / last.abs().max()).item()
        del full, last
        if not consistency <= rtol:
            raise AssertionError(f"{cfg.name}: prefill + decode against the forward's last "
                                 f"logits {consistency:.3e} > {rtol} of the largest")
    if not attn:  # nothing to compare against plain attention
        print(f"[families] {cfg.name} serve: {n_params} params ({cfg.n_layers} layers, "
              f"{4 * n_params / 2**30:.1f} GiB float32), {B} prompts x {S} tokens: prefill "
              f"{run['ms'][0]:.1f} ms ({B * S / run['ms'][0] * 1e3:.0f} tokens/s), "
              f"{FAM_DECODE} greedy decode steps {run['ms'][1] / FAM_DECODE:.2f} ms each; no "
              f"kernel launched; prefill + decode against the forward's last logits "
              f"{consistency:.3e} (tol {rtol} of the largest); peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        del params, run
        torch.cuda.empty_cache()
        return {name: 0 for name in ops.KERNELS}
    real = ops.flash_attention
    ops.flash_attention = fa.flash_attention_plain
    try:
        ref = generate(forced=run["fed"])
    finally:
        ops.flash_attention = real
    diverged = torch.zeros(B, dtype=torch.bool, device=dev)
    swaps, worst = 0, 0.0
    if cfg.n_experts:
        # the prefill's calls, then each decode step's, in order
        swaps, worst = _routing_divergence(ref["calls"][:ref["n_prefill"]],
                                           run["calls"][:run["n_prefill"]], B, diverged)
    keep = ~diverged
    errs = ([max_err(run["logits"][keep], ref["logits"][keep], rtol)[0]]
            if keep.any() else [])
    per_step = (len(run["calls"]) - run["n_prefill"]) // FAM_DECODE
    differ, worst_tie = 0, 0.0
    for i, (a, b) in enumerate(zip(run["steps"], ref["steps"])):
        if cfg.n_experts:
            lo = run["n_prefill"] + i * per_step
            s, w = _routing_divergence(ref["calls"][lo:lo + per_step],
                                       run["calls"][lo:lo + per_step], B, diverged)
            swaps, worst = swaps + s, max(worst, w)
        keep = ~diverged
        if keep.any():
            errs.append(max_err(a[keep], b[keep], rtol)[0])
        nxt = run["fed"][i + 1] if i + 1 < FAM_DECODE else greedy_sample(a)
        mine = greedy_sample(b)
        off = (mine != nxt)[:, 0] & keep
        if off.any():
            # the plain run's logits of its own token and of the kernel run's
            lg = b[:, 0].float()
            gap = (lg.gather(-1, mine.long()) - lg.gather(-1, nxt.long()))[off, 0]
            tie = rtol * lg[keep].abs().max()
            if not bool((gap <= tie).all()):
                raise AssertionError(f"{cfg.name} step {i}: a greedy token differs between "
                                     f"flash and plain attention at a logit gap "
                                     f"{gap.max().item():.3e} > {tie.item():.3e}: not a near tie")
            differ += int(off.sum())
            worst_tie = max(worst_tie, (gap / tie).max().item())
    if not keep.any():
        raise AssertionError(f"{cfg.name}: routing diverged in every prompt, none left to "
                             "compare")
    prefill_ms, decode_ms = run["ms"]
    print(f"[families] {cfg.name} serve: {n_params} params ({cfg.n_layers} layers, "
          f"{4 * n_params / 2**30:.1f} GiB float32), {B} prompts x {S} tokens, attn_impl "
          f"pallas: prefill {prefill_ms:.1f} ms ({B * S / prefill_ms * 1e3:.0f} tokens/s), "
          f"{FAM_DECODE} greedy decode steps {decode_ms / FAM_DECODE:.2f} ms each; launches "
          f"prefill {run['counts'][0]['flash_attention']} flash, decode 0; cache slots per "
          f"attention layer {sorted(set(run['sizes']))}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
          + (f"; prefill + decode against the forward's last logits {consistency:.3e} (tol "
             f"{rtol} of the largest)" if consistency is not None else ""))
    print(f"[families] {cfg.name} serve against plain attention (teacher-forced): logits max "
          f"|err| {max(errs):.3e} (tol {rtol} of the largest logit) over "
          f"{int(keep.sum())} of {B} prompts; greedy tokens differing {differ}"
          + (f" (each a near tie, largest gap {worst_tie:.2f} of the tie bound)" if differ
             else "")
          + (f"; routing swaps at near ties {swaps} (largest margin {worst:.3e}, threshold "
             f"{ROUTER_TIE}), prompts left out {int((~keep).sum())}; replicas dropped by the "
             f"capacity in the kernel run: prefill {dropped(run['calls'][:run['n_prefill']])} "
             f"of {B * S * cfg.top_k * cfg.n_layers}, decode "
             f"{dropped(run['calls'][run['n_prefill']:])} of "
             f"{B * FAM_DECODE * cfg.top_k * cfg.n_layers} (capacity "
             f"{decode_cap} per expert at N = {B})"
             if cfg.n_experts else ""))
    del params, run, ref
    torch.cuda.empty_cache()
    return {name: (n_flash if name == "flash_attention" else 0) for name in ops.KERNELS}


def families(dev, gen):
    """Phase 13. Returns (launches of its main paths, kernel rows)."""
    from repro_torch.core import solver
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import batch_to_device

    total = {name: 0 for name in ops.KERNELS}

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    t_phase = time.perf_counter()
    family_registry(dev)
    # the sampler of exact_r=False sketches on a NaN probability: nothing kept,
    # no device-side assert
    p = torch.tensor([0.5, float("nan"), 1.0, 0.0] * 256, device=dev)
    z = solver.sample_independent(gen, p)
    torch.cuda.synchronize()
    if z[1::4].any() or not z[2::4].all() or z[3::4].any():
        raise AssertionError("sample_independent kept a NaN or 0 column, or dropped a 1")
    print("[families] sample_independent on NaN probabilities: nothing kept, no assert")
    t0 = time.perf_counter()
    rows = family_kernels(gen, dev, FAM_BLOCK_SHAPES, FAM_FLASH_SHAPES)
    print(f"[time]   family kernels {time.perf_counter() - t0:.1f} s")
    olmoe_train, olmoe_serve, gemma = family_cfgs()
    for cfg, backends in ((olmoe_train, BACKENDS), (gemma, ("pallas",))):
        t0 = time.perf_counter()
        batch = batch_to_device(next(LMStream(vocab=cfg.vocab, seed=FAM_SEED).batches(
            FAM_BATCH, FAM_SEQ)), dev)
        family_grads(dev, cfg, backends, batch, FAM_SEED)
        del batch
        print(f"[time]   {cfg.name} budget-0.999 gradients {time.perf_counter() - t0:.1f} s")
        for backend in backends:
            t1 = time.perf_counter()
            add(family_train(dev, cfg, backend, FAM_SEED + 1))
            print(f"[time]   {cfg.name} train {backend} {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        # olmoe's sketched step (~154,000 device ops) takes ~90 s under the
        # profiler; the script's time goes to phase 14 instead
        family_breakdown(dev, cfg, FAM_SEED + 2, profile_sketched=not cfg.n_experts)
        torch.cuda.empty_cache()
        print(f"[time]   {cfg.name} breakdown {time.perf_counter() - t1:.1f} s")
        print(f"[time]   {cfg.name} training {time.perf_counter() - t0:.1f} s")
    for cfg in (olmoe_serve, gemma):
        t0 = time.perf_counter()
        add(family_serve(dev, cfg))
        print(f"[time]   {cfg.name} serving {time.perf_counter() - t0:.1f} s")
    print(f"[time]   families {time.perf_counter() - t_phase:.1f} s")
    return total, rows


# ---------------------------------------------------------------------------
# The SSM and hybrid families (phase 14): rwkv6-3b (RWKV6) and zamba2-7b
# (Mamba2 with a shared attention block), trained and served at full width
# ---------------------------------------------------------------------------

# float32 AdamW takes 16 B per parameter: rwkv6-3b's 32 layers (~3.1 B
# parameters, ~50 GB of state before activations) and zamba2-7b's 81 (~6.7 B)
# do not fit 80 GB. rwkv trains at 4 layers; zamba at 13: two periods of 6
# Mamba layers and the shared block, then a one-layer remainder, so both of
# the full plan's segment kinds run
# rwkv6-3b trains at 4 of 32 layers (8 until layer remat, PR 29, whose
# recompute of its host-bound steps took the script's time)
SSM_TRAIN_LAYERS = {"rwkv6-3b": 4, "zamba2-7b": 13}
# the families' kernel shapes at l1@0.2, block 128, and their calls per step:
# (N, n, d, rb) -> calls (rwkv: 4 layers of r/k/v/g/o/cm_r, cm_k, cm_v; zamba:
# 13 Mamba layers of in_z/in_x and out, 2 shared applications of q/k/v/o,
# mlp in/gate and out)
SSM_BLOCK_SHAPES = {
    "rwkv6-3b": {(2048, 2560, 2560, 4): 24, (2048, 8960, 2560, 14): 4,
                 (2048, 2560, 8960, 4): 4},
    "zamba2-7b": {(2048, 7168, 3584, 11): 26, (2048, 3584, 7168, 6): 13,
                  (2048, 3584, 3584, 6): 8, (2048, 14336, 3584, 22): 4,
                  (2048, 3584, 14336, 6): 2}}
# flash per prefill at full depth: the shared block's 13 applications (dh 112
# runs padded to 128)
SSM_FLASH_SHAPES = {"zamba2-7b": {(4, 512, 512, 32, 32, 112, True, None): 13}}
# zamba2-7b's serving logits at 81 layers. The random-init hybrid is
# sensitive in exact arithmetic: a relative change of 1e-7 in the embedding
# moves its logits by 1.9e-4 of the largest at 81 layers in float64 (d 256
# on the CPU; 4.9e-6 at 6 layers). Float32 reorderings of ~1e-6 in an
# attention output (flash against plain) or in a chunk (prefill against the
# forward) can so move the logits by ~1e-3 of the largest
SSM_LOGIT_RTOL = 1e-3


def f32_cfg(name, layers=None):
    """The registry's config, float32 (published bfloat16), cut to ``layers``
    (phases 14 to 16 and 20)."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(name).replace(dtype="float32", param_dtype="float32")
    if layers is None:
        return cfg
    return cfg.replace(n_layers=layers, **({"enc_layers": layers} if cfg.is_encdec else {}))


def ssm_families(dev, gen):
    """Phase 14. Returns (launches of its main paths, kernel rows)."""
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import batch_to_device

    total = {name: 0 for name in ops.KERNELS}

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    rows = family_kernels(gen, dev, SSM_BLOCK_SHAPES, SSM_FLASH_SHAPES)
    print(f"[time]   SSM family kernels {time.perf_counter() - t0:.1f} s")
    for name, layers in SSM_TRAIN_LAYERS.items():
        cfg = f32_cfg(name, layers)
        t0 = time.perf_counter()
        batch = batch_to_device(next(LMStream(vocab=cfg.vocab, seed=FAM_SEED).batches(
            FAM_BATCH, FAM_SEQ)), dev)
        family_grads(dev, cfg, BACKENDS, batch, FAM_SEED)
        del batch
        torch.cuda.empty_cache()
        print(f"[time]   {name} budget-0.999 gradients {time.perf_counter() - t0:.1f} s")
        for backend in BACKENDS:
            t1 = time.perf_counter()
            add(family_train(dev, cfg, backend, FAM_SEED + 1))
            torch.cuda.empty_cache()
            print(f"[time]   {name} train {backend} {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        family_breakdown(dev, cfg, FAM_SEED + 2, exact=False)
        torch.cuda.empty_cache()
        print(f"[time]   {name} breakdown {time.perf_counter() - t1:.1f} s")
        print(f"[time]   {name} training {time.perf_counter() - t0:.1f} s")
    for name in SSM_TRAIN_LAYERS:
        t0 = time.perf_counter()
        add(family_serve(dev, f32_cfg(name),
                         SSM_LOGIT_RTOL if name == "zamba2-7b" else LOGIT_RTOL))
        print(f"[time]   {name} serving {time.perf_counter() - t0:.1f} s")
    print(f"[time]   SSM families {time.perf_counter() - t_phase:.1f} s")
    return total, rows


# ---------------------------------------------------------------------------
# The VLM and audio families (phase 15): qwen2-vl-2b (M-RoPE over the vision
# stub) and seamless-m4t-large-v2 (encoder-decoder over the audio stub),
# trained and served at full width and depth
# ---------------------------------------------------------------------------

# the VLM's image: a 16 x 16 patch grid takes the first 256 of the 512 tokens
VLM_GRID = 16
# the audio stub's source frames per row: the encoder's length, and the
# cross-attention's keys
AUDIO_FRAMES = 768
VLM_AUDIO = ("qwen2-vl-2b", "seamless-m4t-large-v2")
# the training depths: half of each (qwen 14 of 28 layers, seamless 12 + 12
# of 24 + 24; full depth until layer remat, PR 29, whose recompute of the
# host-bound steps took the script's time); serving stays at full depth
VLM_TRAIN_LAYERS = {"qwen2-vl-2b": 14, "seamless-m4t-large-v2": 12}
# the families' kernel shapes at l1@0.2, block 128, and their calls per step:
# (N, n, d, rb) -> calls. qwen: 14 layers of q/o, k/v (GQA 12:2 of 128), mlp
# in/gate and out. seamless: N 3,072 (4 x 768 frames) at the encoder's 12
# layers of q/k/v/o and mlp in/out and at the decoder's cross k/v; N 2,048
# at the decoder's 12 layers of self q/k/v/o, cross q/o and mlp in/out
VLM_BLOCK_SHAPES = {
    "qwen2-vl-2b": {(2048, 1536, 1536, 2): 28, (2048, 256, 1536, 1): 28,
                    (2048, 8960, 1536, 14): 28, (2048, 1536, 8960, 2): 14},
    "seamless-m4t-large-v2": {(3072, 1024, 1024, 2): 72, (3072, 8192, 1024, 13): 12,
                              (3072, 1024, 8192, 2): 12, (2048, 1024, 1024, 2): 72,
                              (2048, 8192, 1024, 13): 12, (2048, 1024, 8192, 2): 12}}
# flash per prefill: qwen's 28 causal layers; seamless's 24 encoder layers
# (no causal mask, 768 x 768), 24 decoder self-attentions (causal 512 x 512)
# and 24 cross-attentions (no causal mask, 512 queries over 768 frames)
VLM_FLASH_SHAPES = {
    "qwen2-vl-2b": {(4, 512, 512, 12, 2, 128, True, None): 28},
    "seamless-m4t-large-v2": {(4, 768, 768, 16, 16, 64, False, None): 24,
                              (4, 512, 512, 16, 16, 64, True, None): 24,
                              (4, 512, 768, 16, 16, 64, False, None): 24}}


def vlm_audio(dev, gen):
    """Phase 15. Returns (launches of its main paths, kernel rows)."""
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import batch_to_device

    total = {name: 0 for name in ops.KERNELS}

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    rows = family_kernels(gen, dev, VLM_BLOCK_SHAPES, VLM_FLASH_SHAPES)
    print(f"[time]   VLM and audio kernels {time.perf_counter() - t0:.1f} s")
    for name in VLM_AUDIO:
        cfg = f32_cfg(name, VLM_TRAIN_LAYERS[name])
        t0 = time.perf_counter()
        batch = batch_to_device(next(family_batches(cfg, FAM_SEED)), dev)
        family_grads(dev, cfg, BACKENDS, batch, FAM_SEED)
        del batch
        torch.cuda.empty_cache()
        print(f"[time]   {name} budget-0.999 gradients {time.perf_counter() - t0:.1f} s")
        for backend in BACKENDS:
            t1 = time.perf_counter()
            add(family_train(dev, cfg, backend, FAM_SEED + 1))
            torch.cuda.empty_cache()
            print(f"[time]   {name} train {backend} {time.perf_counter() - t1:.1f} s")
        if cfg.rope == "mrope":
            # the [3, B, S] positions split on their batch axis (axis 1)
            t1 = time.perf_counter()
            add(family_train(dev, cfg, "stale", FAM_SEED + 1, accum=2, steps=1))
            torch.cuda.empty_cache()
            print(f"[time]   {name} train stale accum 2 {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        family_breakdown(dev, cfg, FAM_SEED + 2)
        torch.cuda.empty_cache()
        print(f"[time]   {name} breakdown {time.perf_counter() - t1:.1f} s")
        print(f"[time]   {name} training {time.perf_counter() - t0:.1f} s")
    for name in VLM_AUDIO:
        t0 = time.perf_counter()
        add(family_serve(dev, f32_cfg(name)))
        print(f"[time]   {name} serving {time.perf_counter() - t0:.1f} s")
    print(f"[time]   VLM and audio families {time.perf_counter() - t_phase:.1f} s")
    return total, rows


# ---------------------------------------------------------------------------
# The serving engines over every decoder family (phase 16): olmoe-1b-7b,
# gemma3-1b, rwkv6-3b, zamba2-7b and qwen2-vl-2b at full width, cut in depth
# ---------------------------------------------------------------------------

# each family's serving depth in phases 16 and 20: about a quarter of its
# published depth, a periodic plan keeping its remainder (gemma3 one period
# of 5 local + 1 global and 2 more; zamba2 three periods of 6 and 3 more). At
# full depth these two phases took a fifth of the script's time, which layer
# remat's recompute of the training phases needed to stay inside the time
# limit on a slow host (at half depth the script still took 1,108 s on one)
FE_LAYERS = {"olmoe-1b-7b": 4, "gemma3-1b": 8, "rwkv6-3b": 8, "zamba2-7b": 21,
             "qwen2-vl-2b": 7}

# (family, the layout the continuous engine plans at page_size FE_PAGE): paged
# for full-length K/V, contiguous for rings, contiguous with exact-length
# waves for recurrent state
FE_FAMILIES = (("olmoe-1b-7b", "paged"), ("gemma3-1b", "contiguous"),
               ("rwkv6-3b", "exact"), ("zamba2-7b", "exact"), ("qwen2-vl-2b", "paged"))
FE_SLOTS, FE_MAX_LEN, FE_PAGE = 4, 1024, 16
FE_REQUESTS = 10
FE_PROMPTS = (16, 768)  # prompt lengths, uniform, inclusive
FE_LONG = (513, 768)  # the first two prompts: past gemma3's 512-token window
FE_NEW = (4, 24)  # max_new, uniform, inclusive
FE_SEED = 53  # the requests (one stream per family, FE_SEED + its index)
FE_PARAM_SEED = 59
FE_REF = (0, 1, 5, 9)  # requests decoded one at a time as the reference
FE_TRACE = ("zamba2-7b", "gemma3-1b")  # one profiled engine decode step each


def family_engine_specs(vocab, index):
    """One family's requests: (prompt, max_new) pairs from numpy, the first
    two prompts longer than 512 tokens (a bucket of 1,024 would wrap a
    512-slot ring with its pads)."""
    rng = np.random.default_rng(FE_SEED + index)
    lens = rng.integers(FE_PROMPTS[0], FE_PROMPTS[1] + 1, size=FE_REQUESTS)
    lens[:2] = rng.integers(FE_LONG[0], FE_LONG[1] + 1, size=2)
    news = rng.integers(FE_NEW[0], FE_NEW[1] + 1, size=FE_REQUESTS)
    return [(rng.integers(1, vocab, size=n).astype(np.int32), int(m)) for n, m in zip(lens, news)]


def family_decode_trace(dev, params, cfg, specs):
    """A profiler trace of one contiguous engine decode step with every slot
    live: device ops, busy ms, device-to-host copies (must be 1)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Runtime, ServeConfig
    from repro_torch.obs import clock

    sv = ServeConfig(n_slots=FE_SLOTS, max_len=FE_MAX_LEN, page_size=None)
    eng = Runtime(device=dev).serve(params, cfg, serve=sv)
    eng.scheduler.submit(engine_requests([(p[:200], 64) for p, _ in specs[:FE_SLOTS]]),
                         clock.now())
    eng._refill()
    eng._decode_one_step()  # warm
    sync(dev)
    t0 = time.perf_counter()
    eng._decode_one_step()
    sync(dev)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng._decode_one_step()
        sync(dev)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    d2h = sum(e.count for e in kern if e.key.startswith("Memcpy DtoH"))
    n_ops = sum(e.count for e in kern)
    busy = sum(_device_us(e) for e in kern) / 1e3
    print(f"[family-engine-trace] {cfg.name}: one contiguous engine decode step, {FE_SLOTS} live "
          f"slots: {wall_ms:.2f} ms wall (unprofiled), {n_ops} device ops, busy {busy:.2f} ms "
          f"(idle {100 * (1 - busy / wall_ms):.0f}% of the unprofiled wall), device-to-host "
          f"copies {d2h}")
    for e in sorted(kern, key=_device_us, reverse=True)[:5]:
        print(f"[family-engine-trace]   device {_device_us(e) / 1e3:8.3f} ms x{e.count:<5d} "
              f"{e.key[:80]}")
    if d2h != 1:
        raise AssertionError(f"{cfg.name}: an engine decode step made {d2h} device-to-host "
                             "copies, want 1")
    del eng


def family_engines_one(dev, name, want_layout, index):
    """Phase 16 for one family: three engines, counters, telemetry, the
    reference comparison. An MoE family is served at a capacity factor of
    E / top_k, where no replica can drop (capacity = the call's tokens): the
    published factor couples the requests of a wave through their drops
    (ROADMAP Queue 3 item 14), so one paged run at it only prints its drops.
    Returns the launch counts of its runs."""
    from repro_torch.api import Runtime, ServeConfig
    from repro_torch.models import lm
    from repro_torch.serve.legacy import RunToCompletionEngine

    t_fam = time.perf_counter()
    published = f32_cfg(name, FE_LAYERS[name]).replace(attn_impl="pallas")
    cfg = (published.replace(capacity_factor=published.n_experts / published.top_k)
           if published.n_experts else published)
    plain_cfg = cfg.replace(attn_impl="chunked")
    params = lm.init_params(FE_PARAM_SEED, cfg, device=dev)
    specs = family_engine_specs(cfg.vocab, index)
    sv = ServeConfig(n_slots=FE_SLOTS, max_len=FE_MAX_LEN, page_size=FE_PAGE)
    runtime = Runtime(device=dev)
    rtol = SSM_LOGIT_RTOL if name == "zamba2-7b" else LOGIT_RTOL
    total = {}
    print(f"[family-engine] {name}: {cfg.n_layers} layers, {lm.num_params(params)} params "
          f"(float32), {len(specs)} requests (prompts {[len(p) for p, _ in specs]}, max_new "
          f"{[m for _, m in specs]}), eos None"
          + (f", capacity factor {cfg.capacity_factor}" if cfg.n_experts else ""))
    runs = []
    for label, make in (
            ("paged", lambda: runtime.serve(params, cfg, serve=sv)),
            ("contiguous", lambda: runtime.serve(params, cfg, serve=sv.replace(page_size=None))),
            ("run-to-completion", lambda: RunToCompletionEngine(
                params, cfg, batch=FE_SLOTS, max_len=FE_MAX_LEN, runtime=runtime))):
        eng, reqs, wall, counts = run_engine(dev, params, cfg, make, specs, f"{name} {label}")
        add_counts(total, counts)
        tele = eng.telemetry()
        legacy = label == "run-to-completion"
        if legacy:
            want = legacy_expected(specs, FE_SLOTS, FE_MAX_LEN, pad_ok=want_layout != "exact")
        else:
            lay = eng.layout
            got_layout = "paged" if lay.paged else ("contiguous" if lay.pad_ok else "exact")
            want_here = want_layout if label == "paged" or want_layout == "exact" else "contiguous"
            if got_layout != want_here:
                raise AssertionError(f"{name} {label}: layout {got_layout}, want {want_here}")
            want = engine_expected(specs, eng.serve, paged=lay.paged,
                                   pack=lay.paged and sv.pack_prefill, exact=not lay.pad_ok)
        check_counters(f"{name} {label}", tele, want)
        builds = tele["trace_counts"]
        shapes = {k for k in builds if k.startswith("prefill[")}
        if any(v != 1 for v in builds.values()) or builds.get("decode") != 1 or (
                want_layout == "exact" and shapes != {f"prefill[{len(p)}]" for p, _ in specs}):
            raise AssertionError(f"{name} {label}: builds {builds}")
        extra = None
        if legacy:
            lat = legacy_latencies(eng, FE_SLOTS)
            extra = dict(ttft_p50_s=lat[50][0], ttft_p99_s=lat[99][0], latency_p50_s=lat[50][1],
                         latency_p99_s=lat[99][1])
        print_telemetry(f"{name} {label}", tele, extra)
        steps = tele["decode_steps"]
        print(f"[family-engine] {name} {label}: wall {wall:.3f} s, decode "
              f"{1e3 * tele['decode_s'] / steps:.2f} ms per step ({steps} steps), prefill "
              f"{1e3 * tele['prefill_s'] / tele['prefill_calls']:.2f} ms per call "
              f"({tele['prefill_calls']} calls), {len(shapes)} prefill builds, launches {counts}")
        runs.append((label, {i: r.out.tolist() for i, r in enumerate(reqs)}))
        del eng
    ENGINE_TOKENS[name] = {"contiguous": dict(runs)["contiguous"]}
    if cfg.n_experts:
        # the published capacity factor: printed, not compared
        with RouteSpy() as spy:
            _, preqs, wall, counts = run_engine(dev, params, published,
                                                lambda: runtime.serve(params, published, serve=sv),
                                                specs, f"{name} paged at the published factor")
        add_counts(total, counts)
        same = sum(r.out.tolist() == runs[0][1][i] for i, r in enumerate(preqs))
        print(f"[family-engine] {name} paged at the published capacity factor "
              f"{published.capacity_factor}: wall {wall:.3f} s, "
              f"{sum(int(c['dropped']) for c in spy.calls)} of "
              f"{sum(c['sets'].numel() for c in spy.calls)} replicas dropped, {same} of "
              f"{len(preqs)} requests' tokens equal to the run at factor {cfg.capacity_factor}")
        del spy, preqs
    t0 = time.perf_counter()
    ref = reference_tokens(dev, params, plain_cfg, specs, FE_REF)
    print(f"[family-engine] {name}: sequential reference of requests {list(FE_REF)}: "
          f"{time.perf_counter() - t0:.1f} s")
    diffs = compare_tokens(dev, params, plain_cfg, specs, [("sequential reference", ref)] + runs,
                           rtol)
    print(f"[family-engine] {name} greedy tokens against the sequential reference of "
          f"{len(ref)} requests in 3 engines: {3 * len(ref) - len(diffs)} equal, "
          f"{len(diffs)} differing at a near tie")
    if name in FE_TRACE:
        family_decode_trace(dev, params, cfg, specs)
    del params
    torch.cuda.empty_cache()
    print(f"[time]   {name} engines {time.perf_counter() - t_fam:.1f} s")
    return total


def family_engines(dev):
    """Phase 16. Returns the launches of its runs (every one 0)."""
    t_phase = time.perf_counter()
    total = {}
    for index, (name, layout) in enumerate(FE_FAMILIES):
        add_counts(total, family_engines_one(dev, name, layout, index))
    print(f"[time]   family engines {time.perf_counter() - t_phase:.1f} s")
    return total


# -- phase 17: the distributed runtime on a one-rank NCCL mesh ----------------

DIST_TIMED = 3  # synced steps timed per configuration, after one warm-up


def dist_group(tmp):
    """A one-rank NCCL process group (a file:// store in ``tmp``) and the
    (1, 1) ("data", "model") mesh over it on the card. An init failure fails
    the phase: there is no fallback to gloo or to no mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store", rank=0,
                            world_size=1)
    return make_mesh((1, 1), ("data", "model"), device="cuda")


def dist_site_split(cfg, ex, policy):
    """The plan kind of each of lm-100m's 84 sketched sites and of its head
    under ``ex`` (global shapes)."""
    from collections import Counter

    dims = {"attn_q": (cfg.n_heads * cfg.head_dim, cfg.d_model),
            "attn_k": (cfg.n_kv * cfg.head_dim, cfg.d_model),
            "attn_v": (cfg.n_kv * cfg.head_dim, cfg.d_model),
            "attn_o": (cfg.d_model, cfg.n_heads * cfg.head_dim),
            "mlp_in": (cfg.d_ff, cfg.d_model), "mlp_gate": (cfg.d_ff, cfg.d_model),
            "mlp_out": (cfg.d_model, cfg.d_ff)}
    kinds = Counter()
    for i in range(cfg.n_layers):
        for role, (n, d) in dims.items():
            kinds[ex.site_spec(role, policy.config_for(role, i, cfg.n_layers), d_out=n,
                               d_in=d).plan.kind] += 1
    head_tp = ex.tp_sketch and policy.config_for("lm_head", 0, 1) is None
    kinds["tp_exact" if head_tp else "local"] += 1
    return dict(kinds)


def dist_payload_a(cfg) -> int:
    """Phase 17 (a)'s collective payload per step on the one-rank mesh, from
    the shapes (the counters count a payload on a one-rank axis too): each
    sketched site's weight and the head's, all-gathered over model and over
    data in the forward and its gradient reduce-scattered over data (3 x its
    float32 bytes), and the embedded rows all-gathered over model (BATCH x
    SEQ x d); the step's sum over data is skipped on one data rank. Under
    layer remat (``cfg.remat``, "full" by default) the backward runs each
    layer's forward again, so a layer's site weights are gathered twice
    more (5 x; the head, outside the layers, stays 3 x)."""
    d, dh = cfg.d_model, cfg.head_dim
    layers = cfg.n_layers * (d * (cfg.n_heads + 2 * cfg.n_kv) * dh + cfg.n_heads * dh * d
                             + 3 * d * cfg.d_ff)
    per_layer_site = 5 if cfg.remat != "none" else 3
    return 4 * (per_layer_site * layers + 3 * cfg.vocab * d + BATCH * SEQ * d)


def dist_leaves(state):
    from repro_torch.tree import tree_leaves

    return tree_leaves(state.params) + tree_leaves(state.opt_state)


def distributed(dev):
    """Phase 17: lm-100m at full width and depth (12 layers, d 768, vocab
    32,000, float32, batch 8x256, l1@0.2 block 128 on all 84 sites, head
    exact) through the distributed runtime on a one-rank NCCL mesh (1, 1):
    (a) tp_sketch off, pallas: one step equals the single-device step bit
    for bit (loss, grad norm, every parameter and moment), 84 score + 84
    fused launches; (b) tp_sketch on, pallas: sites 60 tp_column / 24 tp_row
    / 1 tp_exact, loss equal to the exact step's (rel 1e-5), finite
    gradients, 84 score + 0 fused launches per step, compact gradients equal
    to the scatter path (rtol 2e-5, atol 2e-6), collective bytes against
    the exact step's; (c) a checkpoint of (b) restores through
    resume_on_mesh bit for bit; (d) ms per step of (a), (b) and the
    single-device step, device ops and busy ms of one profiled step each.
    Returns the launches of the runs that count (every step's)."""
    import tempfile

    import torch.distributed as dist

    t_phase = time.perf_counter()
    cfg = lm100m()
    policy = slice_policy(0.2)
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        mesh = dist_group(tmp)
        try:
            distributed_checks(dev, cfg, policy, mesh, tmp, total)
        finally:
            dist.destroy_process_group()
            torch.cuda.empty_cache()
    print(f"[time]   distributed {time.perf_counter() - t_phase:.1f} s")
    return total


def distributed_checks(dev, cfg, policy, mesh, tmp, total):
    """Phase 17's checks (a)-(d) on the one-rank mesh; adds every counted
    step's launches to ``total``."""
    import numpy as np

    from repro_torch.api import ExecutionConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import collective_bytes, reset_collective_bytes
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.elastic import resume_on_mesh
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.tree import tree_map

    full = lm.init_params(17, cfg, device=dev)
    batch = next(iter(LMStream(vocab=cfg.vocab, seed=17).batches(BATCH, SEQ)))
    key = 17

    def fresh(ex=None, opt=None):
        params = tree_map(lambda t: t.detach().clone(), full)
        return init_state(0, cfg, opt, params=params, device=dev, execution=ex)

    def one(ex, pol, opt, label):
        """One step from the initial parameters: (state, metrics, launches)."""
        st = fresh(ex, opt)
        fn = make_train_step(cfg, opt, pol, execution=ex, device=dev)
        b = batch if ex is None or ex.mesh is None else shard_batch(batch, mesh=mesh)
        ops.reset_launch_counts()
        reset_collective_bytes()
        st, m = fn(st, b, key)
        sync(dev)
        counts = ops.launch_counts()
        if pol is not None:
            add_counts(total, counts)
        return st, m, counts, collective_bytes()["total"], fn, b

    # (a) the local plan on the mesh, bit for bit the single-device step
    opt = adamw(1e-3)
    single, m1, c1, _, fn1, b1 = one(None, policy, opt, "single")
    ex_a = ExecutionConfig(mesh=mesh)
    mesh_a, m2, c2, bytes_a, fn_a, b_a = one(ex_a, policy, opt, "mesh")
    want = expected_counts("pallas", 1)
    if c2 != want or c1 != want:
        raise AssertionError(f"[dist] (a) launches {c2} (single {c1}), want {want}")
    if bytes_a != dist_payload_a(cfg):
        raise AssertionError(f"[dist] (a) collective payload {bytes_a} B, want "
                             f"{dist_payload_a(cfg)} B from the shapes")
    same = (torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["grad_norm"],
                                                                 m2["grad_norm"])
            and all(torch.equal(a, b) for a, b in zip(dist_leaves(single),
                                                      dist_leaves(mesh_a))))
    if not same:
        raise AssertionError("[dist] (a) the one-rank mesh step differs from the "
                             "single-device step")
    print(f"[dist] (a) mesh (1, 1) NCCL, tp_sketch off, pallas l1@0.2 block {BLOCK}: "
          f"loss {float(m2['loss']):.6f}, grad_norm {float(m2['grad_norm']):.6g}, "
          f"{len(dist_leaves(mesh_a))} leaves (params, AdamW moments) bit for bit the "
          f"single-device step; launches {c2}; collective payload {bytes_a} B (the shapes' "
          f"{dist_payload_a(cfg)} B)")
    del single

    # (b) the TP plans
    ex_b = ExecutionConfig(mesh=mesh, tp_sketch=True)
    split = dist_site_split(cfg, ex_b, policy)
    if split != {"tp_column": 60, "tp_row": 24, "tp_exact": 1}:
        raise AssertionError(f"[dist] (b) site plans {split}")
    _, m_ex, _, bytes_ex, fn_ex, _ = one(ex_b, None, opt, "exact")
    _, m_exact1, _, _, _, _ = one(None, None, opt, "exact single")
    dense_b, m_b, c_b, bytes_b, fn_b, b_b = one(ex_b, policy, opt, "tp dense")
    want_b = {name: 84 if name == "col_l1_scores" else 0 for name in ops.KERNELS}
    rel = abs(float(m_b["loss"]) - float(m_exact1["loss"])) / abs(float(m_exact1["loss"]))
    if c_b != want_b or rel > 1e-5 or not math.isfinite(float(m_b["grad_norm"])):
        raise AssertionError(f"[dist] (b) launches {c_b}, loss rel {rel}, grad_norm "
                             f"{float(m_b['grad_norm'])}")
    if not all(torch.isfinite(t).all() for t in dist_leaves(dense_b)):
        raise AssertionError("[dist] (b) a non-finite leaf after the TP step")
    ex_c = ExecutionConfig(mesh=mesh, tp_sketch=True, compact_grads=True)
    comp_b, m_c, c_c, bytes_c, _, _ = one(ex_c, policy, opt, "tp compact")
    errs = [float(((a - b).abs() / (2e-6 + 2e-5 * b.abs())).max().detach())
            for a, b in zip(dist_leaves(comp_b), dist_leaves(dense_b))]
    if c_c != want_b or max(errs) > 1.0:
        raise AssertionError(f"[dist] (b) compact launches {c_c}, worst err/tol "
                             f"{max(errs)}")
    print(f"[dist] (b) tp_sketch on: sites {split}; loss {float(m_b['loss']):.6f} vs exact "
          f"{float(m_exact1['loss']):.6f} (rel {rel:.2e}); grad_norm "
          f"{float(m_b['grad_norm']):.6g}; launches per step {c_b} (compact {c_c}); "
          f"compact gradients against the scatter path: worst |diff| / (2e-6 + 2e-5 |b|) "
          f"{max(errs):.3g}; collective payload per step: exact {bytes_ex} B, dense "
          f"sketched {bytes_b} B ({bytes_b / bytes_ex:.3f}), compact {bytes_c} B "
          f"({bytes_c / bytes_ex:.3f})")
    del comp_b

    # (c) a checkpoint of (b), written as the trainer writes under a mesh
    # (gathered leaf by leaf to rank 0's host), restored on the mesh
    ckdir = os.path.join(tmp, "ckpt")
    mgr = ck.CheckpointManager(ckdir, every=1, mesh=mesh)
    mgr.maybe_save(1, dense_b)
    mgr.wait()
    restored, step = resume_on_mesh(ckdir, dense_b, mesh, device=dev)
    if step != 1 or not all(torch.equal(a, b) for a, b in zip(dist_leaves(dense_b),
                                                              dist_leaves(restored))):
        raise AssertionError("[dist] (c) the restored state differs")
    print(f"[dist] (c) checkpoint of (b) ({len(dist_leaves(restored))} leaves) restored "
          "through resume_on_mesh bit for bit")
    del restored, dense_b

    # (d) ms per step, interleaved: single, mesh (a), TP (b)
    runs = {"single": (fn1, b1, None), "mesh (a)": (fn_a, b_a, ex_a),
            "tp (b)": (fn_b, b_b, ex_b)}
    states = {k: fresh(ex, opt) for k, (_, _, ex) in runs.items()}
    ms = {k: [] for k in runs}
    ops.reset_launch_counts()
    for k, (fn, b, _) in runs.items():
        states[k], _ = fn(states[k], b, key)  # warm-up
    sync(dev)
    for rep in range(DIST_TIMED):
        for k, (fn, b, _) in runs.items():
            t0 = time.perf_counter()
            states[k], m = fn(states[k], b, key + rep)
            float(m["loss"])
            sync(dev)
            ms[k].append(1e3 * (time.perf_counter() - t0))
    prof = {}
    for k, (fn, b, _) in runs.items():
        states[k], _, n_ops, busy = profiled_step(dev, fn, states[k], b, key)
        prof[k] = (n_ops, busy)
    sync(dev)
    per_run = 1 + DIST_TIMED + 1  # warm-up, timed, profiled
    want_d = expected_counts("pallas", 2 * per_run)  # single and mesh (a)
    want_d["col_l1_scores"] += 7 * cfg.n_layers * per_run  # tp (b)
    got_d = ops.launch_counts()
    if got_d != want_d:
        raise AssertionError(f"[dist] (d) launches {got_d}, want {want_d}")
    add_counts(total, got_d)
    print(f"[dist] (d) ms per step ({DIST_TIMED} synced steps after a warm-up, order "
          f"single, mesh, tp): " + ", ".join(
              f"{k} {[round(v, 2) for v in ms[k]]} (median {np.median(ms[k]):.2f}; "
              f"device ops {prof[k][0]}, busy {prof[k][1]:.2f} ms)" for k in runs)
          + f"; card {smi_line()}")
    del states


# ---------------------------------------------------------------------------
# The analysis tooling (phase 18): the lint gate over the port, and the
# coverage gate at full width, cross-checked against the kernels' launches
# ---------------------------------------------------------------------------

# (config, layers: None for the registry's depth, sketched site applications
# per step). The depths are the training phases' (float32 weights and
# gradients must fit 80 GB: mixtral's one layer takes ~23 GB); yi-6b and
# mixtral-8x22b run here for the first time at full width
ANALYSIS_CFGS = (("lm-100m", None, 84), ("olmoe-1b-7b", 4, 784),
                 ("gemma3-1b", None, 182), ("rwkv6-3b", 8, 64), ("zamba2-7b", 13, 53),
                 ("qwen2-vl-2b", None, 196), ("seamless-m4t-large-v2", None, 384),
                 ("yi-6b", 4, 28), ("mixtral-8x22b", 1, 28))
# the cross-check's forward and backward: one row of 256 tokens
ANALYSIS_BATCH, ANALYSIS_SEQ = 1, 256


def analysis_cross_check(dev, runtime, cfg, params, n_sites):
    """Phase 18 (c) for one config: one forward and backward of
    ``lm.lm_loss`` under ``runtime`` on ANALYSIS_BATCH x ANALYSIS_SEQ tokens
    from LMStream (FAM_SEED, a stub frontend's inputs by ``stub_inputs``),
    the launch counts set to 0 just before and read just after: the score
    and fused kernels each ``n_sites`` times, every other kernel 0; the loss
    and every gradient finite. Returns the counts."""
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.train.train_step import batch_to_device
    from repro_torch.tree import tree_leaves

    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    batch = next(LMStream(vocab=cfg.vocab, seed=FAM_SEED).batches(ANALYSIS_BATCH, ANALYSIS_SEQ))
    batch = batch_to_device(stub_inputs(cfg, np.random.default_rng(FAM_SEED), batch), dev)
    ops.reset_launch_counts()
    loss = lm.lm_loss(params, batch, runtime.ctx(key=FAM_SEED, n_layers=cfg.n_layers), cfg,
                      FAM_SEED)[0]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {name: n_sites if name in SITE_KERNELS["pallas"] else 0 for name in ops.KERNELS}
    if counts != want:
        raise AssertionError(f"{cfg.name}: the analyzer counts {n_sites} sketched site "
                             f"applications, one forward and backward launched {counts}")
    # a VLM's embedding table reads no token: the one leaf without a gradient
    missing = sum(g is None for g in grads)
    loss = float(loss.detach())
    if not math.isfinite(loss) or missing > (cfg.frontend == "vision") or not all(
            torch.isfinite(g).all() for g in grads if g is not None):
        raise AssertionError(f"{cfg.name}: loss {loss}, {missing} leaves without a "
                             "gradient, or a non-finite gradient")
    return counts


def analysis(dev):
    """Phase 18: (a) ``run_lint`` over ``src/repro_torch``: no finding, the
    waived findings exactly ``lint.REVIEWED_WAIVERS``; (b) per config of
    ANALYSIS_CFGS at full width (float32, random weights from FAM_SEED),
    ``analyze_runtime`` on the card under the block-128 l1@0.2 ``pallas``
    policy: the baseline gate green, every sketched site application on a
    resolved or unresolved leaf (or the shared block's exact one), and as
    many applications as the table says; (c) the cross-check
    (``analysis_cross_check``). Returns (c)'s launches."""
    from repro_torch.analysis import analyze_runtime, check_baseline, run_lint
    from repro_torch.analysis.lint import REVIEWED_WAIVERS, waiver_key
    from repro_torch.api import Runtime
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    res = run_lint([os.path.join(ROOT, "src", "repro_torch")])
    waived = sorted(waiver_key(f) for f in res.waived)
    if res.findings or set(waived) != REVIEWED_WAIVERS or len(waived) != len(REVIEWED_WAIVERS):
        raise AssertionError("lint: " + "; ".join(map(str, res.findings + res.waived)))
    print(f"[analysis] (a) lint src/repro_torch: 0 findings, {len(waived)} waived, the "
          f"reviewed list {[(f, code) for _, f, code in waived]}; "
          f"{time.perf_counter() - t0:.2f} s")
    runtime = Runtime(policy=slice_policy(0.2), device=dev)
    total = {}
    for name, layers, n_want in ANALYSIS_CFGS:
        t0 = time.perf_counter()
        cfg = lm100m() if name == "lm-100m" else f32_cfg(name, layers)
        params = lm.init_params(FAM_SEED, cfg, device=dev)
        t1 = time.perf_counter()
        rep = analyze_runtime(runtime, cfg, device=dev, params=params)
        t_an = time.perf_counter() - t1
        br = check_baseline(rep)
        if not br.ok:
            raise AssertionError(f"{name}: {br.message()}")
        for s in rep.sites:
            if s.applications and not (s.category in ("resolved", "unresolved") or (
                    s.category == "exact" and s.param.startswith("shared/"))):
                raise AssertionError(f"{name}: {s.applications} sketched applications on "
                                     f"{s.param}, a {s.category} leaf")
        n = rep.applications
        if n != n_want:
            raise AssertionError(f"{name}: the analyzer counts {n} sketched site "
                                 f"applications, want {n_want}")
        cats = {k: len(v) for k, v in sorted(rep.by_category().items())}
        print(f"[analysis] (b) {name}, {cfg.n_layers} layers" + (
            f" + {cfg.enc_layers} encoder" if cfg.is_encdec else "") + f", d {cfg.d_model}: "
            f"gate ok, categories {cats}, baseline waivers used {br.used}, modelled escaped "
            f"fraction {rep.escaped_flop_frac:.6g}, unresolved fraction "
            f"{rep.unresolved_flop_frac:.6g}, {n} sketched site applications; analyzer "
            f"{t_an:.2f} s")
        t1 = time.perf_counter()
        counts = analysis_cross_check(dev, runtime, cfg, params, n)
        add_counts(total, counts)
        print(f"[analysis] (c) {name}: one forward and backward at {ANALYSIS_BATCH}x"
              f"{ANALYSIS_SEQ} launched {counts}, the analyzer's {n} each; "
              f"{time.perf_counter() - t1:.2f} s; config {time.perf_counter() - t0:.1f} s")
        del params, rep
        torch.cuda.empty_cache()
    print(f"[time]   analysis {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Every family under a mesh (phase 19): the seven family configs at full
# width and a cut depth through the distributed runtime on a one-rank NCCL
# mesh, each held bit for bit to its single-device step
# ---------------------------------------------------------------------------

# (config, depth cut, optimizer): olmoe and mixtral train with SGD, whose
# state is the parameters alone (mixtral's float32 AdamW state at 1 layer is
# 43.3 GiB, and the single-device step's results wait on the host while the
# mesh step runs); the others with AdamW (parameters and both moments held
# bit for bit); olmoe at one layer: its steps are host-bound (~35 s a layer
# on the H100), and the script keeps inside its time limit
MESH_FAMILIES = (
    ("olmoe-1b-7b", dict(n_layers=1), "sgd"),
    ("mixtral-8x22b", dict(n_layers=1), "sgd"),
    ("gemma3-1b", dict(n_layers=6), "adamw"),  # one 5 local : 1 global period
    ("rwkv6-3b", dict(n_layers=2), "adamw"),
    ("zamba2-7b", dict(n_layers=6), "adamw"),  # six Mamba2 layers and the shared block
    ("qwen2-vl-2b", dict(n_layers=2), "adamw"),
    ("seamless-m4t-large-v2", dict(n_layers=2, enc_layers=2), "adamw"),
)
MESH_BATCH, MESH_SEQ = 4, 256
MESH_TIMED = 2  # synced steps timed per run, after one warm-up
MESH_SEED = 19


def mesh_batch(cfg):
    """MESH_BATCH x MESH_SEQ tokens and labels from LMStream, a stub
    frontend's inputs from numpy (``stub_inputs``), all from MESH_SEED."""
    from repro_torch.data.synthetic import LMStream

    batch = next(iter(LMStream(vocab=cfg.vocab, seed=MESH_SEED).batches(MESH_BATCH, MESH_SEQ)))
    return stub_inputs(cfg, np.random.default_rng(MESH_SEED), batch)


def mesh_sites(cfg):
    """(layer index, role, d_out, d_in) of every linear site of one step
    that ``dense`` runs (experts apart), in uid order, and the expert sites
    per MoE layer."""
    from repro_torch.models import lm

    d, dh, H, Kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv
    glu = cfg.mlp_type in ("swiglu", "geglu")
    attn = [("attn_q", H * dh, d), ("attn_k", Kv * dh, d), ("attn_v", Kv * dh, d),
            ("attn_o", d, H * dh)]
    ffn = [("mlp_in", cfg.d_ff, d)] + ([("mlp_gate", cfg.d_ff, d)] if glu else []) \
        + [("mlp_out", d, cfg.d_ff)]
    di = 2 * d
    mamba = [("ssm_in", di, d), ("ssm_in", di, d), ("ssm_small", cfg.ssm_state, d),
             ("ssm_small", cfg.ssm_state, d), ("ssm_small", di // cfg.ssm_head_dim, d),
             ("ssm_out", d, di)]
    f = cfg.d_ff or 7 * d // 2
    rwkv = [("attn_q", d, d), ("attn_k", d, d), ("attn_v", d, d), ("mlp_gate", d, d),
            ("attn_o", d, d), ("mlp_in", f, d), ("mlp_gate", d, d), ("mlp_out", d, f)]
    out, experts = [], 0
    kinds = [(i, k) for i, k in enumerate(lm.layer_kinds(cfg))] + [
        (lm.ENCODER_UID_BASE + i, k) for i, k in enumerate(lm.encoder_kinds(cfg))]
    for i, kind in kinds:
        if kind.kind == "mamba":
            sites = mamba
        elif kind.kind == "rwkv":
            sites = rwkv
        else:
            sites = attn + [(r.replace("attn", "cross"), n, k) for r, n, k in attn] * kind.cross
            if kind.moe:
                experts += (3 if glu else 2) * cfg.n_experts
            else:
                sites = sites + ffn
        out += [(i, r, n, k) for r, n, k in sites]
    return out, experts


def mesh_site_split(cfg, ex, policy):
    """The plan (and effective backend) of every site of one step of ``cfg``
    under ``ex`` (tp_sketch on, global shapes), and the launches of one
    ``pallas`` step there: a sketched TP site launches the score kernel
    alone, a local sketched site runs ``mask`` (no kernel), an expert site
    its local plan as on one device (JAX's body runs with no mesh): the
    score and the fused kernel."""
    from collections import Counter

    from repro_torch.core.site import TP_OUT_ROLES, TP_ROW_ROLES
    from repro_torch.kernels import ops

    n_mp = ex.mesh.axis_size(ex.axes_in_mesh()[1])
    sites, experts = mesh_sites(cfg)
    kinds, score, fused = Counter(), 0, 0
    for i, role, n, k in sites:
        c = policy.config_for(role, i, cfg.n_layers)
        if c is None or c.is_noop:
            kind = ("tp_exact" if role in TP_OUT_ROLES and n % n_mp == 0 else
                    "tp_row" if role in TP_ROW_ROLES and k % n_mp == 0 else "local")
            kinds[f"exact {kind}"] += 1
            continue
        spec = ex.site_spec(role, c, d_out=n, d_in=k)
        kinds[f"{spec.plan.kind}/{spec.cfg.backend}"] += 1
        if spec.cfg.backend == "pallas":
            score += 1
            fused += spec.plan.kind == "local"
    if experts:
        kinds["expert local/pallas"] += experts
        score, fused = score + experts, fused + experts
    head_tp = not cfg.tie_embeddings and cfg.vocab % n_mp == 0
    kinds["head exact " + ("tp_exact" if head_tp else "local")] += 1
    want = {name: 0 for name in ops.KERNELS}
    want.update(col_l1_scores=score, block_gather_matmul_fused=fused)
    return dict(kinds), want


def device_step(dev, fn, state, batch, key):
    """One step with the card's activity traced (device events alone):
    (state, metrics, device ops, device busy ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, m = fn(state, batch, key)
        float(m["loss"])
        sync(dev)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return state, m, sum(e.count for e in kern), sum(_device_us(e) for e in kern) / 1e3


def mesh_family(dev, mesh, name, cut, opt_name, tmp, total):
    """Phase 19's checks of one config on the one-rank mesh (``families_mesh``)."""
    from repro_torch.api import ExecutionConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import collective_bytes, reset_collective_bytes
    from repro_torch.models import lm
    from repro_torch.optim import adamw, sgd
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.elastic import resume_on_mesh
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg = f32_cfg(name).replace(**cut)
    policy = slice_policy(0.2)
    opt = sgd(1e-3) if opt_name == "sgd" else adamw(1e-3)
    batch = mesh_batch(cfg)
    full = lm.init_params(MESH_SEED, cfg, device=dev)
    n_params = lm.num_params(full)

    def fresh(ex):
        params = tree_map(lambda t: t.detach().clone(), full)
        return init_state(0, cfg, opt, params=params, device=dev, execution=ex)

    def run(ex, pol):
        """One step from the initial parameters: (state, metrics, launches,
        payload bytes, step function, its batch)."""
        st = fresh(ex)
        fn = make_train_step(cfg, opt, pol, execution=ex, device=dev)
        b = batch if ex is None else shard_batch(batch, mesh=mesh)
        ops.reset_launch_counts()
        reset_collective_bytes()
        st, m = fn(st, b, MESH_SEED)
        sync(dev)
        counts = ops.launch_counts()
        if pol is not None:
            add_counts(total, counts)
        return st, m, counts, collective_bytes()["total"], fn, b

    # (a) tp_sketch off, pallas: the mesh step is the single-device step
    want_a = family_counts(cfg, "pallas", 1)
    single, m1, c1, _, fn1, b1 = run(None, policy)
    host = [t.detach().cpu() for t in dist_leaves(single)]
    loss1, gn1 = m1["loss"].detach().cpu(), m1["grad_norm"].detach().cpu()
    del single, m1
    ex_a = ExecutionConfig(mesh=mesh)
    mesh_a, m2, c2, bytes_a, fn_a, b_a = run(ex_a, policy)
    got = dist_leaves(mesh_a)
    same = (len(got) == len(host) and torch.equal(loss1, m2["loss"].detach().cpu())
            and torch.equal(gn1, m2["grad_norm"].detach().cpu())
            and all(torch.equal(h, t.detach().cpu()) for h, t in zip(host, got)))
    if c1 != want_a or c2 != want_a:
        raise AssertionError(f"[mesh-fam] {name} (a) launches {c2} (single {c1}), want {want_a}")
    if not same:
        raise AssertionError(f"[mesh-fam] {name} (a) the one-rank mesh step differs from the "
                             "single-device step")
    del host, got
    print(f"[mesh-fam] {name} ({n_params} params, {cut}, {opt_name}): (a) tp_sketch off, "
          f"pallas l1@0.2 block {BLOCK}: loss {float(m2['loss']):.6f}, aux "
          f"{float(m2['aux']):.6g}, grad_norm {float(m2['grad_norm']):.6g}; "
          f"{len(dist_leaves(mesh_a))} leaves bit for bit the single-device step; launches "
          f"{c2} (= single); collective payload {bytes_a} B")

    # (c) olmoe: the mesh state through CheckpointManager(mesh=)
    if name == "olmoe-1b-7b":
        ckdir = os.path.join(tmp, "olmoe_ckpt")
        mgr = ck.CheckpointManager(ckdir, every=1, mesh=mesh)
        mgr.maybe_save(1, mesh_a)
        mgr.wait()
        restored, step = resume_on_mesh(ckdir, mesh_a, mesh, device=dev)
        if step != 1 or not all(torch.equal(a, b) for a, b in zip(dist_leaves(mesh_a),
                                                                  dist_leaves(restored))):
            raise AssertionError("[mesh-fam] (c) the restored olmoe state differs")
        print(f"[mesh-fam] {name} (c) the mesh state ({len(dist_leaves(restored))} leaves) "
              "through CheckpointManager(mesh=) and resume_on_mesh bit for bit")
        del restored
    del mesh_a

    # (b) tp_sketch on
    ex_b = ExecutionConfig(mesh=mesh, tp_sketch=True)
    split, want_b = mesh_site_split(cfg, ex_b, policy)
    exact_b, m_ex, _, bytes_ex, _, _ = run(ex_b, None)
    del exact_b
    tp_b, m_b, c_b, bytes_b, _, _ = run(ex_b, policy)
    rel = abs(float(m_b["loss"]) - float(m_ex["loss"])) / abs(float(m_ex["loss"]))
    finite = math.isfinite(float(m_b["grad_norm"])) and all(
        torch.isfinite(t).all() for t in dist_leaves(tp_b))
    if c_b != want_b or rel > 1e-5 or not finite:
        raise AssertionError(f"[mesh-fam] {name} (b) launches {c_b} (want {want_b}), loss "
                             f"rel {rel}, finite {finite}")
    del tp_b
    print(f"[mesh-fam] {name} (b) tp_sketch on: sites {split}; loss {float(m_b['loss']):.6f} "
          f"vs the exact TP step's {float(m_ex['loss']):.6f} (rel {rel:.2e}); grad_norm "
          f"{float(m_b['grad_norm']):.6g}, every leaf finite; launches {c_b}; collective "
          f"payload: exact TP {bytes_ex} B, sketched {bytes_b} B")

    # (d) ms per step, single against mesh (a), interleaved
    runs = {"single": (fn1, b1, None), "mesh": (fn_a, b_a, ex_a)}
    states = {k: fresh(ex) for k, (_, _, ex) in runs.items()}
    del full
    ms = {k: [] for k in runs}
    ops.reset_launch_counts()
    for k, (fn, b, _) in runs.items():
        states[k], _ = fn(states[k], b, MESH_SEED)  # warm-up
    sync(dev)
    for rep in range(MESH_TIMED):
        for k, (fn, b, _) in runs.items():
            t1 = time.perf_counter()
            states[k], m = fn(states[k], b, MESH_SEED + 1 + rep)
            float(m["loss"])
            sync(dev)
            ms[k].append(1e3 * (time.perf_counter() - t1))
    prof = {}
    for k, (fn, b, _) in runs.items():
        states[k], _, n_ops, busy = device_step(dev, fn, states[k], b, MESH_SEED)
        prof[k] = (n_ops, busy)
    sync(dev)
    counts_d = ops.launch_counts()
    want_d = family_counts(cfg, "pallas", 2 * (2 + MESH_TIMED))
    if counts_d != want_d:
        raise AssertionError(f"[mesh-fam] {name} (d) launches {counts_d}, want {want_d}")
    add_counts(total, counts_d)
    del states
    torch.cuda.empty_cache()
    print(f"[mesh-fam] {name} (d) ms per step ({MESH_TIMED} synced steps after a warm-up, "
          f"order single, mesh): " + ", ".join(
              f"{k} {[round(v, 2) for v in ms[k]]} (device ops {prof[k][0]}, busy "
              f"{prof[k][1]:.2f} ms)" for k in runs)
          + f"; collective payload of the mesh step {bytes_a} B; card {smi_line()}; "
          f"{time.perf_counter() - t0:.1f} s")


def families_mesh(dev):
    """Phase 19: the seven family configs (olmoe-1b-7b, mixtral-8x22b,
    gemma3-1b, rwkv6-3b, zamba2-7b, qwen2-vl-2b, seamless-m4t-large-v2) at
    full width, float32, l1@0.2 block 128, cut in depth (MESH_FAMILIES),
    through the distributed runtime on a one-rank NCCL mesh (1, 1), batch
    4x256: (a) tp_sketch off, pallas: one mesh step equals the single-device
    step bit for bit (loss, grad norm, every parameter and moment), score
    and fused launches equal and one each per sketched site; (b) tp_sketch
    on: the plan of every site, the loss equal to the exact TP step's (rel
    1e-5), a finite update, the launches of the plans (expert sites run
    their local plan: score and fused); (c) olmoe's mesh state restored
    bit for bit through CheckpointManager(mesh=); (d) ms per step, single
    against mesh, device ops and busy ms of one traced step each. The TPX
    mode cannot occur on one rank (E % 1 == 0): the gloo tests cover it.
    Returns the launches of every sketched step."""
    import tempfile

    import torch.distributed as dist

    t_phase = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        mesh = dist_group(tmp)
        try:
            for name, cut, opt_name in MESH_FAMILIES:
                mesh_family(dev, mesh, name, cut, opt_name, tmp, total)
        finally:
            dist.destroy_process_group()
            torch.cuda.empty_cache()
    print(f"[time]   families under a mesh {time.perf_counter() - t_phase:.1f} s")
    return total


# -- phase 20: serving under a one-rank NCCL mesh ------------------------------


def serve_payload(cfg, B, S) -> int:
    """The collective payload of one prefill of B rows of S tokens (S = 1: one
    decode step) of a dense decoder on the one-rank mesh, from the shapes:
    every linear weight (q, k, v, o, the three MLP sites, the head)
    all-gathered over model and over data (2 x its float32 bytes) and the
    embedded rows over model (B x S x d floats). One model rank holds every
    cache position, so decode combines no softmax statistics; the batch's
    rows are cut with no collective."""
    d, dh = cfg.d_model, cfg.head_dim
    w = cfg.n_layers * (d * (cfg.n_heads + 2 * cfg.n_kv) * dh + cfg.n_heads * dh * d
                        + 3 * d * cfg.d_ff) + cfg.vocab * d
    return 4 * (2 * w + B * S * d)


def mesh_generate(dev, runtime, params, cfg, prompts):
    """``serve_path``'s generation through ``runtime``: the prefill, then
    DECODE_STEPS greedy steps. Returns (prefill logits, tokens fed, step
    logits, launches of the prefill and of the decode steps, payload of the
    prefill and of each step, prefill ms, decode ms)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import collective_bytes, reset_collective_bytes
    from repro_torch.serve import greedy_sample

    B, S = prompts.shape
    prefill = runtime.prefill_step(cfg, S + DECODE_STEPS)
    decode = runtime.decode_step(cfg)
    sync(dev)
    ops.reset_launch_counts()
    reset_collective_bytes()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompts})
    sync(dev)
    t1 = time.perf_counter()
    pre_counts, pre_bytes = ops.launch_counts(), collective_bytes()["total"]
    ops.reset_launch_counts()
    cur = greedy_sample(logits[:, -1:])
    fed, step_logits, step_bytes = [], [], []
    for i in range(DECODE_STEPS):
        fed.append(cur)
        reset_collective_bytes()
        lg, caches = decode(params, caches, cur, S + i)
        step_bytes.append(collective_bytes()["total"])
        step_logits.append(lg)
        cur = greedy_sample(lg)
    fed.append(cur)
    sync(dev)
    t2 = time.perf_counter()
    return (logits, fed, step_logits, pre_counts, ops.launch_counts(), pre_bytes, step_bytes,
            1e3 * (t1 - t0), 1e3 * (t2 - t1) / DECODE_STEPS)


def mesh_serve_steps(dev, mesh, total):
    """Phase 20 (a): lm-100m, ``attn_impl="pallas"``, the serving main path's
    waves on one device and on the one-rank mesh; adds the mesh runs'
    launches to ``total``."""
    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import shard_params
    from repro_torch.models import lm

    cfg = lm100m().replace(attn_impl="pallas")
    params = lm.init_params(SERVE_SEED, cfg, device=dev)
    single = Runtime(device=dev)
    meshed = Runtime(device=dev, execution=ExecutionConfig(mesh=mesh))
    shards = shard_params(params, mesh, copy=False)
    gen = np.random.default_rng(SERVE_SEED)
    L = cfg.n_layers
    for w, (B, S) in enumerate(SERVE_WAVES):
        prompts = gen.integers(1, cfg.vocab, size=(B, S))
        ref = mesh_generate(dev, single, params, cfg, prompts)
        got = mesh_generate(dev, meshed, shards, cfg, prompts)
        add_counts(total, got[3])
        add_counts(total, got[4])
        want_pre = {name: 0 for name in ops.KERNELS}
        want_pre["flash_attention"] = L
        if got[3] != want_pre or any(got[4].values()):
            raise AssertionError(f"wave {w + 1}: mesh launches {got[3]} in the prefill, {got[4]} "
                                 f"in decode; want {L} flash_attention per prefill, none else")
        same = (torch.equal(got[0], ref[0]) and all(torch.equal(a, b) for a, b in
                                                    zip(got[2], ref[2]))
                and all(torch.equal(a, b) for a, b in zip(got[1], ref[1])))
        if not same:
            err = max(float((a - b).abs().max()) for a, b in zip([got[0]] + got[2],
                                                                 [ref[0]] + ref[2]))
            raise AssertionError(f"wave {w + 1}: the mesh's logits or tokens differ from the "
                                 f"single device's (max|diff| {err:.3e})")
        want_pre_b, want_dec_b = serve_payload(cfg, B, S), serve_payload(cfg, B, 1)
        if got[5] != want_pre_b or got[6] != [want_dec_b] * DECODE_STEPS:
            raise AssertionError(f"wave {w + 1}: payload {got[5]} B per prefill, "
                                 f"{sorted(set(got[6]))} per decode step; the shapes give "
                                 f"{want_pre_b} and {want_dec_b}")
        print(f"[serve-mesh] wave {w + 1} ({B} x {S}, {DECODE_STEPS} greedy steps): one-rank "
              f"mesh bit for bit the single device (prefill logits, {DECODE_STEPS} steps' "
              f"logits, {B * (DECODE_STEPS + 1)} tokens); {got[3]['flash_attention']} "
              f"flash_attention per prefill, 0 in decode; payload {got[5]:,} B per prefill, "
              f"{got[6][0]:,} B per decode step (= the shapes'); prefill ms single / mesh "
              f"{ref[7]:.1f} / {got[7]:.1f}, decode ms per step {ref[8]:.2f} / {got[8]:.2f}")
        del ref, got
    del params, shards
    torch.cuda.empty_cache()


def mesh_engine_tokens(dev, label, make, specs, cfg, params):
    """One engine run (``run_engine``: 0 launches, every request to its
    length): (tokens by request, wall s)."""
    _, reqs, wall, _ = run_engine(dev, params, cfg, make, specs, label)
    return {i: r.out.tolist() for i, r in enumerate(reqs)}, wall


def mesh_engines(dev, mesh):
    """Phase 20 (b) and (c): phase 11's two engines on lm-100m and one
    contiguous engine per phase-16 family, under the one-rank mesh; their
    tokens against the single-device engines' (phases 11 and 16, or run
    here when the phase runs alone)."""
    from repro_torch.api import ExecutionConfig, Runtime, ServeConfig
    from repro_torch.models import lm
    from repro_torch.serve.legacy import RunToCompletionEngine

    meshed = Runtime(device=dev, execution=ExecutionConfig(mesh=mesh))
    single = Runtime(device=dev)
    cfg = lm100m().replace(attn_impl="pallas")
    params = lm.init_params(ENGINE_PARAM_SEED, cfg, device=dev)
    specs = engine_specs(cfg.vocab)
    sv = ServeConfig(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN, page_size=ENGINE_PAGE)
    engines = {
        "paged": lambda rt: rt.serve(params, cfg, serve=sv),
        "run-to-completion": lambda rt: RunToCompletionEngine(
            params, cfg, batch=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN, runtime=rt)}
    for label, make in engines.items():
        want = ENGINE_TOKENS.get("lm-100m", {}).get(label)
        if want is None:
            want, _ = mesh_engine_tokens(dev, f"single {label}", lambda: make(single), specs, cfg,
                                         params)
        got, wall = mesh_engine_tokens(dev, f"mesh {label}", lambda: make(meshed), specs, cfg,
                                       params)
        if got != want:
            bad = [i for i in want if got[i] != want[i]]
            raise AssertionError(f"lm-100m {label} under the mesh: requests {bad} differ from "
                                 "the single-device engine's tokens")
        print(f"[serve-mesh] lm-100m {label} engine on the mesh: {len(specs)} requests' tokens "
              f"equal to the single device's, 0 launches, wall {wall:.3f} s")
    del params
    torch.cuda.empty_cache()
    for index, (name, _) in enumerate(FE_FAMILIES):
        published = f32_cfg(name, FE_LAYERS[name]).replace(attn_impl="pallas")
        fcfg = (published.replace(capacity_factor=published.n_experts / published.top_k)
                if published.n_experts else published)
        fparams = lm.init_params(FE_PARAM_SEED, fcfg, device=dev)
        fspecs = family_engine_specs(fcfg.vocab, index)
        fsv = ServeConfig(n_slots=FE_SLOTS, max_len=FE_MAX_LEN, page_size=None)
        want = ENGINE_TOKENS.get(name, {}).get("contiguous")
        if want is None:
            want, _ = mesh_engine_tokens(dev, f"single {name}", lambda: single.serve(
                fparams, fcfg, serve=fsv), fspecs, fcfg, fparams)
        got, wall = mesh_engine_tokens(dev, f"mesh {name}", lambda: meshed.serve(
            fparams, fcfg, serve=fsv), fspecs, fcfg, fparams)
        if got != want:
            bad = [i for i in want if got[i] != want[i]]
            raise AssertionError(f"{name} contiguous under the mesh: requests {bad} differ from "
                                 "the single-device engine's tokens")
        print(f"[serve-mesh] {name} ({fcfg.n_layers} layers) contiguous engine on the mesh: "
              f"{len(fspecs)} requests' tokens equal to the single device's, 0 launches, wall "
              f"{wall:.3f} s")
        del fparams
        torch.cuda.empty_cache()


def serving_mesh(dev):
    """Phase 20: serving under a one-rank NCCL mesh (1, 1). (a) lm-100m's
    serving main path (``Runtime.prefill_step`` / ``decode_step``,
    ``attn_impl="pallas"``, waves 8 x 1024 and 4 x 1000, 32 greedy steps)
    under ``ExecutionConfig(mesh=)``: 12 flash_attention launches per
    prefill and none in decode, logits and tokens bit for bit the single
    device's, each prefill's and decode step's payload equal to
    ``serve_payload``'s; (b) phase 11's paged and run-to-completion engines
    on the mesh, tokens equal to the single device's; (c) one contiguous
    engine run per phase-16 family at its depth, tokens equal. Returns the
    mesh runs' launches."""
    import tempfile

    import torch.distributed as dist

    t_phase = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        mesh = dist_group(tmp)
        try:
            t0 = time.perf_counter()
            mesh_serve_steps(dev, mesh, total)
            print(f"[time]   mesh serving steps {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            mesh_engines(dev, mesh)
            print(f"[time]   mesh engines {time.perf_counter() - t0:.1f} s")
        finally:
            dist.destroy_process_group()
            torch.cuda.empty_cache()
    print(f"[time]   serving under a mesh {time.perf_counter() - t_phase:.1f} s")
    return total


def per_step(rows, key):
    return sum(r["calls"] * r[key] for r in rows)


def f32(rows, **match):
    return [r for r in rows if r["dtype"] == "float32"
            and all(r[k] == v for k, v in match.items())]


def kernel_entry(name, route, source, replaces, launches, rows, err_rows, library):
    """One kernel's JSON entry: float32 times summed over one step's calls."""
    return dict(name=name, route=route, source=source, replaces=replaces,
                launches=launches, max_abs_err=max(r["max_abs_err"] for r in err_rows),
                ms=per_step(rows, "ms"), plain_ms=per_step(rows, "plain_ms"),
                bound_ms=per_step(rows, "bound_ms"),
                bound_by=("bytes" if per_step(rows, "bytes_ms") >= per_step(rows, "ops_ms")
                          else "operations"),
                library_ms=per_step(rows, "library_ms") if library else None)


# -- phase 21: the dry run -------------------------------------------------------

# the dry run's peak against the card's max_memory_allocated above the bytes
# allocated before the state: the fake tracker rounds each storage to the
# allocator's 512-byte block as the allocator does, and frees it when its
# last tensor goes; what it cannot see (the kernels' own scratch, the
# allocator's bookkeeping) is small beside lm-100m's ~2 GB step, so 5%
# bounds the difference (stated before the first run; PERF.md §6, PR 29)
DRY_PEAK_RTOL = 0.05
DRY_CHILD_TIMEOUT_S = 600


def dry_child_cells():
    """The dry run's side of phase 21 (in the child, no card): (a) the
    lm-100m cell at remat full and none on a one-rank fake mesh; (b)
    llama3-405b train_4k on (16, 16), mask, SP, from the depth model."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.hlo_analysis import HW, roofline_terms

    torch.set_num_threads(1)
    out = {"a": {}}
    cell = ShapeCell("lm100m_train", SEQ, BATCH, "train")
    with dryrun.fake_group(1):
        mesh = meshlib.make_mesh((1, 1), ("data", "model"), device="cpu")
        for remat in ("full", "none"):
            t0 = time.perf_counter()
            c, _, _ = dryrun._run(lm100m().replace(remat=remat), cell, mesh,
                                  (slice_policy(0.2), False), False, 1, "cpu")
            keep = ("payload", "coll_bytes", "flops", "flops_aten", "bytes", "peak_bytes",
                    "resident_bytes", "launches")
            out["a"][remat] = dict({k: c[k] for k in keep}, seconds=time.perf_counter() - t0,
                                   roofline=roofline_terms(c["flops"], c["bytes"],
                                                           c["coll_bytes"], 1, HW(),
                                                           dtype="float32"))
    t0 = time.perf_counter()
    rec = dryrun.record_or_error("llama3_405b", "train_4k", policy_name="mask", sp=True,
                                 full_depth=False, coverage=False)
    rec.pop("cost_attribution", None)
    out["b"] = dict(rec, seconds=time.perf_counter() - t0)
    return out


def start_dry_child():
    """Start phase 21's dry run in a child process on the host CPU (no
    card visible to it): (Popen, its output file)."""
    import tempfile

    f = tempfile.NamedTemporaryFile("w+", suffix=".json", delete=False)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dry-run-child"],
                            stdout=f, stderr=subprocess.PIPE, env=env, text=True)
    return proc, f


def dry_real_step(dev, mesh, cfg, full, batch, flop_count=False):
    """One lm-100m step on the card on the one-rank mesh from ``full``'s
    parameters: (state, counts, launches, payload, peak bytes above what was
    allocated before the state, FlopCounterMode total or None)."""
    import gc

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.api import ExecutionConfig
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import collective_bytes, reset_collective_bytes
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.tree import tree_map

    gc.collect()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    ex = ExecutionConfig(mesh=mesh)
    opt = adamw(cosine_warmup(3e-4, 2000, 100_000), weight_decay=0.1, clip=1.0)
    st = init_state(0, cfg, opt, params=tree_map(lambda t: t.detach().clone(), full),
                    device=dev, execution=ex)
    fn = make_train_step(cfg, opt, slice_policy(0.2), execution=ex, device=dev)
    b = shard_batch(batch, mesh=mesh)
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    reset_collective_bytes()
    flops = None
    if flop_count:
        fc = FlopCounterMode(display=False)
        with fc:
            st, m = fn(st, b, 21)
        flops = fc.get_total_flops()
    else:
        st, m = fn(st, b, 21)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    return st, m, ops.launch_counts(), collective_bytes()["total"], peak, flops, fn, b


def dry_run(dev, child):
    """Phase 21 (module docstring). ``child``: :func:`start_dry_child`'s.
    Returns the launches of the card's steps that count."""
    import tempfile

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import LMStream
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    total = {}
    real = {}
    cfg0 = lm100m()
    full = lm.init_params(21, cfg0, device=dev)
    batch = next(iter(LMStream(vocab=cfg0.vocab, seed=21).batches(BATCH, SEQ)))
    with tempfile.TemporaryDirectory() as tmp:
        mesh = dist_group(tmp)
        try:
            for remat in ("full", "dots", "none"):
                cfg = cfg0.replace(remat=remat)
                st, m, counts, payload, peak, _, fn, b = dry_real_step(dev, mesh, cfg, full,
                                                                        batch)
                add_counts(total, counts)
                leaves = [t.detach().clone() for t in tree_leaves(st.params)
                          + tree_leaves(st.opt_state)]
                t0 = time.perf_counter()
                for i in range(DIST_TIMED):
                    st, m2 = fn(st, b, 30 + i)
                float(m2["loss"])
                torch.cuda.synchronize(dev)
                step_ms = 1e3 * (time.perf_counter() - t0) / DIST_TIMED
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    st, m2 = fn(st, b, 40)
                    float(m2["loss"])
                    torch.cuda.synchronize(dev)
                kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
                busy_ms = sum(_device_us(e) for e in kern) / 1e3
                del st
                st2, _, counts2, _, _, flops, _, _ = dry_real_step(dev, mesh, cfg, full, batch,
                                                                   flop_count=True)
                add_counts(total, counts2)
                del st2
                real[remat] = dict(loss=float(m["loss"]), counts=counts, payload=payload,
                                   peak=peak, flops=flops, leaves=leaves, step_ms=step_ms,
                                   busy_ms=busy_ms)
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
            torch.cuda.empty_cache()
    for remat in ("full", "dots"):
        if not all(torch.equal(x, y) for x, y in zip(real[remat]["leaves"],
                                                      real["none"]["leaves"])):
            raise AssertionError(f"[dry] the card's remat {remat} and none steps differ")
        if real[remat]["loss"] != real["none"]["loss"]:
            raise AssertionError(f"[dry] the card's remat {remat} and none losses differ")
    print(f"[dry] (a) the card's lm-100m mesh step at remat full, dots and none: bit for bit "
          f"(loss {real['full']['loss']:.6f}, {len(real['full']['leaves'])} state leaves)")
    print("[dry] (a) remat on the card (phase 17's cell): "
          + "; ".join(f"{r} {real[r]['step_ms']:.2f} ms/step, busy {real[r]['busy_ms']:.2f} ms, "
                      f"peak {real[r]['peak'] / 2**30:.4f} GiB" for r in ("none", "dots", "full"))
          + f" ({smi_line()})")
    t_wait = time.perf_counter()
    proc, f = child
    try:
        _, err = proc.communicate(timeout=max(1.0, DRY_CHILD_TIMEOUT_S))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"[dry] the dry run's child did not finish in "
                             f"{DRY_CHILD_TIMEOUT_S} s")
    if proc.returncode != 0:
        raise AssertionError(f"[dry] the dry run's child failed:\n{err[-4000:]}")
    f.seek(0)
    dry = json.loads(f.read().strip().splitlines()[-1])
    f.close()
    os.unlink(f.name)
    print(f"[dry] waited {time.perf_counter() - t_wait:.1f} s for the child")
    for remat in ("full", "none"):
        d, r = dry["a"][remat], real[remat]
        want_payload = dist_payload_a(lm100m().replace(remat=remat))
        if not d["payload"] == r["payload"] == want_payload:
            raise AssertionError(f"[dry] remat {remat}: payload dry {d['payload']} B, card "
                                 f"{r['payload']} B, phase 17's formula {want_payload} B")
        if not (d["launches"]["col_l1_scores"] == r["counts"]["col_l1_scores"] == 84
                and d["launches"]["block_gather_matmul_fused"]
                == r["counts"]["block_gather_matmul_fused"] == 84):
            raise AssertionError(f"[dry] remat {remat}: launches dry {d['launches']}, card "
                                 f"{r['counts']}, want 84 + 84")
        if d["flops_aten"] != r["flops"]:
            raise AssertionError(f"[dry] remat {remat}: FlopCounterMode dry {d['flops_aten']}, "
                                 f"card {r['flops']}")
        rel = abs(d["peak_bytes"] - r["peak"]) / r["peak"]
        if not rel <= DRY_PEAK_RTOL:
            raise AssertionError(f"[dry] remat {remat}: peak dry {d['peak_bytes']} B, card "
                                 f"{r['peak']} B ({100 * rel:.2f}% > {100 * DRY_PEAK_RTOL}%)")
        rf = d["roofline"]
        print(f"[dry] (a) remat {remat}: payload {d['payload']:,} B (= card = phase 17's "
              f"formula), wire {d['coll_bytes']:,.0f} B (one rank: none), launches 84 + 84 "
              f"(= card), FlopCounterMode {d['flops_aten']:,} (= card), modelled kernel "
              f"operations {d['flops'] - d['flops_aten']:,}, bytes accessed {d['bytes']:,}; "
              f"peak {d['peak_bytes'] / 2**30:.4f} GiB dry, {r['peak'] / 2**30:.4f} GiB card "
              f"({100 * rel:.2f}%, within {100 * DRY_PEAK_RTOL:.0f}%); roofline compute "
              f"{1e3 * rf['compute_s']:.3f} ms (float32 FFMA peak), memory "
              f"{1e3 * rf['memory_s']:.3f} ms, dominant {rf['dominant']}; card "
              f"{r['step_ms']:.2f} ms/step over {DIST_TIMED} steps, device busy "
              f"{r['busy_ms']:.2f} ms in a profiled step; dry run {d['seconds']:.1f} s "
              f"({smi_line()})")
    if dry["a"]["full"]["peak_bytes"] >= dry["a"]["none"]["peak_bytes"]:
        raise AssertionError("[dry] remat full's dry peak is not below none's")
    rec = dry["b"]
    if rec.get("status") != "ok":
        raise AssertionError(f"[dry] (b) llama3-405b train_4k: {rec.get('error')}")
    from repro_torch.launch.hlo_analysis import HW

    mem, rf = rec["memory"], rec["roofline"]
    usable = HW.from_device(dev).hbm_bytes
    print(f"[dry] (b) llama3-405b train_4k on 16x16, mask, SP, accum {rec['accum']} "
          f"({rec['depth_used']}: depth points {[p['n_full'] for p in rec['cost_points']]} "
          f"layers, the full depth's 126 predicted): peak {mem['peak_GB_per_dev']:.2f} GB per "
          f"rank, fits HW.hbm_bytes {HW().hbm_bytes / 1e9:.2f} GB: {mem['fits_hbm']} (this "
          f"card's total_memory {usable:,.0f} B); dominant "
          f"{rf['dominant']} (compute "
          f"{rf['compute_s']:.3f} s, memory {rf['memory_s']:.3f} s, collective "
          f"{rf['collective_s']:.3f} s per step); wire "
          f"{rec['cost_full_depth']['coll_bytes'] / 1e9:.2f} GB per rank; payload "
          f"{rec['cost_full_depth']['payload'] / 1e9:.2f} GB; "
          f"{rec['seconds']:.1f} s on the host CPU")
    print(f"[time]   dry run {time.perf_counter() - t_phase:.1f} s")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    smi = smi_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
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
    unfused_rows = check_unfused(gen, dev)
    stream_rows = check_stream(gen, dev)
    flash_rows = check_flash(gen, dev)
    check_scores_wide(gen, dev)
    check_score_streams(gen, dev)
    print(f"[kernel] checks and timings {time.perf_counter() - t0:.1f} s")
    # phase 21's dry run runs on the host CPU beside the card's phases
    child = start_dry_child()
    try:
        return run_phases(dev, gen, smi, child, score_rows, fused_rows, unfused_rows,
                          stream_rows, flash_rows)
    finally:
        if child[0].poll() is None:
            child[0].kill()
            child[0].communicate()


def run_phases(dev, gen, smi, child, score_rows, fused_rows, unfused_rows, stream_rows,
               flash_rows) -> int:
    """Phases 4 to 22 (module docstring)."""
    t0 = time.perf_counter()
    wiring_check(dev)
    path_counts = {backend: main_path(dev, backend) for backend in BACKENDS}
    path_counts["pallas-compact"] = main_path(dev, "pallas", compact=True)
    compact_step_check(dev)
    launches = {name: sum(c[name] for c in path_counts.values())
                for name in path_counts["pallas"]}
    print(f"[time] wiring, main paths and the compact check {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    step_breakdown(dev, {
        "pallas": {"col_l1_scores": per_step(f32(score_rows, mode="l1"), "ms"),
                   "block_gather_matmul_fused": per_step(f32(fused_rows, with_scores=False),
                                                         "ms")},
        "onepass": {"block_stream_matmul_fused": per_step(f32(stream_rows, mode="l1"), "ms")},
        "stale": {"block_gather_matmul_fused": per_step(f32(fused_rows, with_scores=True),
                                                        "ms")}})
    print(f"[time] step breakdown {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_counts = serve_path(dev)
    launches["flash_attention"] = serve_counts["flash_attention"]
    plain_decode = serve_breakdown(dev)
    print(f"[time] serving and its breakdown {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paper_rows = paper_kernels(gen, dev)
    paper_wiring(dev)
    paper_path = {model: paper_train(dev, model) for model in PAPER}
    for name in ("col_l1_scores", "block_gather_matmul_fused"):
        launches[name] += sum(c[name] for c in paper_path.values())
    paper_quickstart(dev)
    paper_breakdown(dev, {model: {name: per_step(f32(r), "ms") for name, r in rows.items() if r}
                          for model, rows in paper_rows.items()})
    print(f"[time] the paper's models {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    loop_counts = trainer_loop(dev)
    for name, n in loop_counts.items():
        launches[name] += n
    print(f"[time] the trainer loop {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine_counts = serving_engines(dev, plain_decode)
    for name, n in engine_counts.items():
        launches[name] += n
    print(f"[time] the serving engines {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res_counts = resilience(dev)
    for name, n in res_counts.items():
        launches[name] += n
    print(f"[time] resilience {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fam_counts, fam_rows = families(dev, gen)
    for name, n in fam_counts.items():
        launches[name] += n
    print(f"[time] the model families {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ssm_counts, ssm_rows = ssm_families(dev, gen)
    for name, n in ssm_counts.items():
        launches[name] += n
    for name, rs in ssm_rows.items():
        fam_rows[name] += rs
    print(f"[time] the SSM and hybrid families {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vlm_counts, vlm_rows = vlm_audio(dev, gen)
    for name, n in vlm_counts.items():
        launches[name] += n
    for name, rs in vlm_rows.items():
        fam_rows[name] += rs
    print(f"[time] the VLM and audio families {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fe_counts = family_engines(dev)
    for name, n in fe_counts.items():
        launches[name] += n
    print(f"[time] the family engines {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dist_counts = distributed(dev)
    for name, n in dist_counts.items():
        launches[name] += n
    print(f"[time] the distributed runtime {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    an_counts = analysis(dev)
    for name, n in an_counts.items():
        launches[name] += n
    print(f"[time] the analysis tooling {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_fam_counts = families_mesh(dev)
    for name, n in mesh_fam_counts.items():
        launches[name] += n
    print(f"[time] the families under a mesh {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_mesh_counts = serving_mesh(dev)
    for name, n in serve_mesh_counts.items():
        launches[name] += n
    print(f"[time] serving under a mesh {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dry_counts = dry_run(dev, child)
    for name, n in dry_counts.items():
        launches[name] += n
    print(f"[time] the dry run {time.perf_counter() - t0:.1f} s")
    paper_f32 = {name: [r for rows in paper_rows.values() for r in f32(rows[name])]
                 for name in ("col_l1_scores", "block_gather_matmul_fused")}

    csrc = "src/repro_torch/kernels/csrc/"
    replaces = "src/repro/kernels/sketch_matmul.py:"
    kernels = [
        kernel_entry("col_l1_scores", "cuda", csrc + "col_scores.cu",
                     "src/repro/kernels/col_scores.py:42", launches["col_l1_scores"],
                     f32(score_rows, mode="l1"),
                     f32(score_rows) + paper_f32["col_l1_scores"] + fam_rows["col_l1_scores"],
                     library=True),
        kernel_entry("block_gather_matmul", "cuda", csrc + "block_gather_matmul_fused.cu",
                     replaces + "47", launches["block_gather_matmul"],
                     f32(unfused_rows["block_gather_matmul"]),
                     f32(unfused_rows["block_gather_matmul"]), library=False),
        kernel_entry("block_gather_matmul_dw", "cuda", csrc + "block_gather_matmul_fused.cu",
                     replaces + "109", launches["block_gather_matmul_dw"],
                     f32(unfused_rows["block_gather_matmul_dw"]),
                     f32(unfused_rows["block_gather_matmul_dw"]), library=False),
        kernel_entry("block_gather_matmul_fused", "cuda", csrc + "block_gather_matmul_fused.cu",
                     replaces + "210", launches["block_gather_matmul_fused"],
                     f32(fused_rows, with_scores=False),
                     f32(fused_rows) + paper_f32["block_gather_matmul_fused"]
                     + fam_rows["block_gather_matmul_fused"], library=False),
        kernel_entry("block_stream_matmul_fused", "cuda", csrc + "block_stream_matmul_fused.cu",
                     replaces + "381", launches["block_stream_matmul_fused"],
                     f32(stream_rows, mode="l1"),
                     f32(stream_rows) + fam_rows["block_stream_matmul_fused"], library=False),
        kernel_entry("flash_attention", "cuda", csrc + "flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:76", launches["flash_attention"],
                     f32(flash_rows, shape=[*SERVE_WAVES[0], SERVE_WAVES[0][1], 12, 12, 64]),
                     f32(flash_rows) + fam_rows["flash_attention"], library=True),
    ]
    print(f"# launches: summed over the main paths' runs ({STEPS} steps each): "
          f"{json.dumps(path_counts)}; serving (two waves): {json.dumps(serve_counts)}; "
          f"the paper's models ({STEPS} steps each): {json.dumps(paper_path)}; the trainer "
          f"loop (all of phase 10's runs): {json.dumps(loop_counts)}; the serving engines "
          f"(phase 11: every engine run 0, then {ENGINE_TRAIN_STEPS} traced training steps): "
          f"{json.dumps(engine_counts)}; resilience (all of phase 12's runs): "
          f"{json.dumps(res_counts)}; the model families (phase 13's main paths: olmoe and "
          f"gemma3 training, {FAM_STEPS} steps per backend, and one prefill each): "
          f"{json.dumps(fam_counts)}; the SSM and hybrid families (phase 14's main paths: "
          f"rwkv6-3b and zamba2-7b training, {FAM_STEPS} steps per backend, and one prefill "
          f"each): {json.dumps(ssm_counts)}; the VLM and audio families (phase 15's main "
          f"paths: qwen2-vl-2b and seamless-m4t-large-v2 training, {FAM_STEPS} steps per "
          f"backend, qwen's stale step at accum 2, and one prefill each): "
          f"{json.dumps(vlm_counts)}; the family engines (phase 16: every engine run 0): "
          f"{json.dumps(fe_counts)}; the distributed runtime (phase 17: the one-rank mesh's "
          f"sketched steps and their single-device twins): {json.dumps(dist_counts)}; the analysis "
          f"tooling (phase 18's cross-checks, one forward and backward per config): "
          f"{json.dumps(an_counts)}; the families under a mesh (phase 19: every sketched "
          f"single-device and one-rank mesh step): {json.dumps(mesh_fam_counts)}; serving "
          f"under a mesh (phase 20: the one-rank mesh's two lm-100m waves and engines): "
          f"{json.dumps(serve_mesh_counts)}; the dry run (phase 21: the card's four lm-100m "
          f"mesh steps it is held against): {json.dumps(dry_counts)}")
    print("# kernels: times are float32, summed over one lm-100m step's calls at the paths' "
          "shapes (the unfused pair: the fused kernel's calls, which it would replace); "
          "flash_attention: over one wave-1 prefill's calls; the paper's models' times are "
          "in the [paper-kernel] lines, the families' (phases 13 to 15) in the "
          "[family-kernel] lines; "
          "max_abs_err over every float32 shape")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--dry-run-child"]:
        import warnings

        warnings.filterwarnings("ignore")
        print(json.dumps(dry_child_cells(), default=str))
        sys.exit(0)
    sys.exit(main())
