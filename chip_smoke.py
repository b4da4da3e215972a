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
10. the trainer loop (``examples/train_lm.py``'s features) on lm-100m cut
   to 4 of its 12 layers (``LOOP_LAYERS``) at batch 8 x 256 with AdamW and
   cosine warm-up: ``Runtime.train`` for 8 steps under
   ``BudgetSchedule.adaptive`` (buckets exact, 1.0, 0.5, 0.1) with the
   ``pallas`` policy and a JSONL sink, launch counts read after every step:
   every budget one of the controller's buckets, two or more sketched
   buckets, 28 score and 28 fused launches per sketched step and none per
   exact step, a finite ``probe_snr`` at every sketched step, one record per
   step with the same ``probe_sites`` keys; the controller's per-step fetch
   against a constant schedule; one step of each backend with probes on and
   off from the same state (bit for bit, the same launches; under
   ``pallas`` device ops, busy and wall time, interleaved); a ``stale`` step
   at accum 2 (56 fused launches) against the mean of its two
   microbatches; and ``warmup_exact(1)`` for 4 steps straight against the
   same run stopped at step 2 and resumed by a fresh Runtime (losses, both
   checkpoints verified, a corrupted one refused with ``restore`` falling
   back, bytes and seconds per checkpoint);
11. the serving engines on lm-100m (4 of its 12 layers, ``ENGINE_LAYERS``;
   ``attn_impl="pallas"``, random weights from a seed): 32 requests from
   numpy (prompts of 16-768 tokens, max_new
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
   device time and bytes) beside phase 8's plain decode step (12 layers);
12. resilience around the lm-100m trainer (4 of its 12 layers,
   ``LOOP_LAYERS``; batch 8 x 256, block-128 l1@0.2,
   ``examples/train_lm.py``'s AdamW, ``ResilienceConfig(max_grad_norm=1e13)``:
   the sketched estimator's own norm reaches ~1e9-1e11 at this budget): under
   ``pallas`` and ``stale``, 4 steps with resilience off (``Runtime.train``)
   and on with no fault (``Supervisor``), in the order off, on, on, off:
   final states equal bit for bit, no trip, the same launches; under
   ``pallas``, ``onepass``, ``stale`` and compact ``pallas``, a ``nonfinite``
   and a ``spike`` fault through ``Supervisor``: each trips, the parameters,
   moments and carry are bit-identical through each tripped step, the next
   ``escalate_steps`` steps run exact with 0 launches, every leaf finite at
   the end; then ``FaultPlan.drill(ckpt_every=3)`` over 15 ``pallas`` steps
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
   cut to 2 of 16 layers and float32) and gemma3-1b (12 of its 26 layers:
   two 5 local : 1 global periods; vocab 262,144; float32), each at batch 4
   x 512: one gradient at budget
   0.999 equal to exact backprop's for every leaf (olmoe under ``pallas``,
   ``onepass`` and ``stale``, gemma3 under ``pallas``), then
   ``Runtime.train`` for 2 steps at l1@0.2 block 128 under each of those
   backends with the launch counts set to 0 before and read after (olmoe
   392 per kernel per step, 2 x (4 + 3 x 64) sites; gemma3 84), finite
   losses and aux, the replicas dropped by the capacity printed; one exact
   step beside one pallas step (ms, device-busy ms, device ops, idle share,
   peak memory; olmoe's pallas step only in its training run); serving
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
   layers at d 3584 with one shared attention block every 6; cut to 7
   layers, one period and a one-layer remainder), each at batch 4 x 512
   and the full configs' chunk of 256: one gradient at budget 0.999 equal
   to exact backprop's for every leaf under ``pallas``, ``onepass`` and
   ``stale``, every exact gradient finite; ``Runtime.train`` for 2 steps per
   backend with the launch counts set to 0 before and read after (rwkv 32
   sites per step, zamba 28); one profiled ``pallas`` step each (ms,
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
   plain versions; qwen2-vl-2b (7 of 28 layers, d 1536, M-RoPE, the vision
   stub's embeds and a 16 x 16 grid's positions [3, B, S]) and
   seamless-m4t-large-v2 (6 + 6 of 24 encoder + 24 decoder layers, d 1024,
   the audio stub's 768 frames) at batch 4 x 512 (a quarter of the depths:
   halved for layer remat's recompute, and again for the chunked
   attention's host ops): one gradient at budget
   0.999 equal to exact backprop's for every leaf under each backend, every
   exact gradient finite; ``Runtime.train`` for 2 steps per backend with the
   launch counts set to 0 before and read after (qwen 49 sites per step,
   seamless 96), and a qwen ``stale`` step at accum 2 whose split takes
   the positions on axis 1 (2 x 49); one exact and one profiled ``pallas``
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
   step (``distributed(dev)``); (a') one step with the residual stream in
   another layout between the layers (``DIST_LAYOUT``: the relayout's
   moves) bit for bit the fixed layout's; (e) a ``device_loss`` fault under
   the ``Supervisor`` onto the surviving (1, 1) mesh: the state resumed at
   the seam the checkpoint's bit for bit, JAX's ``device_loss_reshard``
   event, training to its last step, its launches counted;
18. the analysis tooling (``analysis(dev)``): the lint over
   ``src/repro_torch`` with no finding and exactly the reviewed waivers;
   ``analyze_runtime`` on the card for lm-100m, olmoe-1b-7b (2 layers),
   gemma3-1b (12), rwkv6-3b (4), zamba2-7b (7), qwen2-vl-2b (7),
   seamless-m4t-large-v2 (6 + 6), yi-6b (4) and mixtral-8x22b (1) at full
   width under the block-128 l1@0.2 ``pallas`` policy, the baseline gate
   green;
   and one forward and backward of each at 1 x 256 whose score and fused
   kernels each launch exactly the analyzer's count of sketched site
   applications;
19. every family under a one-rank NCCL mesh (``families_mesh(dev)``):
   olmoe-1b-7b (1 layer), mixtral-8x22b (1), gemma3-1b (6), rwkv6-3b (2),
   zamba2-7b (6 and the shared block), qwen2-vl-2b (2) and
   seamless-m4t-large-v2 (2 + 2) at full width, float32, block-128 l1@0.2:
   one mesh step bit for bit the single-device step with equal score and
   fused launches; the TP plans' sites, launches and loss; olmoe's mesh
   checkpoint restored bit for bit; ms per step, single against mesh (one
   timed and one profiled step each);
20. serving under a one-rank NCCL mesh (``serving_mesh(dev)``): lm-100m's
   serving main path (``attn_impl="pallas"``, waves 8 x 1024 and 4 x 1000,
   32 greedy steps) through ``Runtime(execution=ExecutionConfig(mesh=))``:
   12 flash_attention launches per prefill and none in decode, logits and
   tokens bit for bit the single device's, every prefill's and decode
   step's collective payload equal to ``serve_payload``'s count from the
   shapes; phase 11's paged and run-to-completion engines (4 layers) and one
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
22. JAX's chunked attention (``chunked_attention(dev, gen)``): (a) yi-6b's
   attention geometry (H 32, Kv 4, dh 128, causal, float32, 1 x 4096, Cq
   512, ck 1024): the chunked core against the einsum's, outputs and q/k/v
   gradients within ``ATTN_RTOL``, forward FlopCounterMode totals equal,
   and the peak of a forward and backward below the einsum's by at least
   the [1, 32, 4096, 4096] float32 score tensor; (b) gemma3-1b's local
   layer (window 512, H 4, Kv 1, dh 256): the chunked forward's FLOPs
   exactly (512 + 512) / 4096 of the einsum's, outputs within
   ``ATTN_RTOL``; (c) the flash kernel against the chunked forward at both
   shapes; (d) yi-6b at full width cut to 2 of 32 layers (batch 1 x 4096,
   block-128 l1@0.2 ``pallas``, AdamW): one chunked and one einsum step
   after a warm-up step each, each launching 14 + 14 score and fused
   kernels (set to 0 just before, read just after), with the loss, the peak
   and the ms printed, and the two impls' exact gradients within
   ``GRAD_RTOL``; (e) lm-100m's main-path step with each impl, interleaved,
   84 + 84 launches per step, and the ms per step;
23. the compact backends on split local-plan sites
   (``split_compact(dev, gen)``; ``core.sketched_linear.split_backward``,
   the rank's part of a backward on a site split over model): at yi-6b's
   ``mlp_in`` (d 4096 -> 11,008, split over 16 emulated model ranks into
   column shards of 688: kept blocks of 128 straddle two shards, and some
   shards keep none) and at a row shard of its ``mlp_out`` (d_in 688 of
   11,008), N 2048 float32 rows, the whole width's block-128 l1@0.1 plan
   drawn from the score kernel's scores: for ``pallas``, ``onepass`` and
   ``stale``, every emulated rank's part on the card, its launches counted
   (set to 0 just before the ranks' calls, read just after: one fused or
   stream launch per rank, and the score kernel per column shard under
   ``pallas``), each held to its plain twin (the same window through the
   plain versions) within ``TOL``, and to the whole width's kernel call:
   each column shard's rows of dWc and db bit for bit and zeros elsewhere,
   the shards' dX summed within ``SPLIT_DX_RTOL``, the refreshed scores of
   its columns (``onepass`` within ``SPLIT_SCORE_RTOL``, ``stale``'s kept
   ones bit for bit), a shard's scores within ``TOL`` of the plain column
   reduction; a row shard's dX,
   dWc and db bit for bit; the ms of the ranks' calls beside the whole
   call's and the plain twins';
24. every sketch method on split local-plan sites (``split_methods(dev,
   gen)``), over 16 emulated column ranks of yi-6b's ``attn_q`` (d 4096 ->
   4096, 256 columns per rank, N 2048 float32 rows), through the functions
   the mesh path runs with each rank's offsets: (a) ``gsv`` on ``pallas``,
   block 128, budget 0.1: the whole width's scores from G's gathered columns
   (``summed_column_scores``), the plan, and each rank's part
   (``split_backward``), 16 ``block_gather_matmul_fused`` launches counted
   (set to 0 just before the parts, read just after), each part within
   ``TOL`` of its plain twin, the rows bit for bit the whole call's and the
   parts' dX summed within ``SPLIT_DX_RTOL``; (b) ``rcs`` on ``mask``: one
   plan from Γ and W Wᵀ of the whole batch and width (``rcs_plan_from``)
   and each rank's columns of Ĝ (``apply_rcs_directions(lo=, n_loc=)``)
   against the whole call's within ``SM_RCS_RTOL`` of max |Ĝ| (the
   rounding bound of the two products whose widths differ printed
   beside); (c) ``per_element`` and ``per_sample`` at a narrow site (256 x
   512 x 512) over an emulated (4, 4) mesh by the fold rule
   (``rng.fold_generator``), 300 draws: the mean within ``SM_SIGMAS``
   standard errors of the exact dX and dW (projected on the exact gradient
   and on random signs), the summed variance within ``SM_VAR_RTOL`` of the
   analytic; the phase's seconds;
25. Mamba2's block split over emulated model ranks (``mamba_split(dev,
   gen)``): zamba2-7b's block at full width (d 3584, d_inner 7168, 112
   heads of 64, state 64, chunk 256, 4 x 512 float32, block-128 l1@0.2
   ``pallas`` on ``ssm_in``/``ssm_out``) once whole (3 score + 3 fused
   launches) and as 16 model ranks run it, 7 heads each
   (``nn.ssm.mamba_heads``, the norm's sum of squares summed over the
   ranks, each column rank's part of the ``ssm_in`` backwards from its own
   scores put together, each row rank's of ``out``): 48 score + 48 fused
   launches counted (set to 0 just before the ranks, read just after), the
   output summed within ``MS_OUT_RTOL`` and dX within ``SPLIT_DX_RTOL`` of
   the whole block's, every rank's compact rows the whole-width kernel
   call's bit for bit, the phase within ``MS_LIMIT_S``;
26. the vocabulary-parallel head and loss over emulated model ranks
   (``vocab_head(dev)``): gemma3-1b's tied head (vocabulary 262,144,
   d 1,152) and seamless-m4t-large-v2's untied one (256,206, d 1,024; 15
   chunks of 16,013 and one of 16,011) on a 2 x 4096 float32 batch, as 16
   model ranks run them (each rank's ``chunk_bounds`` rows, its chunk of
   the logits, ``models.lm.vocab_chunk_terms`` against the ranks'
   maximum, summed over the ranks): the mean nll within ``VH_LOSS_RTOL``
   of the whole vocabulary's on one device in float64, dX and the weight's
   gradient assembled from the chunks within ``VH_GRAD_RTOL`` of their
   largest (the float32 whole vocabulary's departures printed beside);
   one rank's head + loss peak on the card within ``VH_PEAK_RTOL`` of the
   dry run's fake-tensor accounting of the same call (made by phase 21's
   child, beside the card's phases); the ms of the whole,
   the 16 ranks and one rank; no kernel launch; the phase within
   ``VH_LIMIT_S``;
27. the paper's figure experiments on the §5 MLP (``figures(dev)``; the
   scripts in ``benchmarks/torch/``, all on the ``mask`` backend): (a) every
   distinct policy of the eight figures' quick grids (each ``FIG_SCRIPTS``
   script's ``grid()``: exact, fig1a's correlated and independent l1,
   fig1b's masks and sketches, fig2a's proxies, fig2b's gsv and rcs, fig4's
   first and last layers, the 784-512-512-10 MLP per column and in blocks
   of 128, bench_variance's; and ``bench_adaptive.POLICY``) trained by
   ``train_mlp`` for one epoch at lr 0.2 on the quick-mode data: every
   accuracy finite, exact backprop's test accuracy above twice chance, no
   kernel launched (the counts set to 0 just before each run and read just
   after); (b) bench_variance's quick methods and budgets and l1 with
   independent gates (``sample_independent``), its quick draws each on its
   problem (``bench_variance.problem``): ``bias_sq`` within
   ``FIG_CHI2_1_TAIL`` x V / n_mc, and V within ``FIG_V_SIGMAS`` standard
   errors of the same draws' V on the host CPU from the same weights and
   batch; (c) ``bench_adaptive.run(tiny=True)``: one build per bucket of
   each schedule, adaptive backward FLOPs within fixed's, the budgets within
   the buckets; (d) each part's seconds, the phase within ``FIG_LIMIT_S``;
28. one JSON line listing the ported kernels, then the last line
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


def lm100m(n_layers=12):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name="lm-100m", family="dense", n_layers=n_layers, d_model=768,
                      n_heads=12, n_kv=12, d_ff=2048, vocab=32000,
                      q_chunk=128, kv_chunk=256)


def slice_policy(budget, backend="pallas"):
    from repro_torch.api import SketchConfig, SketchPolicy

    return SketchPolicy(base=SketchConfig(method="l1", budget=budget, backend=backend,
                                          block=BLOCK))


def expected_counts(backend, per_site, n_layers=12):
    """Launches of every kernel, zeros included, when each sketched site of
    lm-100m at ``n_layers`` runs ``per_site`` backwards under ``backend``."""
    from repro_torch.kernels import ops

    return {name: per_site * 7 * n_layers if name in SITE_KERNELS[backend] else 0
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


class TraceKey:
    """One name's events in a trace, as ``key_averages()`` lists them: the
    fields the phases read (times in microseconds)."""

    __slots__ = ("key", "device_type", "count", "self_device_time_total",
                 "self_cpu_time_total")

    def __init__(self, key, device_type):
        self.key, self.device_type = key, device_type
        self.count = 0
        self.self_device_time_total = self.self_cpu_time_total = 0.0


def trace_averages(prof):
    """``prof.key_averages()``'s entries by (name, device type) from the
    profiler's raw events: the count, a device event's time, a host event's
    self time (its duration less its direct children's on its thread). The
    function-event tree ``key_averages`` builds first takes seconds per
    lm-100m step on a slow host, most of a profiled step's cost; the names,
    the filtered events and the nesting are its own (``profiler_util``'s
    ``_rewrite_name`` and ``_filter_name``). Checked against
    ``key_averages`` once per run (phase 6)."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    out, names, host = {}, {}, {}
    for ev in prof.profiler.kineto_results.events():
        raw = ev.name()
        if _filter_name(raw) or getattr(ev, "is_hidden_event", lambda: False)():
            continue
        key = names.get(raw)
        if key is None:
            key = names[raw] = _rewrite_name(name=raw, with_wildcard=True)
        dt = ev.device_type()
        entry = out.get((key, dt))
        if entry is None:
            entry = out[(key, dt)] = TraceKey(key, dt)
        entry.count += 1
        dur = ev.duration_ns() / 1e3
        if dt != DeviceType.CPU:
            entry.self_device_time_total += dur
        elif not (ev.is_async() or ev.start_thread_id() != ev.end_thread_id()):
            host.setdefault(ev.start_thread_id(), []).append((ev.start_ns(), ev.end_ns(), entry))
    nodes = []  # host events nested per thread: [entry, parent, children]
    for evs in host.values():
        evs.sort(key=lambda e: (e[0], -e[1]))
        stack = []  # open events: [end, entry, duration less children, node]
        for start, end, entry in evs:
            while stack and stack[-1][0] <= start:
                _, done, self_us, _ = stack.pop()
                done.self_cpu_time_total += self_us
            dur = (end - start) / 1e3
            node = [entry, stack[-1][3] if stack else None, []]
            if stack:
                stack[-1][2] -= dur
                stack[-1][3][2].append(node)
            nodes.append(node)
            stack.append([end, entry, dur, node])
        for _, done, self_us, _ in stack:
            done.self_cpu_time_total += self_us
    # key_averages drops an op's only child of its own name (EventList's
    # _remove_dup_nodes), handing its children up; the self times per name
    # stay the same
    changed = True
    while changed:
        changed = False
        for node in nodes:
            entry, parent, children = node
            if parent is not None and parent[0] is entry and len(parent[2]) == 1 \
                    and parent[2][0] is node:
                parent[2] = children
                for ch in children:
                    ch[1] = parent
                node[1] = None
                entry.count -= 1
                changed = True
    return list(out.values())


def check_trace_averages(prof, evts):
    """:func:`trace_averages` against ``prof.key_averages()`` on one trace:
    every device entry's count and time equal, the host's op counts and
    self times side by side."""
    from torch.autograd import DeviceType

    t0 = time.perf_counter()
    ref = prof.key_averages()
    ref_s = time.perf_counter() - t0
    pick = lambda es, dt: {e.key: (e.count, _device_us(e))  # noqa: E731
                           for e in es if e.device_type == dt}
    got, want = pick(evts, DeviceType.CUDA), pick(ref, DeviceType.CUDA)
    if ({k: c for k, (c, _) in got.items()} != {k: c for k, (c, _) in want.items()}
            or any(not math.isclose(got[k][1], us, rel_tol=1e-6, abs_tol=0.01)
                   for k, (_, us) in want.items())):
        raise AssertionError(f"[trace] trace_averages' device entries {got} differ from "
                             f"key_averages' {want}")
    host = [e for e in evts if e.device_type == DeviceType.CPU]
    ref_host = [e for e in ref if e.device_type == DeviceType.CPU]
    print(f"[trace] trace_averages = key_averages on {sum(c for c, _ in got.values())} device "
          f"events; host events {sum(e.count for e in host)} / {sum(e.count for e in ref_host)}, "
          f"self host ms {sum(e.self_cpu_time_total for e in host) / 1e3:.1f} / "
          f"{sum(e.self_cpu_time_total for e in ref_host) / 1e3:.1f}; key_averages took "
          f"{ref_s:.1f} s")


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
        kern = [e for e in trace_averages(prof) if e.device_type == DeviceType.CUDA]
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
        evts = trace_averages(prof)
        kern = [e for e in evts if e.device_type == DeviceType.CUDA]
        busy_ms = sum(_device_us(e) for e in kern) / 1e3
        host = [e for e in evts if e.device_type == DeviceType.CPU]
        if label == "exact":
            check_trace_averages(prof, evts)
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
        evts = trace_averages(prof)
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
# phases 10 and 12 repeat ~110 lm-100m steps: they run it at a third of its
# depth for the script's time (12 layers until PR 32; every check is per
# layer or per step)
LOOP_LAYERS = 4
LOOP_STEPS = 8  # three buckets of the controller's walk (12 until PR 32)
COST_STEPS = 4  # each run of the controller's per-step fetch against a constant schedule
CKPT_STEPS, CKPT_EVERY = 4, 2
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

    cfg = lm100m(LOOP_LAYERS)
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
        want = (expected_counts("pallas", 1, cfg.n_layers)
                if h["budget"] is not None else expected_counts("pallas", 0, cfg.n_layers))
        if delta != want:
            raise AssertionError(f"step {h['step']} (budget {h['budget']}) launched {delta}, "
                                 f"want {want}")
    if counts != expected_counts("pallas", len(sketched), cfg.n_layers):
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
    # in both, histories only at the first and last step; two interleaved
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
        for name in ("adaptive", "constant", "constant", "adaptive"):
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
    if len(waits) != 2 * COST_STEPS:
        raise AssertionError(f"{len(waits)} per-step fetches in 2 adaptive runs")
    print(f"[loop] the adaptive controller's per-step fetch (budget 0.1, probes on, "
          f"{COST_STEPS} steps per run, order A C C A): ms/step adaptive "
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
    kern = [e for e in trace_averages(prof) if e.device_type == DeviceType.CUDA]
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

    cfg = lm100m(LOOP_LAYERS)
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
        want = expected_counts(backend, 1, cfg.n_layers)
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
        print(f"[probes] {backend}: one lm-100m step with probes on and off: {len(pairs)} leaves "
              f"(params, carry, AdamW moments) equal bit for bit, loss "
              f"{float(metrics[True]['loss']):.6f}, launches {counts[True]} both; probe_snr "
              f"{snr:.4f}, probe_var {float(m['probe_var']):.6g}, probe_gsq "
              f"{float(m['probe_gsq']):.6g}")
        if backend != "pallas":
            # the timed pairs and the profiled steps on the main path's
            # backend only (the script's time; each traced step takes seconds
            # to summarise)
            del states, fns
            continue
        wall = {False: [], True: []}
        ops.reset_launch_counts()
        for i, probes in enumerate((False, True, True, False)):
            sync(dev)
            t0 = time.perf_counter()
            states[probes], mm = fns[probes](states[probes], batches[1 + i % 2], 33 + i)
            float(mm["loss"])
            sync(dev)
            wall[probes].append(1e3 * (time.perf_counter() - t0))
        prof = {}
        for probes in (False, True):
            states[probes], last, n_ops, busy = profiled_step(
                dev, fns[probes], states[probes], batches[3], 40)
            prof[probes] = f"{n_ops} device ops, busy {busy:.2f} ms"
        add_counts(total, ops.launch_counts())
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

    cfg = lm100m(LOOP_LAYERS)
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
    if counts != expected_counts("stale", 2, cfg.n_layers):
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
    """``warmup_exact(1)``, ``stale`` l1@0.2, CKPT_STEPS steps straight; then
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

    cfg = lm100m(LOOP_LAYERS)
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
                          schedule=BudgetSchedule.warmup_exact(1), device=dev)
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
    print(f"[ckpt] stale l1@0.2, warmup_exact(1), {CKPT_STEPS} steps straight and resumed at "
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
# the engines serve lm-100m at LOOP_LAYERS of its 12 layers (all 12 before,
# ~35 s of the script; the engines' checks are per request, token and page),
# here and in phase 20's engines, which must give the same tokens
ENGINE_LAYERS = LOOP_LAYERS
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
    evts = trace_averages(prof)
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
    print(f"[engine-trace]   phase 8's plain decode step (12 layers, batch "
          f"{SERVE_WAVES[0][0]}, cache "
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

    cfg = lm100m(ENGINE_LAYERS).replace(attn_impl="pallas")
    plain_cfg = cfg.replace(attn_impl="chunked")
    params = lm.init_params(ENGINE_PARAM_SEED, cfg, device=dev)
    specs = engine_specs(cfg.vocab)
    sv = ServeConfig(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN, page_size=ENGINE_PAGE)
    total = {}
    runtime = Runtime(device=dev)
    kv_bytes = sv.pool_pages * sv.page_size * 2 * cfg.n_layers * cfg.n_kv * cfg.head_dim * 4
    print(f"[engine] lm-100m ({cfg.n_layers} layers), attn_impl pallas, {len(specs)} requests "
          f"(prompts "
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

    # obs on and off, interleaved after the first (off) run: off, on, off
    obs_tokens = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, on in enumerate((True, False)):
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
          f"{[round(w, 3) for w in on]} (order off, on, off): mean on over mean off "
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
# sites at full depth; phase 12 runs LOOP_LAYERS, 28 sites, whose norms are lower)
# sites), so JAX's default 1e3 would trip every sketched step; 1e13 sits two
# orders above the largest, and a spike of RES_SPIKE lands four orders or
# more beyond it, or overflows float32 (a non-finite norm: a trip too)
RES_MAX_GRAD_NORM = 1e13
RES_SPIKE = 1e14
RES_STEPS = 4  # steps of each run of the on/off comparison
RES_FAULT_AT = 1  # the nonfinite fault; the spike follows the escalation window
DRILL_STEPS, DRILL_EVERY = 15, 3  # the drill's last fault is at 14 (18 steps until PR 32)
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

    cfg = lm100m(LOOP_LAYERS)
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
            if counts != expected_counts(backend, RES_STEPS, cfg.n_layers):
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
              f"{expected_counts(backend, RES_STEPS, cfg.n_layers)} each; grad_norm "
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

    cfg = lm100m(LOOP_LAYERS)
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
            if delta != expected_counts(backend, 0 if h["budget"] is None else 1,
                                        cfg.n_layers):
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

    cfg = lm100m(LOOP_LAYERS)
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
            got != want or \
            drill["counts"] != expected_counts("pallas", n_sketched, cfg.n_layers) or \
            clean["counts"] != expected_counts("pallas", DRILL_STEPS, cfg.n_layers):
        raise AssertionError(f"trips {sorted(got_trips)} (faults {sorted(trip_steps)}), rollback "
                             f"at {rolled_at}; budgets {got}, by the rules {want}; launches "
                             f"{drill['counts']} for {n_sketched} sketched steps")
    prev = {k: 0 for k in drill["counts"]}
    for step, budget, c in drill["seen"]:
        delta = {k: c[k] - prev[k] for k in c}
        prev = c
        if delta != expected_counts("pallas", 0 if budget is None else 1, cfg.n_layers):
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
# training steps per backend in phases 13 to 15 (two: the launch counts and
# finite losses hold per step, and a third step's time went to phase 27)
FAM_STEPS = 2
# olmoe trains at 2 of its 16 layers: float32 weights, gradients and AdamW's
# two moments take 16 B per parameter (~110 GB at 16); 4 until layer remat
# (PR 29), whose recompute of the host-bound steps took the script's time
OLMOE_TRAIN_LAYERS = 2
# gemma3-1b trains at 12 of its 26 layers, two 5 local : 1 global periods
# (all 26 until the chunked attention's host ops took the script's time);
# it serves at its full depth
GEMMA_TRAIN_LAYERS = 12
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
# expert sites each; gemma3: 12 layers of 7 sites)
FAM_BLOCK_SHAPES = {
    "olmoe-1b-7b": {(2048, 2048, 2048, 3): 8, (320, 1024, 2048, 2): 256,
                    (320, 2048, 1024, 3): 128},
    "gemma3-1b": {(2048, 1024, 1152, 2): 12, (2048, 256, 1152, 1): 24,
                  (2048, 1152, 1024, 2): 12, (2048, 6912, 1152, 11): 24,
                  (2048, 1152, 6912, 2): 12}}
# flash per prefill: (B, Sq, Skv, H, Kv, dh, causal, window) -> calls
FAM_FLASH_SHAPES = {
    "olmoe-1b-7b": {(4, 512, 512, 16, 16, 128, True, None): 16},
    "gemma3-1b": {(2, 2048, 2048, 4, 1, 256, True, 512): 22,
                  (2, 2048, 2048, 4, 1, 256, True, None): 4}}


def family_cfgs():
    """(olmoe training, olmoe serving, gemma3 training, gemma3 serving)
    configs from the registry: float32 (published bfloat16); the training
    depths cut to OLMOE_TRAIN_LAYERS and GEMMA_TRAIN_LAYERS."""
    from repro_torch.configs.registry import get_config

    f32 = dict(dtype="float32", param_dtype="float32")
    olmoe = get_config("olmoe-1b-7b").replace(**f32)
    gemma = get_config("gemma3-1b").replace(**f32)
    return (olmoe.replace(n_layers=OLMOE_TRAIN_LAYERS), olmoe,
            gemma.replace(n_layers=GEMMA_TRAIN_LAYERS), gemma)


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


def family_breakdown(dev, cfg, data_seed, exact=True, sketched=True):
    """One exact step (unless ``exact`` is False) beside one pallas l1@0.2
    step (unless ``sketched`` is False: its synced time is then the training
    run's second step; AdamW, after a warm-up step each): synced ms per
    step, and under the profiler device-busy ms, device ops and the
    device-idle share; peak memory. The profiled sketched step's trace must
    hold every launch the counters count (``traced_step``)."""
    from repro_torch.api import Runtime
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw, cosine_warmup

    batches = [b for b, _ in zip(family_batches(cfg, data_seed), range(3))]
    runs = ((("exact", None),) if exact else ()) + (
        (("pallas-l1@0.2", slice_policy(0.2)),) if sketched else ())
    for label, policy in runs:
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
    olmoe_train, olmoe_serve, gemma_train, gemma = family_cfgs()
    for cfg, backends in ((olmoe_train, BACKENDS), (gemma_train, ("pallas",))):
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
        family_breakdown(dev, cfg, FAM_SEED + 2, sketched=not cfg.n_experts)
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
# do not fit 80 GB. rwkv trains at 4 layers; zamba at 7: one period of 6
# Mamba layers and the shared block, then a one-layer remainder, so both of
# the full plan's segment kinds run
# rwkv6-3b trains at 4 of 32 layers (8 until layer remat, PR 29, whose
# recompute of its host-bound steps took the script's time); zamba2-7b at 7
# (13 until the chunked attention's host ops took it too)
SSM_TRAIN_LAYERS = {"rwkv6-3b": 4, "zamba2-7b": 7}
# the families' kernel shapes at l1@0.2, block 128, and their calls per step:
# (N, n, d, rb) -> calls (rwkv: 4 layers of r/k/v/g/o/cm_r, cm_k, cm_v; zamba:
# 7 Mamba layers of in_z/in_x and out, 1 shared application of q/k/v/o,
# mlp in/gate and out)
SSM_BLOCK_SHAPES = {
    "rwkv6-3b": {(2048, 2560, 2560, 4): 24, (2048, 8960, 2560, 14): 4,
                 (2048, 2560, 8960, 4): 4},
    "zamba2-7b": {(2048, 7168, 3584, 11): 14, (2048, 3584, 7168, 6): 7,
                  (2048, 3584, 3584, 6): 4, (2048, 14336, 3584, 22): 2,
                  (2048, 3584, 14336, 6): 1}}
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
# the training depths: a quarter of each (qwen 7 of 28 layers, seamless 6 +
# 6 of 24 + 24): full depth until layer remat's recompute of the host-bound
# steps took the script's time, half until the chunked attention's host ops
# took it too; serving stays at full depth
VLM_TRAIN_LAYERS = {"qwen2-vl-2b": 7, "seamless-m4t-large-v2": 6}
# the families' kernel shapes at l1@0.2, block 128, and their calls per step:
# (N, n, d, rb) -> calls. qwen: 7 layers of q/o, k/v (GQA 12:2 of 128), mlp
# in/gate and out. seamless: N 3,072 (4 x 768 frames) at the encoder's 6
# layers of q/k/v/o and mlp in/out and at the decoder's cross k/v; N 2,048
# at the decoder's 6 layers of self q/k/v/o, cross q/o and mlp in/out
VLM_BLOCK_SHAPES = {
    "qwen2-vl-2b": {(2048, 1536, 1536, 2): 14, (2048, 256, 1536, 1): 14,
                    (2048, 8960, 1536, 14): 14, (2048, 1536, 8960, 2): 7},
    "seamless-m4t-large-v2": {(3072, 1024, 1024, 2): 36, (3072, 8192, 1024, 13): 6,
                              (3072, 1024, 8192, 2): 6, (2048, 1024, 1024, 2): 36,
                              (2048, 8192, 1024, 13): 6, (2048, 1024, 8192, 2): 6}}
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
    kern = [e for e in trace_averages(prof) if e.device_type == DeviceType.CUDA]
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
# (a'): a residual-stream layout other than the fixed one (the width over
# model, the batch replicated): on one rank the moves are copies, counted
DIST_LAYOUT = (None, None, "model")
# (e): the device_loss re-shard's run
DIST_LOSS_LAYERS, DIST_LOSS_STEPS, DIST_LOSS_AT = 1, 4, 3


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

    # (a') the residual stream living in another layout between the layers
    # (width over model, batch replicated): the relayout's moves run, and the
    # step is (a)'s bit for bit
    ex_l = ExecutionConfig(mesh=mesh, act_sharding=DIST_LAYOUT)
    mesh_l, m_l, c_l, bytes_l, _, _ = one(ex_l, policy, opt, "layout")
    if c_l != want or not (torch.equal(m_l["loss"], m2["loss"]) and all(
            torch.equal(a, b) for a, b in zip(dist_leaves(mesh_l), dist_leaves(mesh_a)))):
        raise AssertionError(f"[dist] (a') act_sharding {DIST_LAYOUT}: launches {c_l}, or the "
                             "step differs from the fixed layout's")
    print(f"[dist] (a') act_sharding {DIST_LAYOUT}: the step bit for bit (a)'s; launches "
          f"{c_l}; collective payload {bytes_l} B ({bytes_l - bytes_a:+d} B: the relayout's "
          "moves at each layer's entry and exit, counted on one-rank axes)")
    del mesh_l, mesh_a

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
    dist_device_loss(dev, mesh, tmp, total)


def dist_device_loss(dev, mesh, tmp, total):
    """Phase 17 (e): the supervisor's ``device_loss`` re-shard on the
    one-rank mesh, onto the surviving (1, 1) mesh: lm-100m at
    ``DIST_LOSS_LAYERS`` layers, ``pallas`` l1@0.2, AdamW, ``DIST_LOSS_STEPS``
    steps, a checkpoint every 2, the fault at step ``DIST_LOSS_AT``. The
    state resumed at the seam (``elastic.resume_on_mesh``, spied) must be the
    checkpoint's restore of its step bit for bit, the event JAX's, and the
    run must finish every step with finite losses."""
    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.resilience import FaultPlan, FaultSpec, ResilienceConfig, Supervisor
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import elastic
    from repro_torch.train.trainer import TrainerConfig

    t0 = time.perf_counter()
    cfg = lm100m(DIST_LOSS_LAYERS)
    rt = Runtime(policy=slice_policy(0.2), device=dev,
                 execution=ExecutionConfig(mesh=mesh, resilience=ResilienceConfig(
                     max_grad_norm=1e13)))  # phase 12's: sketched norms reach 1e3-1e11
    plan = FaultPlan(faults=(FaultSpec(step=DIST_LOSS_AT, kind="device_loss",
                                       mesh_shape=(1, 1)),))
    ckdir = os.path.join(tmp, "ckpt_device_loss")
    tcfg = TrainerConfig(steps=DIST_LOSS_STEPS, log_every=1, ckpt_dir=ckdir, ckpt_every=2,
                         seed=17)
    sup = Supervisor(rt, cfg, adamw(1e-3), tcfg, fault_plan=plan)
    seam = {}
    real = elastic.resume_on_mesh

    def spy(ckpt_dir, like, new_mesh, **kw):
        state, step = real(ckpt_dir, like, new_mesh, **kw)
        host, hstep = ck.restore(ckpt_dir, like, step=step, device=dev)
        seam.update(step=step, hstep=hstep, mesh=new_mesh, same=all(
            torch.equal(a, b) for a, b in zip(dist_leaves(state), dist_leaves(host))))
        return state, step

    elastic.resume_on_mesh = spy
    ops.reset_launch_counts()
    try:
        state, hist = sup.run(LMStream(vocab=cfg.vocab, seed=17).batches(BATCH, SEQ))
    finally:
        elastic.resume_on_mesh = real
    sync(dev)
    counts = ops.launch_counts()
    ev = [e for e in sup.events if e["event"] == "device_loss_reshard"]
    resume = DIST_LOSS_AT - DIST_LOSS_AT % 2
    n_steps = DIST_LOSS_STEPS + DIST_LOSS_AT - resume  # the lost steps run twice
    want = expected_counts("pallas", n_steps, DIST_LOSS_LAYERS)
    losses = [h["loss"] for h in hist]
    e = ev[0] if len(ev) == 1 else {}
    if not (seam.get("same") and seam.get("step") == seam.get("hstep") == resume
            and e.get("step") == DIST_LOSS_AT and e.get("cause") == "device_loss"
            and e.get("resume_step") == resume and e.get("steps_lost") == DIST_LOSS_AT - resume
            and e.get("old_mesh") == [1, 1] and e.get("new_mesh") == [1, 1]
            and e.get("wall_s", 0) > 0 and sup.runtime.execution.mesh is seam.get("mesh")
            and int(state.step) == DIST_LOSS_STEPS and counts == want
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"[dist] (e) device_loss re-shard: events {sup.events}, seam "
                             f"{seam}, step {int(state.step)}, launches {counts} (want {want}), "
                             f"losses {losses}")
    add_counts(total, counts)
    print(f"[dist] (e) device_loss at step {DIST_LOSS_AT} on the one-rank NCCL mesh -> (1, 1): "
          f"lm-100m at {DIST_LOSS_LAYERS} layers, pallas l1@0.2; resumed at step {resume} from "
          f"the checkpoint bit for bit on the rebuilt mesh; event {ev[0]}; {int(state.step)} "
          f"steps, losses {[round(v, 4) for v in losses]}; launches {counts}; "
          f"{time.perf_counter() - t0:.1f} s")
    del state


# ---------------------------------------------------------------------------
# The analysis tooling (phase 18): the lint gate over the port, and the
# coverage gate at full width, cross-checked against the kernels' launches
# ---------------------------------------------------------------------------

# (config, layers: None for the registry's depth, sketched site applications
# per step). The depths are the training phases 13 to 15's (float32 weights
# and gradients must fit 80 GB: mixtral's one layer takes ~23 GB; the
# analyzer's host time grows with the depth: olmoe 4, gemma3, qwen2-vl and
# seamless at their full depth, rwkv6 8 and zamba2 13 layers took ~20 s more);
# yi-6b and mixtral-8x22b run here for the first time at full width
ANALYSIS_CFGS = (("lm-100m", None, 84), ("olmoe-1b-7b", OLMOE_TRAIN_LAYERS, 392),
                 ("gemma3-1b", GEMMA_TRAIN_LAYERS, 84),
                 ("rwkv6-3b", SSM_TRAIN_LAYERS["rwkv6-3b"], 32),
                 ("zamba2-7b", SSM_TRAIN_LAYERS["zamba2-7b"], 28),
                 ("qwen2-vl-2b", VLM_TRAIN_LAYERS["qwen2-vl-2b"], 49),
                 ("seamless-m4t-large-v2", VLM_TRAIN_LAYERS["seamless-m4t-large-v2"], 96),
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
# 43.3 GiB, and the single-device step's results wait beside the mesh step
# for the comparison); the others with AdamW (parameters and both moments
# held bit for bit); olmoe at one layer: its steps are host-bound (~35 s a
# layer on the H100), and the script keeps inside its time limit
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
MESH_TIMED = 1  # synced steps timed per run, after (a)'s step (2 after a warm-up until PR 32)
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
    kern = [e for e in trace_averages(prof) if e.device_type == DeviceType.CUDA]
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
    # the single-device state waits on the card beside the mesh step
    ref = [t.detach() for t in dist_leaves(single)]
    loss1, gn1 = m1["loss"].detach(), m1["grad_norm"].detach()
    del single, m1
    ex_a = ExecutionConfig(mesh=mesh)
    mesh_a, m2, c2, bytes_a, fn_a, b_a = run(ex_a, policy)
    got = dist_leaves(mesh_a)
    same = (len(got) == len(ref) and torch.equal(loss1, m2["loss"].detach())
            and torch.equal(gn1, m2["grad_norm"].detach())
            and all(torch.equal(h, t.detach()) for h, t in zip(ref, got)))
    if c1 != want_a or c2 != want_a:
        raise AssertionError(f"[mesh-fam] {name} (a) launches {c2} (single {c1}), want {want_a}")
    if not same:
        raise AssertionError(f"[mesh-fam] {name} (a) the one-rank mesh step differs from the "
                             "single-device step")
    del ref, got
    print(f"[mesh-fam] {name} ({n_params} params, {cut}, {opt_name}): (a) tp_sketch off, "
          f"pallas l1@0.2 block {BLOCK}: loss {float(m2['loss']):.6f}, aux "
          f"{float(m2['aux']):.6g}, grad_norm {float(m2['grad_norm']):.6g}; "
          f"{len(dist_leaves(mesh_a))} leaves bit for bit the single-device step; "
          f"launches {c2} (= single); collective "
          f"payload {bytes_a} B; {time.perf_counter() - t0:.1f} s")

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
    sync(dev)
    # each step function ran once in (a): no warm-up
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
    want_d = family_counts(cfg, "pallas", 2 * (1 + MESH_TIMED))
    if counts_d != want_d:
        raise AssertionError(f"[mesh-fam] {name} (d) launches {counts_d}, want {want_d}")
    add_counts(total, counts_d)
    del states
    torch.cuda.empty_cache()
    print(f"[mesh-fam] {name} (d) ms per step ({MESH_TIMED} synced step after (a)'s, "
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
    cfg = lm100m(ENGINE_LAYERS).replace(attn_impl="pallas")
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
    llama3-405b train_4k on (16, 16), mask, SP, from the depth model; and
    phase 26's rank calls (``vh``: :func:`vh_dry_peaks`)."""
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
    out["vh"] = vh_dry_peaks()
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
    Returns the launches of the card's steps that count, and the child's
    accounting of phase 26's rank calls (:func:`vh_dry_peaks`)."""
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
                kern = [e for e in trace_averages(prof) if e.device_type == DeviceType.CUDA]
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
    return total, dry["vh"]


# -- phase 22: JAX's chunked attention --------------------------------------------

# (B, S, H, Kv, dh, window): yi-6b's attention geometry (GQA 32:4, causal,
# full) and gemma3-1b's local layer (window 512); the configs' q_chunk and
# kv_chunk
ATTN_YI = (1, 4096, 32, 4, 128, None)
ATTN_GEMMA = (1, 4096, 4, 1, 256, 512)
ATTN_CHUNKS = (512, 1024)
# float32 chunked against einsum (and flash against chunked): the same
# products, summed in another order (the online softmax rescales partial sums
# over 4 tiles of 1,024 keys). An output is a softmax-weighted mean over up to
# 4,096 keys and a gradient a sum over as many queries: ~sqrt(K) 2^-24 of the
# scale, 4e-6 at K = 4,096, so 2e-5 of each tensor's largest entry
ATTN_RTOL = 2e-5
# yi-6b trained at full width, cut to 2 of its 32 layers: 7 sketched sites a
# layer (the head stays exact), batch 1 x 4,096
YI_LAYERS, YI_SEQ = 2, 4096
# (e): lm-100m's timed steps per attention impl
LM_IMPL_REPS = 4


def attn_pass(dev, cfg, q, k, v, ct):
    """One forward and backward of ``cfg``'s core on fresh leaves: (out,
    grads, peak bytes above the inputs, ms)."""
    from repro_torch.nn.attention import multi_head_attention

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = multi_head_attention(*leaves, cfg)
    (out * ct).sum().backward()
    end.record()
    end.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    return out.detach(), [t.grad for t in leaves], peak, start.elapsed_time(end)


def attn_flops(cfg, q, k, v) -> int:
    """FlopCounterMode's count of one forward of ``cfg``'s core."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.nn.attention import multi_head_attention

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        multi_head_attention(q, k, v, cfg)
    return fc.get_total_flops()


def attn_case(dev, gen, shape, grads):
    """Phase 22 (a)/(b)/(c) at ``shape``: chunked against einsum (outputs,
    with ``grads`` the q/k/v gradients too, FLOPs, peaks) and the flash
    kernel against chunked; returns the printed numbers."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.nn.attention import AttnCfg, multi_head_attention

    B, S, H, Kv, dh, window = shape
    q, ct = (torch.randn(B, S, H, dh, generator=gen, device=dev) for _ in range(2))
    k, v = (torch.randn(B, S, Kv, dh, generator=gen, device=dev) for _ in range(2))
    cfg = AttnCfg(n_heads=H, n_kv=Kv, d_head=dh, window=window, q_chunk=ATTN_CHUNKS[0],
                  kv_chunk=ATTN_CHUNKS[1])
    ein = dataclasses.replace(cfg, impl="einsum")
    res = {"flops": attn_flops(cfg, q, k, v), "flops_einsum": attn_flops(ein, q, k, v)}
    if grads:
        runs = {}
        for name, c in (("einsum", ein), ("chunked", cfg)):
            attn_pass(dev, c, q, k, v, ct)  # warm-up
            runs[name] = attn_pass(dev, c, q, k, v, ct)
        (o_e, g_e, res["peak_einsum"], res["ms_einsum"]), (o_c, g_c, res["peak"], res["ms"]) = (
            runs["einsum"], runs["chunked"])
        res["err"] = [max_err(a, b, ATTN_RTOL)[0] for a, b in zip([o_c] + g_c, [o_e] + g_e)]
        del runs, g_e, g_c
    else:
        with torch.no_grad():
            o_c = multi_head_attention(q, k, v, cfg)
            res["err"] = [max_err(o_c, multi_head_attention(q, k, v, ein), ATTN_RTOL)[0]]
    # (c) the flash kernel, forward, against the chunked path (a comparison:
    # its launches count on no main path)
    with torch.no_grad():
        res["flash_err"] = max_err(ops.flash_attention(q, k, v, causal=True, window=window),
                                   o_c, ATTN_RTOL)[0]
    del q, k, v, ct, o_c
    torch.cuda.empty_cache()
    return res


def yi_step(dev, cfg, policy, params, batch, opt):
    """A warm-up step, then one yi-6b training step, from a copy of
    ``params``: the second step's (loss, launches, peak bytes above the
    state, ms)."""
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.tree import tree_map

    st = init_state(0, cfg, opt, params=tree_map(lambda t: t.detach().clone(), params),
                    device=dev)
    fn = make_train_step(cfg, opt, policy, device=dev)
    st, _ = fn(st, batch, 21)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st, m = fn(st, batch, 22)
    loss = float(m["loss"])
    sync(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    del st, fn
    torch.cuda.empty_cache()
    return loss, counts, peak, ms


def yi_exact_grads(dev, cfg, params, batch):
    """Exact gradients of yi-6b's loss (a plain forward and backward)."""
    from repro_torch.models import lm
    from repro_torch.nn.common import Ctx
    from repro_torch.tree import tree_leaves, tree_map

    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, _ = lm.lm_loss(p, batch, Ctx(), cfg)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    del p
    return loss.detach(), grads


def chunked_attention(dev, gen):
    """Phase 22 (module docstring). Returns the launches of (d)'s and (e)'s
    steps."""
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.train_step import batch_to_device

    t_phase = time.perf_counter()
    # (a) + (c): yi-6b's geometry, forward and backward
    B, S, H, Kv, dh, _ = ATTN_YI
    a = attn_case(dev, gen, ATTN_YI, grads=True)
    score = 4 * B * H * S * S
    tile = 4 * B * H * ATTN_CHUNKS[0] * ATTN_CHUNKS[1]
    if a["flops"] != a["flops_einsum"]:
        raise AssertionError(f"[attn] (a) chunked forward FLOPs {a['flops']} != einsum's "
                             f"{a['flops_einsum']}")
    if not a["peak_einsum"] - a["peak"] >= score:
        raise AssertionError(f"[attn] (a) chunked peak {a['peak']} B is not below the "
                             f"einsum's {a['peak_einsum']} B by the {score} B score tensor")
    print(f"[attn] (a) yi-6b geometry (B {B}, S {S}, H {H}, Kv {Kv}, dh {dh}, causal, float32, "
          f"Cq {ATTN_CHUNKS[0]}, ck {ATTN_CHUNKS[1]}): chunked against einsum, max |err| "
          f"out {a['err'][0]:.3e}, dq {a['err'][1]:.3e}, dk {a['err'][2]:.3e}, dv "
          f"{a['err'][3]:.3e} (tol {ATTN_RTOL} of each's largest); forward FlopCounterMode "
          f"{a['flops']:,} = einsum's; peak of a forward and backward {a['peak']:,} B chunked, "
          f"{a['peak_einsum']:,} B einsum (score tensor {score:,} B, a tile {tile:,} B); "
          f"{a['ms']:.2f} ms chunked, {a['ms_einsum']:.2f} ms einsum ({smi_line()})")
    # (b) + (c): gemma3-1b's local layer, forward
    B, S, H, Kv, dh, W = ATTN_GEMMA
    b = attn_case(dev, gen, ATTN_GEMMA, grads=False)
    if b["flops"] * S != b["flops_einsum"] * (W + ATTN_CHUNKS[0]):
        raise AssertionError(f"[attn] (b) window FLOPs {b['flops']} are not (W + Cq) / S of "
                             f"the einsum's {b['flops_einsum']}")
    print(f"[attn] (b) gemma3-1b local layer (S {S}, H {H}, Kv {Kv}, dh {dh}, window {W}): "
          f"forward FLOPs {b['flops']:,} = ({W} + {ATTN_CHUNKS[0]}) / {S} of the einsum's "
          f"{b['flops_einsum']:,}; out max |err| {b['err'][0]:.3e} (tol {ATTN_RTOL})")
    print(f"[attn] (c) flash_attention against the chunked forward: yi-6b geometry max |err| "
          f"{a['flash_err']:.3e}, gemma3-1b local layer {b['flash_err']:.3e} (tol {ATTN_RTOL} "
          f"of the largest output)")
    # (d) yi-6b at full width, 2 layers, one pallas step per impl, and the
    # exact gradients of both impls
    cfg = f32_cfg("yi_6b", YI_LAYERS)
    if (cfg.q_chunk, cfg.kv_chunk, cfg.attn_impl) != (*ATTN_CHUNKS, "chunked"):
        raise AssertionError(f"[attn] yi-6b's config chunks {cfg.q_chunk}/{cfg.kv_chunk}, "
                             f"impl {cfg.attn_impl}")
    params = lm.init_params(22, cfg, device=dev)
    batch = batch_to_device(next(LMStream(vocab=cfg.vocab, seed=22).batches(1, YI_SEQ)), dev)
    sites = 7 * YI_LAYERS
    want = {name: (sites if name in SITE_KERNELS["pallas"] else 0) for name in ops.KERNELS}
    total, steps = {}, {}
    for impl in ("chunked", "einsum"):
        c = cfg.replace(attn_impl=impl)
        opt = adamw(cosine_warmup(3e-4, 2000, 100_000), weight_decay=0.1, clip=1.0)
        loss, counts, peak, ms = yi_step(dev, c, slice_policy(0.2), params, batch, opt)
        if counts != want:
            raise AssertionError(f"[attn] (d) yi-6b {impl} step launches {counts}, want {want}")
        if not math.isfinite(loss):
            raise AssertionError(f"[attn] (d) yi-6b {impl} step loss {loss}")
        add_counts(total, counts)
        steps[impl] = (loss, peak, ms)
    ops.reset_launch_counts()
    (l_c, g_c), (l_e, g_e) = (yi_exact_grads(dev, cfg.replace(attn_impl=i), params, batch)
                              for i in ("chunked", "einsum"))
    max_err(l_c, l_e, GRAD_RTOL)
    errs = [max_err(x, y, GRAD_RTOL)[0] / max(y.abs().max().item(), 1e-30)
            for x, y in zip(g_c, g_e)]
    if any(ops.launch_counts().values()):
        raise AssertionError("[attn] (d) an exact step launched a kernel")
    print(f"[attn] (d) yi-6b ({YI_LAYERS} of 32 layers, d 4096, GQA 32:4, batch 1 x {YI_SEQ}, "
          f"float32, pallas l1@0.2 block {BLOCK}, AdamW): "
          + "; ".join(f"{i} loss {steps[i][0]:.6f}, peak {steps[i][1] / 2**30:.3f} GiB, "
                      f"{steps[i][2]:.1f} ms for the step" for i in ("chunked", "einsum"))
          + f"; launches per step {want['col_l1_scores']} col_l1_scores + "
          f"{want['block_gather_matmul_fused']} block_gather_matmul_fused = {sites} sketched "
          f"sites; exact gradients chunked against einsum: loss {float(l_c):.6f} / "
          f"{float(l_e):.6f}, {len(errs)} leaves, largest max |err| {max(errs):.3e} of the "
          f"leaf's scale (tol {GRAD_RTOL}) ({smi_line()})")
    del params, batch, g_c, g_e
    torch.cuda.empty_cache()
    add_counts(total, lm100m_impls(dev))
    print(f"[time]   chunked attention {time.perf_counter() - t_phase:.1f} s")
    return total


# -- phase 23: the compact backends on split local-plan sites ----------------------

# yi-6b's mlp_in / mlp_out over 16 model ranks: d 4096, d_ff 11,008 (688 per
# rank, not a multiple of 128), N rows of float32
SPLIT_N, SPLIT_D, SPLIT_FF, SPLIT_RANKS = 2048, 4096, 11_008, 16
SPLIT_BUDGET = 0.1
# the shards' dX summed against the whole call's: each straddling block's
# product is summed in two parts (the CPU test's tolerance,
# tests/test_torch_split_compact.py)
SPLIT_DX_RTOL = 1e-5
# a one-pass shard's scores against the whole call's (the CPU test's)
SPLIT_SCORE_RTOL = 1e-6


class PlainTwin:
    """A backend's ``_kernel`` through the plain versions of its kernels, on
    the card: ``split_backward`` with it runs the same windows and slots as
    with the backend itself."""

    def __init__(self, backend):
        from repro_torch.core import estimators

        self.backend = backend
        self.refresh = estimators.get_estimator(backend).refresh

    def _kernel(self, cfg, G, idx, scales, w, X):
        from repro_torch.kernels import ref as kref

        d = w.shape[1]
        if self.backend == "onepass":
            dX, dWc, db, red = kref.block_stream_matmul_onepass_ref(G, idx, scales, w, X,
                                                                     block=cfg.block)
            return dX, dWc.reshape(-1, d), db.reshape(-1), red
        outs = kref.block_gather_matmul_fused_ref(G, idx, scales, w, X, block=cfg.block,
                                                  with_scores=self.backend == "stale")
        return (outs[0], outs[1].reshape(-1, d), outs[2].reshape(-1),
                outs[3].reshape(-1) if self.backend == "stale" else None)


def split_plan(cfg, scores, seed, dev):
    """The whole width's plan from column scores (the site's draw)."""
    from repro_torch import rng
    from repro_torch.core.sketching import column_plan_from_scores

    plan = column_plan_from_scores(cfg, scores, rng.generator(seed, dev))
    return plan.indices, plan.scales


def split_compact(dev, gen):
    """Phase 23 (module docstring). Returns the launches of the emulated
    ranks' parts."""
    from repro_torch.core import estimators
    from repro_torch.core.sketched_linear import split_backward
    from repro_torch.core.sketching import SketchConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    t_phase = time.perf_counter()
    N, D, F, M = SPLIT_N, SPLIT_D, SPLIT_FF, SPLIT_RANKS
    n_loc = F // M
    G = torch.randn((N, F), generator=gen, device=dev)
    G = G * torch.rand((F,), generator=gen, device=dev)  # uneven column scores
    X = torch.randn((N, D), generator=gen, device=dev)
    W = torch.randn((F, D), generator=gen, device=dev) * D ** -0.5
    # mlp_out: [d 4096, d_ff 11,008]; its G is [N, 4096], its input [N, 11,008]
    G_out = torch.randn((N, D), generator=gen, device=dev)
    X_out = torch.randn((N, F), generator=gen, device=dev)
    W_out = torch.randn((D, F), generator=gen, device=dev) * F ** -0.5
    total = {}
    for i, backend in enumerate(BACKENDS):
        est = estimators.get_estimator(backend)
        plain = PlainTwin(backend)
        cfg = SketchConfig(method="l1", budget=SPLIT_BUDGET, backend=backend, block=BLOCK)
        whole_scores = ops.col_l1_scores(G)
        idx, sc = split_plan(cfg, whole_scores, 230 + i, dev)
        idx_out, sc_out = split_plan(cfg, ops.col_l1_scores(G_out), 240 + i, dev)
        shards = [(k * n_loc, G[:, k * n_loc:(k + 1) * n_loc].contiguous(),
                   W[k * n_loc:(k + 1) * n_loc].contiguous()) for k in range(M)]
        chunks = [(X_out[:, k * n_loc:(k + 1) * n_loc].contiguous(),
                   W_out[:, k * n_loc:(k + 1) * n_loc].contiguous()) for k in range(M)]
        torch.cuda.synchronize()
        # the emulated ranks' parts, counted
        ops.reset_launch_counts()
        parts, part_scores, rows_out = [], [], []
        for lo, Gk, Wk in shards:
            if backend == "pallas":
                part_scores.append(ops.col_l1_scores(Gk))
            parts.append(split_backward(est, cfg, Gk, X, Wk, idx, sc, lo=lo, n=F))
        for Xk, Wk in chunks:
            if backend == "pallas":  # a row rank scores the whole G it holds
                ops.col_l1_scores(G_out)
            rows_out.append(est._kernel(cfg, G_out, idx_out, sc_out, Wk, Xk))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        kern = SITE_KERNELS[backend][-1]
        want = {name: 0 for name in counts}
        want[kern] = 2 * M
        if backend == "pallas":
            want["col_l1_scores"] = 2 * M
        if counts != want:
            raise AssertionError(f"[split] {backend} launches {counts}, want {want}")
        add_counts(total, counts)
        # each part against its plain twin (the same window and slots)
        errs = []
        for (lo, Gk, Wk), (out, red) in zip(shards, parts):
            p_out, p_red = split_backward(plain, cfg, Gk, X, Wk, idx, sc, lo=lo, n=F)
            errs += [max_err(out.dx, p_out.dx, TOL[torch.float32])[0],
                     max_err(out.rows, p_out.rows, TOL[torch.float32])[0],
                     max_err(out.db_c, p_out.db_c, TOL[torch.float32])[0]]
            if red is not None:
                errs.append(max_err(red, p_red, TOL[torch.float32])[0])
        for (Xk, Wk), got in zip(chunks, rows_out):
            want_p = plain._kernel(cfg, G_out, idx_out, sc_out, Wk, Xk)
            errs += [max_err(got[k], want_p[k], TOL[torch.float32])[0] for k in range(3)]
        for (_, Gk, _), s_k in zip(shards, part_scores):
            errs.append(max_err(s_k, kref.col_scores_ref(Gk), TOL[torch.float32])[0])
        # against the whole width's kernel call
        dX, rows, db, extra = est._kernel(cfg, G, idx, sc, W, X)
        cols = (idx[:, None] * BLOCK + torch.arange(BLOCK, device=dev)[None, :]).reshape(-1)
        dx_sum = torch.zeros_like(dX)
        kept_shards = 0
        for (lo, _, _), (out, red) in zip(shards, parts):
            mine = (cols >= lo) & (cols < lo + n_loc)
            kept_shards += bool(mine.any())
            if not (torch.equal(out.cols, cols) and torch.equal(out.rows[mine], rows[mine])
                    and torch.equal(out.db_c[mine], db[mine])
                    and not out.rows[~mine].any() and not out.db_c[~mine].any()):
                raise AssertionError(f"[split] {backend} shard at {lo}: rows or db differ "
                                     "from the whole width's call")
            dx_sum += out.dx
            if est.refresh == "all":
                max_err(red, extra[lo:lo + n_loc], SPLIT_SCORE_RTOL)
            elif est.refresh == "kept":
                full = torch.zeros(F, device=dev)
                full[cols] = extra
                if not torch.equal(red, full[lo:lo + n_loc]):
                    raise AssertionError(f"[split] {backend} shard at {lo}: kept scores differ")
        dx_err = max_err(dx_sum, dX, SPLIT_DX_RTOL)[0]
        dX_o, rows_o, db_o, _ = est._kernel(cfg, G_out, idx_out, sc_out, W_out, X_out)
        for k, (got_dx, got_rows, got_db, _) in enumerate(rows_out):
            c = slice(k * n_loc, (k + 1) * n_loc)
            if not (torch.equal(got_dx, dX_o[:, c]) and torch.equal(got_rows, rows_o[:, c])
                    and torch.equal(got_db, db_o)):
                raise AssertionError(f"[split] {backend} row shard {k}: not the whole call's "
                                     "chunk bit for bit")
        if not 0 < kept_shards < M:
            raise AssertionError(f"[split] {backend}: {kept_shards} of {M} shards keep a "
                                 "block; the phase wants some that keep none")
        ms_parts = sum(cuda_ms(lambda lo=lo, Gk=Gk, Wk=Wk: split_backward(
            est, cfg, Gk, X, Wk, idx, sc, lo=lo, n=F), iters=5) for lo, Gk, Wk in shards)
        ms_plain = sum(cuda_ms(lambda lo=lo, Gk=Gk, Wk=Wk: split_backward(
            plain, cfg, Gk, X, Wk, idx, sc, lo=lo, n=F), iters=5) for lo, Gk, Wk in shards)
        ms_whole = cuda_ms(lambda: est._kernel(cfg, G, idx, sc, W, X), iters=5)
        print(f"[split] {backend} mlp_in [{N}, {F}] x d {D} over {M} column shards of "
              f"{n_loc} (rb {idx.numel()} of {F // BLOCK} blocks, {kept_shards} shards keep "
              f"one): launches {counts}; every part within {TOL[torch.float32]} of its "
              f"plain twin (largest max |err| {max(errs):.3e}); rows and db of each shard "
              f"= the whole call's bit for bit, dX summed max |err| {dx_err:.3e} (tol "
              f"{SPLIT_DX_RTOL} of the largest); mlp_out row shards of d_in {n_loc} = the "
              f"whole call's chunks bit for bit; ms: the {M} parts {ms_parts:.3f}, their "
              f"plain twins {ms_plain:.3f}, the whole width's call {ms_whole:.3f} "
              f"({smi_line()})")
        del parts, rows_out, shards, chunks
    torch.cuda.empty_cache()
    print(f"[time]   split compact {time.perf_counter() - t_phase:.1f} s")
    return total


# -- phase 24: every sketch method on split local-plan sites -----------------------

# yi-6b's attn_q over 16 model ranks: d 4096 -> 4096, 256 columns per rank, N
# rows of float32 (phase 23's N and budget)
SM_N, SM_D, SM_RANKS = 2048, 4096, 16
SM_BUDGET = SPLIT_BUDGET
# (c): a narrow site (N, d_in, n) over an emulated (4, 4) mesh, column split;
# its draws: the fold rule's, one seed per draw
SM_NARROW, SM_MESH, SM_DRAWS = (256, 512, 512), (4, 4), 300
SM_SIGMAS = 4.0
# the mean of SM_DRAWS draws' summed per-entry variance against the analytic
# (i.i.d. Bernoulli) variance: a sum over >= 131,072 entries of 300-draw
# variance estimates, whose relative spread is far below this
SM_VAR_RTOL = 0.10
U32 = 2.0 ** -24  # float32's unit roundoff
# (b)'s limit on the shards' Ĝ against the whole call's, of max |Ĝ|: the CPU
# test's (test_rcs_shards_are_the_whole_call); the card read 1.1e-6 of it
# (PERF.md, PR 32), the rounding bound 2 (r + n) u max(|terms|) 3.7e-2
SM_RCS_RTOL = 1e-5


def sm_gsv(dev, G, X, W, total):
    """Phase 24 (a): the gsv ``pallas`` plan over the whole width and the 16
    column shards' parts of it; returns the parts' launches."""
    from repro_torch.core import estimators
    from repro_torch.core.scores import summed_column_scores
    from repro_torch.core.sketched_linear import split_backward
    from repro_torch.core.sketching import SketchConfig
    from repro_torch.kernels import ops

    n, M = G.shape[1], SM_RANKS
    n_loc = n // M
    est = estimators.get_estimator("pallas")
    plain = PlainTwin("pallas")
    cfg = SketchConfig(method="gsv", budget=SM_BUDGET, backend="pallas", block=BLOCK)
    # what every column rank computes from G's gathered columns (one data rank)
    scores = summed_column_scores("gsv", G, None, lambda t: t)
    idx, sc = split_plan(cfg, scores, 250, dev)
    shards = [(k * n_loc, G[:, k * n_loc:(k + 1) * n_loc].contiguous(),
               W[k * n_loc:(k + 1) * n_loc].contiguous()) for k in range(M)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    parts = [split_backward(est, cfg, Gk, X, Wk, idx, sc, lo=lo, n=n)[0]
             for lo, Gk, Wk in shards]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {name: 0 for name in counts}
    want["block_gather_matmul_fused"] = M
    if counts != want:
        raise AssertionError(f"[split-methods] (a) gsv launches {counts}, want {want}")
    add_counts(total, counts)
    errs = []
    for (lo, Gk, Wk), out in zip(shards, parts):
        p_out, _ = split_backward(plain, cfg, Gk, X, Wk, idx, sc, lo=lo, n=n)
        errs += [max_err(out.dx, p_out.dx, TOL[torch.float32])[0],
                 max_err(out.rows, p_out.rows, TOL[torch.float32])[0]]
    dX, rows, db, _ = est._kernel(cfg, G, idx, sc, W, X)
    cols = (idx[:, None] * BLOCK + torch.arange(BLOCK, device=dev)[None, :]).reshape(-1)
    dx_sum = torch.zeros_like(dX)
    for (lo, _, _), out in zip(shards, parts):
        mine = (cols >= lo) & (cols < lo + n_loc)
        if not (torch.equal(out.cols, cols) and torch.equal(out.rows[mine], rows[mine])
                and torch.equal(out.db_c[mine], db[mine]) and not out.rows[~mine].any()):
            raise AssertionError(f"[split-methods] (a) gsv shard at {lo}: rows differ from "
                                 "the whole width's call")
        dx_sum += out.dx
    dx_err = max_err(dx_sum, dX, SPLIT_DX_RTOL)[0]
    ms_parts = sum(cuda_ms(lambda lo=lo, Gk=Gk, Wk=Wk: split_backward(
        est, cfg, Gk, X, Wk, idx, sc, lo=lo, n=n), iters=5) for lo, Gk, Wk in shards)
    ms_whole = cuda_ms(lambda: est._kernel(cfg, G, idx, sc, W, X), iters=5)
    print(f"[split-methods] (a) gsv pallas block {BLOCK} at {SM_BUDGET}, attn_q [{SM_N}, {n}] x "
          f"d {SM_D} over {M} column shards of {n_loc}: the whole width's scores from G's "
          f"gathered columns, rb {idx.numel()} of {n // BLOCK} blocks; launches {counts}; "
          f"every part within {TOL[torch.float32]} of its plain twin (largest max |err| "
          f"{max(errs):.3e}); rows of each shard = the whole call's bit for bit, dX summed "
          f"max |err| {dx_err:.3e} (tol {SPLIT_DX_RTOL} of the largest); ms: the {M} parts "
          f"{ms_parts:.3f}, the whole call {ms_whole:.3f} ({smi_line()})")


def sm_rcs(dev, G, W):
    """Phase 24 (b): the rcs plan of the whole batch and width and each
    column shard's columns of Ĝ against the whole call's."""
    from repro_torch import rng
    from repro_torch.core import solver
    from repro_torch.core.sketching import SketchConfig, apply_rcs_directions, rcs_plan_from

    N, n = G.shape
    M, n_loc = SM_RANKS, G.shape[1] // SM_RANKS
    cfg = SketchConfig(method="rcs", budget=SM_BUDGET)
    t0 = time.perf_counter()
    # every rank's plan inputs: Γ of the whole batch (one data rank) and W Wᵀ
    # of W's gathered rows: the same bits on every rank
    plan = rcs_plan_from(cfg, (G.T @ G) / N, W @ W.T)
    idx = solver.sample_exact_r(rng.generator(260, dev), plan.probs, plan.r)
    whole = apply_rcs_directions(G, plan, idx)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    got = torch.cat([apply_rcs_directions(G, plan, idx, lo=k * n_loc, n_loc=n_loc)
                     for k in range(M)], dim=1)
    # a shard's columns change two products' output widths: T = U_selᵀ Γ^½
    # (sums over n) and A T (sums over the r kept directions), A = G Γ^-½
    # U_sel / p_sel. Any order of a sum of K terms errs by at most (K - 1) u
    # of the sum of their magnitudes (u = 2^-24), so the two calls differ by
    # at most 2 (r + n) u max(|A| |U_sel|ᵀ |Γ^½|)
    U_sel = plan.U[:, idx]
    A = (G @ (plan.inv_half @ U_sel)) / plan.probs[idx].clamp_min(1e-20)[None, :]
    mag = (A.abs() @ (U_sel.abs().T @ plan.half.abs())).max().item()
    err = (got - whole).abs().max().item()
    bound_ = 2 * (plan.r + n) * U32 * mag
    top = whole.abs().max().item()
    tol = SM_RCS_RTOL * top
    if not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"[split-methods] (b) rcs shards' Ĝ max |err| {err:.3e} > tol "
                             f"{tol:.3e} ({SM_RCS_RTOL} of max |Ĝ| {top:.4g})")
    print(f"[split-methods] (b) rcs mask at {SM_BUDGET}, [{N}, {n}] x d {SM_D} over {M} column "
          f"shards: one plan from Γ and W Wᵀ of the whole batch and width (r {plan.r}; "
          f"plan and whole Ĝ {t_plan:.2f} s); the shards' columns of Ĝ against the whole "
          f"call's max |err| {err:.3e} = {err / top:.3e} of max |Ĝ| {top:.4g} (tol "
          f"{SM_RCS_RTOL} of it: {tol:.3e}; the rounding bound 2 (r + n) 2^-24 x {mag:.4g}, "
          f"the largest sum of |terms|: {bound_:.3e})")


def sm_drawn(dev):
    """Phase 24 (c): per_element and per_sample over an emulated (4, 4) mesh
    by the fold rule, SM_DRAWS draws, against the exact dX and dW."""
    from repro_torch import rng
    from repro_torch.core.sketched_linear import per_element
    from repro_torch.core.sketching import SketchConfig, row_gate

    N, d, n = SM_NARROW
    n_dp, n_mp = SM_MESH
    g = torch.Generator(device=dev)
    g.manual_seed(270)
    G = torch.randn((N, n), generator=g, device=dev)
    X = torch.randn((N, d), generator=g, device=dev)
    W = torch.randn((n, d), generator=g, device=dev) * d ** -0.5
    rows = [slice(i * N // n_dp, (i + 1) * N // n_dp) for i in range(n_dp)]
    cols = [slice(k * n // n_mp, (k + 1) * n // n_mp) for k in range(n_mp)]
    exact = (G.double() @ W.double(), G.double().T @ X.double())
    proj = [torch.randint(0, 2, e.shape, generator=g, device=dev).double() * 2 - 1
            for e in exact]
    lines = []
    for method in ("per_element", "per_sample"):
        cfg = SketchConfig(method=method, budget=0.5)
        p = cfg.budget
        t0 = time.perf_counter()
        s1 = [torch.zeros(e.shape, dtype=torch.float64, device=dev) for e in exact]
        s2 = [torch.zeros_like(a) for a in s1]
        dots = [[], [], [], []]  # (dX, dW) x (exact direction, random signs)
        for draw in range(SM_DRAWS):
            dX, dW = torch.zeros_like(X), torch.zeros_like(W)
            for i, rs in enumerate(rows):
                for k, c in enumerate(cols):
                    gk = rng.generator(280 + draw, dev)
                    if method == "per_element":
                        out = per_element(cfg, G[rs, c], X[rs], W[c], gk, has_b=False,
                                          w_folds=(k,), x_folds=(i,))
                        dx, dw = out.dx, out.dw
                    else:
                        Gh = G[rs, c] * row_gate(cfg, rs.stop - rs.start, gk, dev, (i,))[:, None]
                        dx, dw = Gh @ W[c], Gh.T @ X[rs]
                    dX[rs] += dx
                    dW[c] += dw
            for j, t in enumerate((dX.double(), dW.double())):
                s1[j] += t
                s2[j] += t * t
                dots[2 * j].append((t * exact[j]).sum() / exact[j].norm())
                dots[2 * j + 1].append((t * proj[j]).sum())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        f = (1 - p) / p
        G2, X2, W2 = G.double() ** 2, X.double() ** 2, W.double() ** 2
        var = ((f * G2 @ W2).sum() if method == "per_element"
               else (f * (G.double() @ W.double()) ** 2).sum(), (f * G2.T @ X2).sum())
        worst_t, ratios = 0.0, []
        for j, name in enumerate(("dX", "dW")):
            for q, ref in ((2 * j, (exact[j] * exact[j]).sum() / exact[j].norm()),
                           (2 * j + 1, (exact[j] * proj[j]).sum())):
                v = torch.stack(dots[q])
                t = ((v.mean() - ref).abs() / (v.std() / SM_DRAWS ** 0.5)).item()
                worst_t = max(worst_t, t)
                if not t <= SM_SIGMAS:
                    raise AssertionError(f"[split-methods] (c) {method} {name}: the mean of "
                                         f"{SM_DRAWS} mesh draws is {t:.2f} sigma from exact")
            mean = s1[j] / SM_DRAWS
            tot = ((s2[j] / SM_DRAWS - mean * mean) * SM_DRAWS / (SM_DRAWS - 1)).sum().item()
            ratios.append(tot / var[j].item())
            if not abs(ratios[-1] - 1) <= SM_VAR_RTOL:
                raise AssertionError(f"[split-methods] (c) {method} {name}: summed variance "
                                     f"{ratios[-1]:.4f} x the analytic")
        lines.append(f"{method} largest |mean - exact| {worst_t:.2f} sigma (limit "
                     f"{SM_SIGMAS:g}), summed variance dX / dW {ratios[0]:.4f} / "
                     f"{ratios[1]:.4f} x the analytic ({secs:.1f} s)")
    print(f"[split-methods] (c) [{N}, {n}] x d {d}, budget 0.5, an emulated {SM_MESH} mesh, "
          f"column split, {SM_DRAWS} draws by the fold rule (W masks folded by the model rank, "
          f"X masks and row gates by the data rank), projected on the exact gradient and on "
          f"random signs: " + "; ".join(lines))


def split_methods(dev, gen):
    """Phase 24 (module docstring). Returns the launches of the emulated
    ranks' parts."""
    t_phase = time.perf_counter()
    N, D = SM_N, SM_D
    G = torch.randn((N, D), generator=gen, device=dev)
    G = G * torch.rand((D,), generator=gen, device=dev)  # uneven column scores
    X = torch.randn((N, D), generator=gen, device=dev)
    W = torch.randn((D, D), generator=gen, device=dev) * D ** -0.5
    total = {}
    sm_gsv(dev, G, X, W, total)
    sm_rcs(dev, G, W)
    del G, X, W
    torch.cuda.empty_cache()
    sm_drawn(dev)
    print(f"[time]   split methods {time.perf_counter() - t_phase:.1f} s")
    return total


def lm100m_impls(dev):
    """Phase 22 (e): lm-100m's main-path step (block-128 l1@0.2 ``pallas``,
    AdamW, remat "full", 8 x 256) with the chunked and the einsum attention,
    ``LM_IMPL_REPS`` synced steps each after a warm-up, the impls
    interleaved (chunked, einsum, einsum, chunked, ...), each step's
    launches 84 + 84. Returns the timed steps' launches."""
    from repro_torch.data.synthetic import LMStream
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train.train_step import batch_to_device, init_state, make_train_step
    from repro_torch.tree import tree_map

    cfg = lm100m()
    params = lm.init_params(22, cfg, device=dev)
    batch = batch_to_device(next(LMStream(vocab=cfg.vocab, seed=22).batches(BATCH, SEQ)), dev)
    runs = {}
    for impl in ("chunked", "einsum"):
        c = cfg.replace(attn_impl=impl)
        opt = adamw(cosine_warmup(3e-4, 2000, 100_000), weight_decay=0.1, clip=1.0)
        st = init_state(0, c, opt, params=tree_map(lambda t: t.detach().clone(), params),
                        device=dev)
        fn = make_train_step(c, opt, slice_policy(0.2), device=dev)
        st, _ = fn(st, batch, 21)  # warm-up
        runs[impl] = [fn, st, []]
    want = expected_counts("pallas", 1)
    total = {}
    order = [("chunked", "einsum")[(i + i // 2) % 2] for i in range(2 * LM_IMPL_REPS)]
    for i, impl in enumerate(order):
        fn, st, ms = runs[impl]
        sync(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        st, m = fn(st, batch, 30 + i)
        float(m["loss"])
        sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        counts = ops.launch_counts()
        if counts != want:
            raise AssertionError(f"[attn] (e) lm-100m {impl} step launches {counts}, want {want}")
        add_counts(total, counts)
        runs[impl][1] = st
    med = {k: float(np.median(v[2])) for k, v in runs.items()}
    print(f"[attn] (e) lm-100m main-path step (pallas l1@0.2 block {BLOCK}, AdamW, remat full, "
          f"{BATCH} x {SEQ}, q_chunk {cfg.q_chunk}, kv_chunk {cfg.kv_chunk}), ms per synced "
          f"step in the order {' '.join(o[0] for o in order)}: chunked "
          f"{[round(x, 2) for x in runs['chunked'][2]]} (median {med['chunked']:.2f}), einsum "
          f"{[round(x, 2) for x in runs['einsum'][2]]} (median {med['einsum']:.2f}); 84 + 84 "
          f"launches each ({smi_line()})")
    del runs
    torch.cuda.empty_cache()
    return total


# -- phase 25: Mamba2's block split over emulated model ranks -------------------------

# zamba2-7b's Mamba2 block at full width over 16 emulated model ranks: d_model
# 3584, d_inner 7168, 112 heads of 64 (7 a rank: a 448-channel shard of
# ssm_in, 3.5 blocks of 128), state 64, chunk 256, phase 14's batch 4 x 512
MS_D, MS_HEADS, MS_P, MS_N, MS_CHUNK = 3584, 112, 64, 64, 256
MS_B, MS_S, MS_RANKS, MS_BUDGET = 4, 512, 16, 0.2
# the shards' output summed against the whole block's, of its largest
# magnitude. The float64 witness (PERF.md §7, PR 33; CPU gloo, zamba2 smoke,
# tests/test_torch_distributed_compact.py) found the split no farther from a
# float64 step than the gathered path (logits 2.2e-5 / 1.8e-5 against 2.4e-5,
# gradients 2.8e-4 / 3.0e-4 against 3.2e-4 on (2, 2) / (1, 4)): the split
# adds the reordering of the sums it splits and nothing else. One block's
# output reorders two sums of d_inner terms (the norm's squares and the out
# projection's products, each as 16 partial sums), so it is held to their
# rounding bound, sum_tol(7168) = max(1e-5, sqrt(7168) 2^-24) = 1e-5
MS_OUT_RTOL = sum_tol(2 * MS_D)
MS_LIMIT_S = 20.0


def ms_policy():
    """pallas l1@0.2 block 128 on ssm_in and ssm_out only."""
    from repro_torch.api import SketchConfig, SketchPolicy
    from repro_torch.core.policy import ROLES

    return SketchPolicy(base=SketchConfig(method="l1", budget=MS_BUDGET, backend="pallas",
                                          block=BLOCK),
                        exclude_roles=tuple(r for r in ROLES if r not in ("ssm_in", "ssm_out")))


def ms_emulated(params, x, gout, cfg, ctx):
    """The block as MS_RANKS model ranks run it, on the card: each rank's
    ``mamba_heads`` on its 7 heads and norm (the sum of squares summed over
    the ranks here), its row shard of ``out``; the backward site by site as
    the ranks run it: each row rank scores the whole G of ``out`` and runs
    the fused kernel on its d_in chunk, each column rank scores its columns
    of ``in_z``/``in_x`` (the whole width's scores put together, as the mesh
    all-gathers them) and runs its part of the whole plan
    (``split_backward``). Returns (output, dX, per site the ranks' compact
    rows, the whole-width kernel call's rows and the plans' kept blocks)."""
    import torch.nn.functional as F

    from repro_torch.core import estimators
    from repro_torch.core.sketched_linear import split_backward
    from repro_torch.kernels import ops
    from repro_torch.nn import ssm

    H, P, M = cfg.n_heads, cfg.head_dim, MS_RANKS
    n, c = H // M, (H // M) * P
    sk = ms_policy().base
    est = estimators.get_estimator("pallas")
    x2 = x.reshape(-1, cfg.d_model)
    small = {k: F.linear(x, params[k]["w"]).requires_grad_() for k in ("in_B", "in_C", "in_dt")}
    shards = []
    for k in range(M):
        cols = slice(k * c, (k + 1) * c)
        z = F.linear(x, params["in_z"]["w"][cols]).requires_grad_()
        xs = F.linear(x, params["in_x"]["w"][cols]).requires_grad_()
        leaves = ssm.head_leaves(params, k * n, n, P)
        y, _, _ = ssm.mamba_heads(leaves, z, xs, small["in_B"], small["in_C"],
                                  small["in_dt"][..., k * n:(k + 1) * n], cfg, x.dtype)
        shards.append(dict(cols=cols, z=z, xs=xs, y=y, g=leaves["g"]))
    ss = sum(ssm.sum_squares(s["y"]) for s in shards)
    for s in shards:
        s["yn"] = ssm.shard_rmsnorm(s["y"], s["g"], ss, cfg.d_inner)
    out = sum(F.linear(s["yn"].detach(), params["out"]["w"][:, s["cols"]]) for s in shards)
    G_out = gout.reshape(-1, cfg.d_model)
    res = {"out": {"rows": []}, "in_z": {"rows": []}, "in_x": {"rows": []}}
    dyn = []
    for s in shards:  # the row ranks of out
        idx, sc = split_plan(sk, ops.col_l1_scores(G_out), ctx.site_seed("ssm_out"), x.device)
        w_k = params["out"]["w"][:, s["cols"]]
        dx, rows, _, _ = est._kernel(sk, G_out, idx, sc, w_k, s["yn"].detach().reshape(-1, c))
        res["out"]["rows"].append(rows)
        dyn.append(dx.reshape(s["yn"].shape))
    res["out"].update(plan=idx, sc=sc)
    inputs = [t for s in shards for t in (s["z"], s["xs"])] + list(small.values())
    grads = torch.autograd.grad([s["yn"] for s in shards], inputs, dyn)
    dX = sum(g.reshape(-1, g.shape[-1]) @ params[k]["w"]
             for g, k in zip(grads[2 * M:], small))
    for j, name in enumerate(("in_z", "in_x")):
        Gs = [grads[2 * k + j].reshape(-1, c) for k in range(M)]
        scores = torch.cat([ops.col_l1_scores(G) for G in Gs])  # the ranks' all-gather
        idx, sc = split_plan(sk, scores, ctx.site_seed("ssm_in"), x.device)
        for k, G_k in enumerate(Gs):
            part, _ = split_backward(est, sk, G_k, x2, params[name]["w"][k * c:(k + 1) * c],
                                     idx, sc, lo=k * c, n=cfg.d_inner)
            dX = dX + part.dx
            res[name]["rows"].append(part.rows)
        res[name].update(plan=idx, G=torch.cat(Gs, 1), sc=sc)
    res["out"]["X"] = torch.cat([s["yn"].detach().reshape(-1, c) for s in shards], 1)
    return out.detach(), dX.reshape(x.shape), res


def mamba_split(dev, gen):
    """Phase 25 (module docstring). Returns the emulated ranks' launches."""
    from repro_torch.core import estimators
    from repro_torch.kernels import ops
    from repro_torch.nn import ssm
    from repro_torch.nn.common import Ctx

    t_phase = time.perf_counter()
    cfg = ssm.MambaCfg(d_model=MS_D, d_state=MS_N, expand=2, head_dim=MS_P, chunk=MS_CHUNK)
    assert cfg.n_heads == MS_HEADS and cfg.n_heads % MS_RANKS == 0
    params = ssm.mamba_init(gen, cfg, device=dev)
    x = torch.randn((MS_B, MS_S, MS_D), generator=gen, device=dev)
    gout = torch.randn((MS_B, MS_S, MS_D), generator=gen, device=dev)
    ctx = Ctx(policy=ms_policy(), key=25)
    # the whole block: one call of the port's training path, after a warm-up
    # call (the first also pays the library handles' set-up)
    warm = x.clone().requires_grad_()
    ssm.mamba_block(params, warm, ctx, cfg).backward(gout)
    del warm
    xg = x.clone().requires_grad_()
    sync(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    want_out = ssm.mamba_block(params, xg, ctx, cfg)
    want_out.backward(gout)
    sync(dev)
    ms_whole = 1e3 * (time.perf_counter() - t0)
    whole_counts = ops.launch_counts()
    want_whole = {name: 0 for name in whole_counts}
    want_whole.update(col_l1_scores=3, block_gather_matmul_fused=3)
    if whole_counts != want_whole:
        raise AssertionError(f"[mamba-split] the whole block launched {whole_counts}, "
                             f"want {want_whole}")
    # the emulated ranks, counted
    sync(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, dX, res = ms_emulated(params, x, gout, cfg, ctx)
    sync(dev)
    ms_ranks = 1e3 * (time.perf_counter() - t0)
    counts = ops.launch_counts()
    want = {name: 0 for name in counts}
    want.update(col_l1_scores=3 * MS_RANKS, block_gather_matmul_fused=3 * MS_RANKS)
    if counts != want:
        raise AssertionError(f"[mamba-split] the {MS_RANKS} ranks launched {counts}, want {want}")
    out_err = max_err(out, want_out.detach(), MS_OUT_RTOL)
    dx_err = max_err(dX, xg.grad, SPLIT_DX_RTOL)
    # each rank's compact rows against the whole-width kernel call's
    est = estimators.get_estimator("pallas")
    sk = ms_policy().base
    c = cfg.d_inner // MS_RANKS
    x2 = x.reshape(-1, MS_D)
    kept = {}
    for name in ("in_z", "in_x"):
        r = res[name]
        whole = est._kernel(sk, r["G"], r["plan"], r["sc"], params[name]["w"], x2)[1]
        total = torch.zeros_like(whole)
        for k, part in enumerate(r["rows"]):
            mine = part.abs().sum(1) > 0
            if not torch.equal(part[mine], whole[mine]):
                raise AssertionError(f"[mamba-split] {name} rank {k}: rows differ from the "
                                     "whole call's")
            total += part
        if not torch.equal(total, whole):
            raise AssertionError(f"[mamba-split] {name}: the ranks' rows do not make the whole "
                                 "call's")
        kept[name] = r["plan"].numel()
    r = res["out"]
    whole = est._kernel(sk, gout.reshape(-1, MS_D), r["plan"], r["sc"], params["out"]["w"],
                        r["X"])[1]
    for k, part in enumerate(r["rows"]):
        if not torch.equal(part, whole[:, k * c:(k + 1) * c]):
            raise AssertionError(f"[mamba-split] out rank {k}: rows are not the whole call's "
                                 "d_in chunk")
    kept["out"] = r["plan"].numel()
    if not torch.isfinite(out).all() or not torch.isfinite(dX).all():
        raise AssertionError("[mamba-split] non-finite output or dX")
    secs = time.perf_counter() - t_phase
    print(f"[mamba-split] zamba2-7b Mamba2 block d {MS_D} -> d_inner {cfg.d_inner}, "
          f"{MS_HEADS} heads of {MS_P}, state {MS_N}, chunk {MS_CHUNK}, {MS_B} x {MS_S} "
          f"float32, pallas l1@{MS_BUDGET} block {BLOCK} on ssm_in/ssm_out, over {MS_RANKS} "
          f"emulated model ranks of {MS_HEADS // MS_RANKS} heads ({c} channels): kept blocks "
          f"{kept} (in_z/in_x of {cfg.d_inner // BLOCK}, out of {MS_D // BLOCK}); the whole "
          f"block launched {whole_counts}, the ranks {counts}; output summed max |err| "
          f"{out_err[0]:.3e} (tol {out_err[1]:.3e}, {MS_OUT_RTOL:.3g} of the largest), dX "
          f"summed {dx_err[0]:.3e} (tol {dx_err[1]:.3e}); every rank's compact rows the whole "
          f"call's bit for bit; ms: whole block forward + backward {ms_whole:.1f} (warm), the "
          f"ranks' forward + backward {ms_ranks:.1f} ({smi_line()})")
    if secs > MS_LIMIT_S:
        raise AssertionError(f"[mamba-split] the phase took {secs:.1f} s (limit {MS_LIMIT_S})")
    del params, res, out, dX, xg, want_out
    torch.cuda.empty_cache()
    print(f"[time]   mamba split {secs:.1f} s")
    return counts


# -- phase 26: the vocabulary-parallel head and loss over emulated model ranks -------

# the heads of the two configs whose train_4k the vocabulary-parallel layout
# brings onto the card: (name, vocabulary, d_model, tied); 16 model ranks,
# a 2 x 4096 batch of float32 (TF32 off)
VH_CASES = (("gemma3-1b", 262_144, 1_152, True), ("seamless-m4t-large-v2", 256_206, 1_024, False))
VH_RANKS, VH_B, VH_S, VH_SEED = 16, 2, 4096, 26
# the 16 chunks' summed nll (its mean) against the whole vocabulary's on one
# device, relative; the gradients (dX and the head weight's, assembled from
# the chunks) within this share of their largest magnitude. The reference is
# the whole vocabulary's in float64 (:func:`vh_reference`): a float32 dX
# reduces all V rows at once, and its rounding (sum_tol(V), 3.05e-5 of the
# largest at 262,144) is above these tolerances; its departure from the
# float64 reference is printed beside
VH_LOSS_RTOL = 1e-5
VH_GRAD_RTOL = 1e-5
VH_REF_ROWS = 32_768  # vocabulary rows per slice of the float64 reference
# one emulated rank's head + loss, forward and backward, on the card against
# the dry run's fake-tensor accounting of the same call (phase 21's bound)
VH_PEAK_RTOL = 0.05
VH_LIMIT_S = 15.0


def vh_chunk(x, w_r, labels, lo, m=None):
    """One model rank's head and loss terms: the product of ``x`` (whole,
    as ``models.lm._mesh_head`` takes it) with the rank's vocabulary rows
    ``w_r``, as float32 logits, and ``models.lm.vocab_chunk_terms`` at the
    rank's first vocabulary index ``lo`` against the maximum ``m`` (the
    ranks' ``pmax``; None: this chunk's own, a one-rank call)."""
    from repro_torch.models.lm import vocab_chunk_terms

    lg = torch.matmul(x, w_r.t()).to(torch.float32)
    if m is None:
        m = lg.detach().amax(-1)
    return lg, m, vocab_chunk_terms(lg, labels, lo, m)


def vh_one_rank(x, w_r, labels, lo):
    """One rank's head and loss, forward and backward: (dX part, dW rows)."""
    _, m, (se, t) = vh_chunk(x, w_r, labels, lo)
    loss = (torch.log(se) + m - t).mean()
    return torch.autograd.grad(loss, (x, w_r))


def vh_emulated(x, w, labels):
    """The head and loss as VH_RANKS model ranks run them: each rank's rows
    of ``w`` (what the tied table's all-to-all or the replicated weight's
    slice gives it, ``launch.mesh.chunk_bounds``' chunks), its chunk of the
    logits, the maximum over the ranks (``pmax``), each rank's terms summed
    over the ranks (``reduce_from``): the mean nll, whose backward reaches
    ``x`` summed over the ranks (``copy_to``) and ``w`` assembled from the
    ranks' rows (the inverse all-to-all, or the gather of the rows)."""
    from repro_torch.launch.mesh import chunk_bounds
    from repro_torch.models.lm import vocab_chunk_terms

    V = w.shape[0]
    chunks = [chunk_bounds(V, VH_RANKS, r) for r in range(VH_RANKS)]
    lgs = [torch.matmul(x, w[lo:lo + n].t()).to(torch.float32) for lo, n in chunks]
    m = torch.stack([lg.detach().amax(-1) for lg in lgs]).amax(0)
    terms = [vocab_chunk_terms(lg, labels, lo, m) for lg, (lo, _) in zip(lgs, chunks)]
    se = sum(t[0] for t in terms)
    t = sum(t[1] for t in terms)
    return (torch.log(se) + m - t).mean(), chunks


def vh_whole(x, w, labels):
    """The whole-vocabulary head and loss on one device (``lm_loss``'s)."""
    lg = torch.matmul(x, w.t()).to(torch.float32)
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, labels[..., None].long())[..., 0]
    return nll.mean()


def vh_reference(x, w, labels):
    """The whole vocabulary's mean nll, dX and dW in float64 on one device:
    the log-sum-exp over every row of ``w`` (running max and sum over slices
    of VH_REF_ROWS rows, which bound the memory), then the analytic
    gradient ``(softmax - onehot) / N`` slice by slice."""
    d = x.shape[-1]
    x64, w64 = x.detach().double().reshape(-1, d), w.detach().double()
    lab = labels.reshape(-1).long()
    N, V = x64.shape[0], w64.shape[0]
    m = torch.full((N,), -math.inf, dtype=torch.float64, device=x.device)
    se = torch.zeros(N, dtype=torch.float64, device=x.device)
    for lo in range(0, V, VH_REF_ROWS):
        lg = x64 @ w64[lo:lo + VH_REF_ROWS].t()
        mn = torch.maximum(m, lg.amax(-1))
        se = se * torch.exp(m - mn) + torch.exp(lg - mn[:, None]).sum(-1)
        m = mn
    lse = m + torch.log(se)
    loss = (lse - (x64 * w64[lab]).sum(-1)).mean()
    rows = torch.arange(N, device=x.device)
    dX = torch.zeros_like(x64)
    dW = torch.empty_like(w64)
    for lo in range(0, V, VH_REF_ROWS):
        wl = w64[lo:lo + VH_REF_ROWS]
        G = torch.exp(x64 @ wl.t() - lse[:, None])
        mine = (lab >= lo) & (lab < lo + wl.shape[0])
        G[rows[mine], lab[mine] - lo] -= 1.0
        G /= N
        dX += G @ wl
        dW[lo:lo + wl.shape[0]] = G.t() @ x64
    return float(loss), dX.reshape(x.shape), dW


def vh_dry_peaks():
    """The dry run's fake-tensor accounting (``launch.dryrun.count_run``,
    the inputs resident) of rank 0's head + loss (:func:`vh_one_rank`) for
    each head of VH_CASES: {name: {"peak_bytes", "flops"}}. No card: the dry
    run's child runs it (its first fake-tensor mode costs ~10 s of set-up)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.input_specs import fake_mode
    from repro_torch.launch.mesh import chunk_bounds

    out = {}
    for name, V, d, _ in VH_CASES:
        lo, n = chunk_bounds(V, VH_RANKS, 0)
        with fake_mode():
            fx = torch.empty((VH_B, VH_S, d)).requires_grad_(True)
            fw = torch.empty((n, d)).requires_grad_(True)
            fl = torch.empty((VH_B, VH_S), dtype=torch.int64)
            _, c = dryrun.count_run(lambda: vh_one_rank(fx, fw, fl, lo), (fx, fw, fl))
        out[name] = {"peak_bytes": c["peak_bytes"], "flops": c["flops"]}
    return out


def vh_peak(dev, x, w, labels, lo, n):
    """Rank 0's head + loss (:func:`vh_one_rank`) on the card: the peak of
    allocated bytes above what was allocated before its inputs, after a
    warm-up call."""
    import gc

    def inputs(device):
        return (x.detach().to(device).clone().requires_grad_(True),
                w[lo:lo + n].detach().to(device).clone().requires_grad_(True),
                labels.to(device).clone())

    vh_one_rank(*inputs(dev), lo)  # warm-up: the library's handles and workspaces
    gc.collect()
    sync(dev)
    base = torch.cuda.memory_allocated(dev)
    xr, wr, lr = inputs(dev)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    vh_one_rank(xr, wr, lr, lo)
    sync(dev)
    return torch.cuda.max_memory_allocated(dev) - base


def vh_err(name, what, got, want) -> tuple:
    """(max |got - want|, the tolerance VH_GRAD_RTOL of max |want|), in
    float64; raises past the tolerance."""
    err = (got.double() - want).abs().max().item()
    tol = VH_GRAD_RTOL * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"[vocab-head] {name}: the chunks' {what} max|err| {err:.3e} > "
                             f"tol {tol:.3e}")
    return err, tol


def vh_case(dev, gen, dry, name, V, d, tied):
    """Phase 26 for one head (module docstring): returns the printed line's
    numbers."""
    from repro_torch.launch.mesh import chunk_bounds

    x = torch.randn((VH_B, VH_S, d), generator=gen, device=dev)
    w = torch.randn((V, d), generator=gen, device=dev) * d ** -0.5
    labels = torch.randint(0, V, (VH_B, VH_S), generator=gen, device=dev)
    t0 = time.perf_counter()
    want = vh_reference(x, w, labels)
    sync(dev)
    s_ref = time.perf_counter() - t0
    # the whole vocabulary on one device in float32, after a warm-up call
    for _ in range(2):
        xw, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        sync(dev)
        t0 = time.perf_counter()
        loss_w = vh_whole(xw, ww, labels)
        loss_w.backward()
        sync(dev)
        ms_whole = 1e3 * (time.perf_counter() - t0)
    whole = (abs(float(loss_w.detach()) - want[0]) / abs(want[0]),
             (xw.grad - want[1]).abs().max().item() / want[1].abs().max().item(),
             (ww.grad - want[2]).abs().max().item() / want[2].abs().max().item())
    del xw, ww, loss_w
    torch.cuda.empty_cache()
    # the 16 emulated ranks
    xe, we = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    sync(dev)
    t0 = time.perf_counter()
    loss_e, chunks = vh_emulated(xe, we, labels)
    loss_e.backward()
    sync(dev)
    ms_ranks = 1e3 * (time.perf_counter() - t0)
    loss_rel = abs(float(loss_e.detach()) - want[0]) / abs(want[0])
    if not loss_rel <= VH_LOSS_RTOL:
        raise AssertionError(f"[vocab-head] {name}: the chunks' loss {float(loss_e.detach())!r} against "
                             f"the whole vocabulary's {want[0]!r} ({loss_rel:.3e} > "
                             f"{VH_LOSS_RTOL})")
    dx_err = vh_err(name, "dX", xe.grad, want[1])
    dw_err = vh_err(name, "dW", we.grad, want[2])
    lens = sorted({n for _, n in chunks})
    del xe, we, loss_e, want
    torch.cuda.empty_cache()
    # one rank's call, timed, and its peak against the dry run's accounting
    lo, n = chunk_bounds(V, VH_RANKS, 0)
    xr = x.clone().requires_grad_(True)
    wr = w[lo:lo + n].clone().requires_grad_(True)
    sync(dev)
    t0 = time.perf_counter()
    vh_one_rank(xr, wr, labels, lo)
    sync(dev)
    ms_rank = 1e3 * (time.perf_counter() - t0)
    del xr, wr
    card = vh_peak(dev, x, w, labels, lo, n)
    dry = dry[name]
    peak_rel = abs(dry["peak_bytes"] - card) / card
    if not peak_rel <= VH_PEAK_RTOL:
        raise AssertionError(f"[vocab-head] {name}: one rank's peak dry {dry['peak_bytes']} B, "
                             f"card {card} B ({100 * peak_rel:.2f}% > {100 * VH_PEAK_RTOL}%)")
    del x, w, labels
    torch.cuda.empty_cache()
    print(f"[vocab-head] {name} {'tied table' if tied else 'untied head'} V {V:,} d {d:,}, "
          f"{VH_B} x {VH_S} float32 over {VH_RANKS} emulated model ranks (chunks of "
          f"{' / '.join(f'{c:,}' for c in reversed(lens))}) against the whole vocabulary's "
          f"float64: loss rel err {loss_rel:.3e} (tol {VH_LOSS_RTOL}), dX max|err| "
          f"{dx_err[0]:.3e} (tol {dx_err[1]:.3e}), dW assembled {dw_err[0]:.3e} (tol "
          f"{dw_err[1]:.3e}); the float32 whole vocabulary's departures from it: loss "
          f"{whole[0]:.3e}, dX {whole[1]:.3e}, dW {whole[2]:.3e} of the largest (dX's "
          f"rounding bound sum_tol({V}) {sum_tol(V):.3e}); one rank's head + loss peak "
          f"{card / 2**30:.4f} GiB on the card, {dry['peak_bytes'] / 2**30:.4f} GiB in the dry "
          f"run's accounting ({100 * peak_rel:.2f}%, within {100 * VH_PEAK_RTOL:.0f}%; its "
          f"FLOPs {dry['flops']:,}); ms forward + backward: whole vocabulary {ms_whole:.1f} "
          f"(warm), the {VH_RANKS} ranks {ms_ranks:.1f}, one rank {ms_rank:.1f}; the float64 "
          f"reference {s_ref:.2f} s ({smi_line()})")
    return dict(loss_rel=loss_rel, dx=dx_err[0], dw=dw_err[0], whole=whole, card=card,
                dry=dry["peak_bytes"], ms_whole=ms_whole, ms_ranks=ms_ranks, ms_rank=ms_rank)


def vocab_head(dev, dry=None):
    """Phase 26 (module docstring), its inputs drawn from VH_SEED. Returns
    its launches: none (the head is an exact product; the counts are set to
    0 before and read after). ``dry``: the dry run's accounting of the rank
    calls, from phase 21's child; None (the phase alone): computed here
    first, outside its time."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(VH_SEED)

    if dry is None:
        t0 = time.perf_counter()
        dry = vh_dry_peaks()
        print(f"[vocab-head] the dry run's accounting in this process (phase 21's child did "
              f"not run): {time.perf_counter() - t0:.1f} s, outside the phase's time")
    t_phase = time.perf_counter()
    sync(dev)
    ops.reset_launch_counts()
    for case in VH_CASES:
        vh_case(dev, gen, dry, *case)
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"[vocab-head] the exact head launched {counts}")
    secs = time.perf_counter() - t_phase
    if secs > VH_LIMIT_S:
        raise AssertionError(f"[vocab-head] the phase took {secs:.1f} s (limit {VH_LIMIT_S})")
    print(f"[time]   vocab head {secs:.1f} s")
    return counts


# -- phase 27: the paper's figure experiments on the §5 MLP ---------------------

# the figure scripts whose quick grids (each script's grid()) phase 27 (a)
# trains, each distinct (policy, sizes) once; bench_adaptive's POLICY is added
# by fig_policies
FIG_SCRIPTS = ("fig1a_correlation", "fig1b_mask_vs_sketch", "fig2a_proxies", "fig2b_spectral",
               "fig4_location", "bench_block_granularity", "bench_variance")
FIG_SIZES = (784, 64, 64, 10)  # the §5 MLP, where a script sets no SIZES
FIG_LR = 0.2
FIG_EPOCHS = 1
FIG_CHANCE = 0.1  # 10 classes: exact backprop's test accuracy must pass 2x this
# bench_variance's quick methods and budgets, and l1 with independent gates
FIG_MC = tuple((m, p, e) for m in ("per_column", "l1", "ds") for p in (0.1, 0.5)
               for e in ((True, False) if m == "l1" else (True,)))
# P(chi2_1 > 15.137) = 1e-4: n ||mean - g||^2 / V of an unbiased estimator is a
# weighted sum of chi2_1 variables, whose tail beyond 1.54 is at most chi2_1's
# (tests/test_torch_figures.py, where the same bound rejects the mask without
# its 1/p rescale). At n = 100 it rejects only a squared bias above 15% of V:
# at budget 0.1, where V is ~500 |g|^2, it cannot see a bias below several
# times the gradient; V itself is held against the same draws on the host
FIG_CHI2_1_TAIL = 15.137
# the card's V against the host CPU's on the same weights and batch (other
# draws): within FIG_V_SIGMAS standard errors of their difference, each the
# card's (its per-draw ||g^ - g||^2's standard deviation over sqrt(n)), as the
# CPU test holds the port's V against JAX's
FIG_V_SIGMAS = 4.0
# the phase is host-bound (~150 small ops per sketched site): 22.5 and 31.7 s in
# the script before (b)'s host-CPU witness, 29.9 s with it. The card machines'
# hosts differ ~2x in speed, so the bound is 2x the slowest reading of the
# phase as it stands: it catches a regression beyond that spread only
FIG_LIMIT_S = 60.0


def fig_policies():
    """The distinct (label, policy, sizes) of the figure scripts' quick grids."""
    import importlib

    from benchmarks.torch import bench_adaptive
    from benchmarks.torch.common import make_policy

    seen, out = set(), []
    entries = []
    for name in FIG_SCRIPTS:
        mod = importlib.import_module(f"benchmarks.torch.{name}")
        sizes = getattr(mod, "SIZES", FIG_SIZES)
        entries += [(f"{m}@{p} {kw}", make_policy(m, p, **kw), sizes)
                    for m, p, kw in mod.grid(quick=True)]
    entries.append(("adaptive l1@0.6", bench_adaptive.POLICY, bench_adaptive.SIZES))
    for label, pol, sizes in entries:
        if (pol, sizes) not in seen:
            seen.add((pol, sizes))
            out.append((label, pol, sizes))
    return out


def figures(dev):
    """Phase 27: the figure experiments' paths on the card (module
    docstring). Returns their launches: none (the ``mask`` backend)."""
    from benchmarks.torch import bench_adaptive, bench_variance
    from benchmarks.torch.common import make_policy, mlp_data, train_mlp
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    total = {name: 0 for name in ops.KERNELS}

    def read(label):
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        if any(counts.values()):
            raise AssertionError(f"[figures] {label} launched {counts}: the mask backend "
                                 f"runs no kernel")
        for name, n in counts.items():
            total[name] += n

    data = mlp_data()
    t0 = time.perf_counter()
    accs = []
    for label, pol, sizes in fig_policies():
        ops.reset_launch_counts()
        r = train_mlp(pol, lr=FIG_LR, epochs=FIG_EPOCHS, data=data, sizes=sizes, device=dev)
        read(label)
        if not all(math.isfinite(a) for a in r.values()):
            raise AssertionError(f"[figures] {label}: accuracies {r}")
        if pol is None and r["test_acc"] <= 2 * FIG_CHANCE:
            raise AssertionError(f"[figures] exact backprop at chance: {r}")
        accs.append(f"{label}{'' if sizes == FIG_SIZES else ' ' + str(sizes)} "
                    f"{r['test_acc']:.4f}")
    secs_a = time.perf_counter() - t0
    print(f"[figures] (a) {len(accs)} policies, {FIG_EPOCHS} epoch at lr {FIG_LR}, test "
          f"accuracy: {'; '.join(accs)}; launches 0; {secs_a:.1f} s")

    t0 = time.perf_counter()
    n_mc = bench_variance.N_MC_QUICK
    params, batch, exact = bench_variance.problem(dev)
    host = lambda tree: tree_map(lambda t: t.detach().cpu(), tree)  # noqa: E731
    h_params = tree_map(lambda t: t.requires_grad_(), host(params))
    h_batch, h_exact = host(batch), host(exact)
    flat = lambda tree: torch.cat([t.reshape(-1) for t in tree_leaves(tree)])  # noqa: E731
    lines, secs_host = [], 0.0
    for m, p, exact_r in FIG_MC:
        policy = make_policy(m, p, exact_r=exact_r)
        draws = []
        ops.reset_launch_counts()
        stats = bench_variance.mc_stats(params, batch, policy, exact, n_mc, dev, record=draws)
        read(f"{m}@{p} variance")
        V, bias_sq = float(stats["variance"]), float(stats["bias_sq"])
        bound = FIG_CHI2_1_TAIL * V / n_mc
        if not (math.isfinite(V) and bias_sq <= bound):
            raise AssertionError(f"[figures] {m}@{p} exact_r {exact_r}: bias_sq {bias_sq} over "
                                 f"{bound} (V {V})")
        err = torch.stack([(flat(g) - flat(exact)).square().sum() for g in draws])
        se = float(err.std()) / math.sqrt(n_mc)
        t1 = time.perf_counter()
        h_V = float(bench_variance.mc_stats(h_params, h_batch, policy, h_exact, n_mc,
                                            "cpu")["variance"])
        secs_host += time.perf_counter() - t1
        if abs(V - h_V) > FIG_V_SIGMAS * math.sqrt(2) * se:
            raise AssertionError(f"[figures] {m}@{p} exact_r {exact_r}: V {V} on the card, "
                                 f"{h_V} on the host CPU, beyond {FIG_V_SIGMAS} x sqrt(2) x "
                                 f"its standard error {se}")
        lines.append(f"{m}@{p}{'' if exact_r else ' independent'} V {V:.4g} (host CPU "
                     f"{h_V:.4g}, {abs(V - h_V) / (math.sqrt(2) * se):.2f} standard errors) "
                     f"bias_sq {bias_sq:.4g} ({bias_sq / bound:.3f} of its bound)")
    secs_b = time.perf_counter() - t0
    print(f"[figures] (b) {n_mc} draws each, |exact g|^2 {float(stats['exact_norm_sq']):.4g}: "
          f"{'; '.join(lines)}; {secs_b:.1f} s ({secs_host:.1f} s of it the host CPU's draws)")

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    out = bench_adaptive.run(tiny=True, device=dev)
    read("bench_adaptive tiny")
    for name in ("fixed", "warmup_exact", "adaptive"):
        # one build per bucket of the schedule (by construction: docs/port.md)
        if set(out[name]["traces"].values()) != {1} or \
                len(out[name]["traces"]) != out[name]["n_buckets"]:
            raise AssertionError(f"[figures] {name}: builds {out[name]['traces']}")
    if out["adaptive"]["total_bwd_flops"] > out["fixed"]["total_bwd_flops"] or \
            not set(out["adaptive"]["budget_hist"]) <= {1.0, 0.5, 0.25}:
        raise AssertionError(f"[figures] adaptive: {out['adaptive']}")
    secs_c = time.perf_counter() - t0
    print(f"[figures] (c) bench_adaptive tiny: builds "
          f"{ {k: out[k]['traces'] for k in ('fixed', 'warmup_exact', 'adaptive')} }, adaptive "
          f"FLOPs {out['adaptive']['total_bwd_flops'] / out['fixed']['total_bwd_flops']:.3f} "
          f"of fixed, test accuracy {out['adaptive']['test_acc']:.4f} against "
          f"{out['fixed']['test_acc']:.4f}; {secs_c:.1f} s")
    secs = time.perf_counter() - t_phase
    print(f"[figures] (d) seconds: (a) {secs_a:.1f}, (b) {secs_b:.1f}, (c) {secs_c:.1f}")
    if secs > FIG_LIMIT_S:
        raise AssertionError(f"[figures] the phase took {secs:.1f} s (limit {FIG_LIMIT_S})")
    print(f"[time]   figures {secs:.1f} s")
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
    """Phases 4 to 27 (module docstring)."""
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
    dry_counts, vh_dry = dry_run(dev, child)
    for name, n in dry_counts.items():
        launches[name] += n
    print(f"[time] the dry run {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    attn_counts = chunked_attention(dev, gen)
    for name, n in attn_counts.items():
        launches[name] += n
    print(f"[time] the chunked attention {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    split_counts = split_compact(dev, gen)
    for name, n in split_counts.items():
        launches[name] += n
    print(f"[time] the split compact backends {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    method_counts = split_methods(dev, gen)
    for name, n in method_counts.items():
        launches[name] += n
    print(f"[time] the split sketch methods {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mamba_counts = mamba_split(dev, gen)
    for name, n in mamba_counts.items():
        launches[name] += n
    print(f"[time] the split Mamba2 block {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vocab_head(dev, vh_dry)
    print(f"[time] the vocabulary-parallel head {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fig_counts = figures(dev)
    for name, n in fig_counts.items():
        launches[name] += n
    print(f"[time] the figure experiments {time.perf_counter() - t0:.1f} s")
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
          f"sketched steps, their single-device twins, the layout step and the device_loss "
          f"run): {json.dumps(dist_counts)}; the analysis "
          f"tooling (phase 18's cross-checks, one forward and backward per config): "
          f"{json.dumps(an_counts)}; the families under a mesh (phase 19: every sketched "
          f"single-device and one-rank mesh step): {json.dumps(mesh_fam_counts)}; serving "
          f"under a mesh (phase 20: the one-rank mesh's two lm-100m waves and engines): "
          f"{json.dumps(serve_mesh_counts)}; the dry run (phase 21: the card's four lm-100m "
          f"mesh steps it is held against): {json.dumps(dry_counts)}; the chunked attention "
          f"(phase 22 (d), (e): yi-6b's and lm-100m's chunked and einsum steps): "
          f"{json.dumps(attn_counts)}; the split compact backends (phase 23: the 16 "
          f"emulated ranks' parts, column and row shards, per backend): "
          f"{json.dumps(split_counts)}; the split sketch methods (phase 24 (a): gsv's 16 "
          f"emulated column shards' parts): {json.dumps(method_counts)}; the split Mamba2 "
          f"block (phase 25: zamba2-7b's block over 16 emulated model ranks): "
          f"{json.dumps(mamba_counts)}; the figure experiments (phase 27: every policy of "
          f"the figures, the variance draws, the adaptive run, all on the mask backend): "
          f"{json.dumps(fig_counts)}")
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
