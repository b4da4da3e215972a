"""Run-to-completion serving baseline (port of ``repro/serve/legacy.py``).

Requests are served in fixed batches: one prefill per batch (right-padded
to the batch's longest prompt, segment-masked so pads never leak into
attention), then **every** slot decodes ``max(max_new)`` steps. A slot that
finished early keeps burning decode work until the stragglers catch up, and
a shorter final batch decodes padding lanes. Neither loss is hidden:
``wasted_decode_steps`` counts finished-slot steps and ``dead_slot_steps``
padding-lane steps, the gap the continuous engine (``serve/engine.py``)
closes. There is no queue, no eviction and no per-slot stop (eos is
ignored), and a prefill is built per distinct padded prompt length (see
``trace_counts``, one count at each one's first call).

A config with recurrent state (the SSM and hybrid families: the cache
layout's ``pad_ok`` is False) is never padded, where JAX's engine pads it
and its state integrates the pads: the batch's prompts are prefilled in
groups of equal length, one call per distinct length (rows of one length
together, no padding), and their rows are copied into the batch's caches.
``prefill_calls`` then counts those calls and ``prefill_tokens`` the
prompts' own tokens (JAX counts one call and ``batch x`` the longest
prompt per batch). A padding lane's caches stay zero and its first token 0.

A slot decoding past its own ``max_new`` may run past ``max_len``; its
position is clipped to ``max_len - 1`` (JAX drops that out-of-range write),
which changes only tokens the slot discards. One device-to-host copy per
decode step, and a device synchronize before the decode time is read.

Under a mesh-bearing Runtime every rank runs the same batches (as
``serve/engine.py`` does): sharded parameters, caches in ``cache_specs``'
layout, this rank's rows in the steps, and the first and sampled tokens
all-gathered over the data axes.

Greedy outputs equal the continuous engine's and sequential decoding's.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.api.runtime import Runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.obs import clock, observability
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import kv_cache
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import _Counted, check_servable, serving_params, text_positions
from repro_torch.serve.scheduler import Request
from repro_torch.serve.serve_step import greedy_sample, own_rows, whole_rows
from repro_torch.telemetry.sinks import RingSink

__all__ = ["Request", "RunToCompletionEngine"]


class RunToCompletionEngine:
    def __init__(self, params, cfg: ArchConfig, *, batch: int = 4,
                 max_len: int = 256, runtime: Optional[Runtime] = None):
        self.runtime = runtime if runtime is not None else Runtime()
        check_servable(params, cfg, self.runtime.device)
        mesh = self.mesh = self.runtime.execution.mesh
        self.params = serving_params(params, mesh)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.device = self.runtime.device
        self.pad_ok = kv_cache.plan_layout(
            cfg, ServeConfig(n_slots=batch, max_len=max_len, page_size=None)).pad_ok
        self.trace_counts: dict = {}
        pref_raw = self.runtime.prefill_step(cfg, max_len)
        dec_raw = self.runtime.decode_step(cfg)

        @torch.no_grad()
        def pf(params, batch_d, last_idx):
            logits, caches = pref_raw(params, batch_d)
            n = last_idx.shape[0]
            if mesh is not None:
                last_idx = own_rows(last_idx, mesh, n)
            rows = torch.arange(logits.shape[0], device=logits.device)
            first = greedy_sample(logits[rows, last_idx])
            return (first if mesh is None else whole_rows(first, mesh, n)), caches

        @torch.no_grad()
        def dc(params, caches, toks, pos):
            logits, new = dec_raw(params, caches, toks, pos.clamp(max=max_len - 1))
            nxt = greedy_sample(logits)[:, 0]
            return (nxt if mesh is None else whole_rows(nxt, mesh, toks.shape[0])), new

        self._pf = pf
        self._prefills: dict = {}  # padded prompt length -> built prefill
        self._decode = _Counted(dc, self.trace_counts, "decode")
        self.obs = observability(self.runtime.execution.obs)
        self.metrics = MetricsRegistry()
        if self.obs.metrics is not None:
            self.obs.adopt("serve_legacy", self.metrics)
        self.counters = self.metrics.view(
            "serve_legacy",
            ("batches", "prefill_calls", "prefill_tokens", "decode_steps",
             "tokens_out", "truncated_tokens", "dead_slot_steps",
             "wasted_decode_steps", "prefill_s", "decode_s"))
        self.ring = RingSink(capacity=256)

    def _prefill(self, plen: int):
        fn = self._prefills.get(plen)
        if fn is None:
            fn = self._prefills[plen] = _Counted(self._pf, self.trace_counts, f"prefill[{plen}]")
        return fn

    def _batch(self, toks: np.ndarray, segs: np.ndarray) -> dict:
        poss = np.broadcast_to(np.arange(toks.shape[1], dtype=np.int32), toks.shape).copy()
        return {"tokens": toks, "segments": segs, "positions": text_positions(self.cfg, poss)}

    def _prefill_unpadded(self, prompts):
        """(first tokens [batch], the batch's caches, prefill calls) of prompts
        prefilled without padding: the rows of each distinct length in one
        call, copied into the batch's caches at their own rows."""
        dev = self.device
        caches = lm.init_cache(self.cfg, self.batch, self.max_len, device=dev, mesh=self.mesh)
        first = torch.zeros(self.batch, dtype=torch.int32, device=dev)
        rows_of: dict = {}  # length -> rows, in order of first appearance
        for j, p in enumerate(prompts):
            rows_of.setdefault(len(p), []).append(j)
        for n, rows in rows_of.items():
            toks = np.stack([prompts[j] for j in rows])
            f, pref = self._prefill(n)(
                self.params, self._batch(toks, np.ones_like(toks)),
                torch.full((len(rows),), n - 1, dtype=torch.long, device=dev))
            first[torch.tensor(rows, device=dev)] = f
            for i, j in enumerate(rows):
                kv_cache.insert_prompt_rows(caches, pref, j, row=i, mesh=self.mesh)
        return first, caches, len(rows_of)

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a list of requests in fixed-size run-to-completion batches.

        Admission checks up front (before any device work): an empty prompt
        is rejected, as is a ``max_new`` that cannot fit the engine's
        ``max_len`` KV budget even with the whole prompt truncated away.
        Over-long prompts are *left*-truncated to ``max_len - max_new`` (the
        most recent context survives) and the dropped token count is
        recorded (``counters["truncated_tokens"]`` and the per-batch ring).
        """
        for i, r in enumerate(requests):
            if len(r.prompt) == 0:
                raise ValueError(f"request {i}: empty prompt")
            if r.max_new <= 0:
                raise ValueError(f"request {i}: max_new must be >= 1, got {r.max_new}")
            if r.max_new >= self.max_len:
                raise ValueError(
                    f"request {i}: max_new={r.max_new} leaves no room for "
                    f"any prompt token within max_len={self.max_len}")
        for i in range(0, len(requests), self.batch):
            self._run_batch(requests[i:i + self.batch])
        return requests

    def _run_batch(self, reqs: List[Request]):
        B, N = len(reqs), self.batch
        dev = self.device
        prompts, truncated = [], 0
        for r in reqs:
            p = np.asarray(r.prompt, np.int32)
            keep = self.max_len - r.max_new
            if len(p) > keep:
                truncated += len(p) - keep
                p = p[-keep:]  # keep the most recent context
            prompts.append(p)
        plen = max(len(p) for p in prompts)
        lens = np.zeros(N, np.int32)
        lens[:B] = [len(p) for p in prompts]
        t0 = clock.now()
        if self.pad_ok:
            toks = np.zeros((N, plen), np.int32)
            segs = np.zeros((N, plen), np.int32)
            for j, p in enumerate(prompts):
                toks[j, :len(p)] = p  # right-pad; pads are segment-masked out
                segs[j, :len(p)] = 1
            first, caches = self._prefill(plen)(
                self.params, self._batch(toks, segs),
                torch.from_numpy(np.maximum(lens - 1, 0)).to(dev, torch.long))
            calls, ptoks = 1, N * plen
        else:
            first, caches, calls = self._prefill_unpadded(prompts)
            ptoks = int(lens.sum())
        first_np = first.cpu().numpy()  # lint: waive=host-sync-in-step — one copy a batch
        t_prefill = clock.now() - t0
        outs = [[int(first_np[j])] for j in range(B)]
        max_new = max(r.max_new for r in reqs)
        cur = first[:, None]
        pos = torch.from_numpy(lens).to(dev, torch.long)  # per-slot positions
        wasted = dead = 0
        t0 = clock.now()
        for t in range(1, max_new):
            # every slot decodes every step: the run-to-completion deal. One
            # [N] device-to-host copy per step.
            nxt, caches = self._decode(self.params, caches, cur, pos)
            step_tok = nxt.cpu().numpy()  # lint: waive=host-sync-in-step — one copy a step
            for j in range(B):
                outs[j].append(int(step_tok[j]))
            wasted += sum(1 for r in reqs if t >= r.max_new)
            dead += N - B
            cur = nxt[:, None]
            pos = pos + 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_decode = clock.now() - t0
        for j, r in enumerate(reqs):
            r.out = np.asarray(outs[j][:r.max_new], np.int32)
            r.stop = "length"
        tokens_out = sum(r.max_new for r in reqs)
        c = self.counters
        c["batches"] += 1
        c["prefill_calls"] += calls
        c["prefill_tokens"] += ptoks
        c["decode_steps"] += max_new - 1
        c["tokens_out"] += tokens_out
        c["truncated_tokens"] += truncated
        c["dead_slot_steps"] += dead
        c["wasted_decode_steps"] += wasted + dead
        c["prefill_s"] += t_prefill
        c["decode_s"] += t_decode
        self.ring.write({"batch": B, "prompt_len": plen,
                         "decode_steps": max_new - 1, "tokens_out": tokens_out,
                         "truncated_tokens": truncated, "dead_slots": N - B,
                         "wasted_decode_steps": wasted + dead,
                         "prefill_s": t_prefill, "decode_s": t_decode})
        return reqs

    def telemetry(self) -> dict:
        """Decode-path counter summary (cumulative since construction)."""
        c = dict(self.counters)
        c["decode_tok_per_s"] = (c["tokens_out"] / c["decode_s"]
                                 if c["decode_s"] > 0 else 0.0)
        c["prefill_tok_per_s"] = (c["prefill_tokens"] / c["prefill_s"]
                                  if c["prefill_s"] > 0 else 0.0)
        c["trace_counts"] = dict(self.trace_counts)
        return c
