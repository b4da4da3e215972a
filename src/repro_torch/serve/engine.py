"""Continuous-batching serving engine: queue -> slots -> paged KV decode (port
of ``repro/serve/engine.py``).

The engine drives three layers behind ``Runtime.serve``:

  * :class:`~repro_torch.serve.scheduler.Scheduler`: the FIFO request
    queue, the slot table and the physical-page allocator. Finished slots
    are evicted and refilled from the queue **between decode steps**, so
    decode never idles a slot while work is queued.
  * :mod:`~repro_torch.serve.kv_cache`: paged KV storage (fixed-size pages,
    a per-slot page map, trash page 0 for freed slots), or slot-major
    caches for configs with ring caches.
  * bucketed, segment-masked **packed prefill**: queued prompts are packed
    page-aligned into one row, rounded up to a power-of-two bucket, so the
    prefill runs at one of a few shapes. ``trace_counts`` counts builds:
    each built function (one prefill per bucket, the decode step, the
    insert) counts once, at its first call, where JAX counts a trace.

Each decode step is one call (gather pages -> ``decode_step`` -> scatter the
new column; on the card a queue of launches with no host sync) followed by
ONE device-to-host copy of the ``[n_slots]`` sampled tokens; each prefill
wave likewise ends in one copy of its first tokens. Per-slot stop tracking
(eos, ``max_new``) runs on the host against that one array. The page map,
tokens and positions go host to device every step, as JAX's ``jnp.asarray``
calls do. Per-request latency stamps (queue, TTFT, total) land on a bounded
:class:`~repro_torch.telemetry.sinks.RingSink`; ``Engine.telemetry()``
summarizes counters, build counts and latency percentiles.

Every prefill batch carries segment ids, so attention takes the plain path
and the engine launches no kernel of ``kernels/`` (as JAX's engine runs no
Pallas kernel), whatever ``attn_impl`` says.

Every decoder family is served: the dense decoder, gemma3's local/global
interleave and other windowed configs (contiguous over ring caches), the
MoE family, the SSM and hybrid families (contiguous; each prompt prefilled
alone at its exact length, since a recurrent state would integrate pads)
and the M-RoPE VLM (text prompts: the three position streams equal). What
the engines refuse is refused when they are built, before any device work:
encoder-decoder configs (as JAX's engine refuses them) and parameters on
another device than the Runtime's.
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
from repro_torch.serve.scheduler import Request, Scheduler, Slot
from repro_torch.serve.serve_step import greedy_sample
from repro_torch.telemetry.sinks import RingSink, percentiles
from repro_torch.tree import tree_leaves

__all__ = ["Request", "Engine", "check_servable", "text_positions"]

_COUNTER_KEYS = ("batches", "prefill_calls", "prefill_tokens", "decode_steps",
                 "tokens_out", "decode_tokens", "requests_done",
                 "truncated_tokens", "wasted_decode_steps")


def check_servable(params, cfg: ArchConfig, device: torch.device) -> None:
    """Raise, before any device work, for what the engines do not serve: an
    encoder-decoder or unported config, or parameters that do not all lie
    on ``device``."""
    if cfg.is_encdec:
        raise ValueError("the serving engine targets decoder-only archs")
    lm.check_decoder(cfg)
    where = {t.device for t in tree_leaves(params) if isinstance(t, torch.Tensor)}
    if where != {device}:
        raise ValueError(f"parameters lie on {sorted(map(str, where))}, the Runtime serves on "
                         f"{device}: move them there, or build the Runtime with their device")


def text_positions(cfg: ArchConfig, poss: np.ndarray) -> np.ndarray:
    """A prefill batch's positions from its text positions [B, S]: as they
    are, or broadcast to M-RoPE's three streams [3, B, S]."""
    return np.repeat(poss[None], 3, axis=0) if cfg.rope == "mrope" else poss


class _Counted:
    """A built function that adds one to ``counts[key]`` at its first call."""

    __slots__ = ("fn", "counts", "key", "called")

    def __init__(self, fn, counts: dict, key: str):
        self.fn, self.counts, self.key, self.called = fn, counts, key, False

    def __call__(self, *args):
        if not self.called:
            self.called = True
            self.counts[self.key] = self.counts.get(self.key, 0) + 1
        return self.fn(*args)


class Engine:
    """Continuous-batching engine over ``Runtime.prefill_step`` / ``decode_step``.

    ``serve`` (a :class:`~repro_torch.serve.config.ServeConfig`) fixes the
    built surface; the legacy ``batch`` / ``max_len`` keywords build one
    (paged when ``max_len`` permits). Greedy outputs equal the
    run-to-completion engine's (``serve/legacy.py``) and JAX's engine's.
    """

    def __init__(self, params, cfg: ArchConfig, *, serve: Optional[ServeConfig] = None,
                 batch: int = 4, max_len: int = 256, runtime: Optional[Runtime] = None):
        self.runtime = runtime if runtime is not None else Runtime()
        check_servable(params, cfg, self.runtime.device)
        if serve is None:
            serve = ServeConfig(n_slots=batch, max_len=max_len,
                                page_size=16 if max_len % 16 == 0 else None)
        self.params = params
        self.cfg = cfg
        self.serve = serve
        self.batch = serve.n_slots
        self.max_len = serve.max_len
        self.device = self.runtime.device
        self.layout = kv_cache.plan_layout(cfg, serve)
        self.scheduler = Scheduler(serve, paged=self.layout.paged)
        # each engine owns a registry (instances never collide) and adopts it
        # into the shared Observability for export; `counters` is its view
        self.obs = observability(self.runtime.execution.obs)
        self._tracer = self.obs.tracer
        self._traced = self._tracer.enabled
        self.metrics = MetricsRegistry()
        if self.obs.metrics is not None:
            self.obs.adopt("serve", self.metrics)
        self.counters = self.metrics.view("serve", _COUNTER_KEYS + ("prefill_s", "decode_s"))
        self.ring = RingSink(capacity=serve.ring_capacity)
        self.trace_counts: dict = {}

        self._pref_raw = self.runtime.prefill_step(cfg, serve.max_len)
        self._dec_raw = self.runtime.decode_step(cfg)
        self._prefills: dict = {}  # bucket -> built prefill
        self._decode = _Counted(self._build_decode(), self.trace_counts, "decode")
        self._insert = _Counted(self._build_insert(), self.trace_counts, "insert")
        if self.layout.paged:
            self._state = kv_cache.init_pools(cfg, serve, device=self.device)
        else:
            self._state = lm.init_cache(cfg, serve.n_slots, serve.max_len, device=self.device)
        self._cur = np.zeros(serve.n_slots, np.int32)
        self._pos = np.zeros(serve.n_slots, np.int32)

    # -- built steps ----------------------------------------------------------

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, torch.long)

    def _build_decode(self):
        serve, dec = self.serve, self._dec_raw
        if self.layout.paged:
            def step(params, pools, page_map, toks, pos):
                posc = pos.clamp(max=serve.max_len - 1)
                contig = kv_cache.gather_slots(pools, page_map, serve)
                logits, new = dec(params, contig, toks, posc)
                pools = kv_cache.scatter_token(pools, new, page_map, posc, serve)
                return greedy_sample(logits)[:, 0], pools
        else:
            def step(params, caches, toks, pos):
                posc = pos.clamp(max=serve.max_len - 1)
                logits, new = dec(params, caches, toks, posc)
                return greedy_sample(logits)[:, 0], new
        return torch.no_grad()(step)

    def _build_insert(self):
        serve = self.serve
        if self.layout.paged:
            def ins(pools, pref, phys_pages, src_page0):
                return kv_cache.insert_prompt_pages(pools, pref, phys_pages, src_page0, serve)
        else:
            def ins(caches, pref, slot):
                return kv_cache.insert_prompt_rows(caches, pref, slot)
        return torch.no_grad()(ins)

    def _bucket_prefill(self, bucket: int):
        fn = self._prefills.get(bucket)
        if fn is not None:
            return fn
        raw = self._pref_raw

        @torch.no_grad()
        def pf(params, batch, last_idx):
            logits, caches = raw(params, batch)
            idx = last_idx.clamp(0, logits.shape[1] - 1)
            return greedy_sample(logits[0, idx]), caches  # first tokens [n_slots]

        fn = self._prefills[bucket] = _Counted(pf, self.trace_counts, f"prefill[{bucket}]")
        return fn

    # -- serving loop ---------------------------------------------------------

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve requests to completion (continuous batching: admission,
        per-slot stop, eviction and refill all interleave with decode).

        Admission checks run up front, before any device work: empty prompts
        and unservable ``max_new`` raise; over-long prompts are
        *left*-truncated to ``max_len - max_new`` (the most recent context
        survives) with the dropped count recorded. With ``ObsConfig`` export
        paths set, the trace is written when the run ends.
        """
        requests = list(requests)
        with self._tracer.span("serve.run", n_requests=len(requests)):
            truncated = self.scheduler.submit(requests, clock.now())
            self.counters["truncated_tokens"] += truncated
            sched = self.scheduler
            while sched.pending() or sched.live_slots():
                self._refill()
                if sched.live_slots():
                    self._decode_one_step()
        self.obs.export()
        return requests

    def _refill(self):
        sched, serve = self.scheduler, self.serve
        pack = self.layout.paged and serve.pack_prefill
        align = serve.page_size if pack else 1
        while sched.free_slots() and sched.pending():
            wave = sched.take_wave(pack=pack, align=align)
            if not wave:
                break  # head-of-line blocked on pages until an eviction
            self._prefill_wave(wave, align)

    def _prefill_wave(self, wave: List[Request], align: int):
        serve, c = self.serve, self.counters
        t0 = clock.now()
        offs, off = [], 0
        for r in wave:
            offs.append(off)
            off += -(-len(r.prompt) // align) * align
        if self.layout.pad_ok:
            bucket = serve.bucket_for(off)
        else:
            # a recurrent state integrates pads irreversibly: the wave's one
            # prompt at its exact length (one build per distinct length)
            bucket = len(wave[0].prompt)
        toks = np.zeros((1, bucket), np.int32)
        segs = np.zeros((1, bucket), np.int32)
        poss = np.zeros((1, bucket), np.int32)
        last = np.zeros(serve.n_slots, np.int32)
        for i, r in enumerate(wave):
            o, n = offs[i], len(r.prompt)
            toks[0, o:o + n] = r.prompt
            segs[0, o:o + n] = i + 1
            poss[0, o:o + n] = np.arange(n)
            last[i] = o + n - 1
        batch = {"tokens": toks, "segments": segs, "positions": text_positions(self.cfg, poss)}
        first, pref = self._bucket_prefill(bucket)(self.params, batch, self._to_dev(last))
        first_np = first.cpu().numpy()  # lint: waive=host-sync-in-step — one copy a wave
        now = clock.now()
        c["batches"] += 1
        c["prefill_calls"] += 1
        c["prefill_tokens"] += bucket
        for i, r in enumerate(wave):
            tok = int(first_np[i])
            slot = self.scheduler.place(r, tok, now)
            if self.layout.paged:
                g = -(-len(r.prompt) // serve.page_size)
                phys = np.where(np.arange(serve.pages_per_slot) < g,
                                self.scheduler.page_map[slot.idx], 0)
                self._state = self._insert(self._state, pref, self._to_dev(phys),
                                           offs[i] // serve.page_size)
            else:
                self._state = self._insert(self._state, pref, slot.idx)
            self._cur[slot.idx] = tok
            self._pos[slot.idx] = slot.pos
            c["tokens_out"] += 1
            self._maybe_finish(slot, tok, now)
        end = clock.now()
        c["prefill_s"] += end - t0
        if self._traced:
            self._tracer.add_span("prefill_wave", t0, end, bucket=int(bucket), n=len(wave))

    def _decode_one_step(self):
        sched, c = self.scheduler, self.counters
        live = sched.live_slots()
        t0 = clock.now()
        c["decode_steps"] += 1
        c["wasted_decode_steps"] += self.serve.n_slots - len(live)
        toks = self._to_dev(self._cur[:, None])
        pos = self._to_dev(self._pos)
        if self.layout.paged:
            nxt, self._state = self._decode(self.params, self._state,
                                            self._to_dev(sched.page_map), toks, pos)
        else:
            nxt, self._state = self._decode(self.params, self._state, toks, pos)
        nxt_np = nxt.cpu().numpy()  # lint: waive=host-sync-in-step — the step's one copy
        now = clock.now()
        for s in live:
            t = int(nxt_np[s.idx])
            s.outs.append(t)
            s.pos += 1
            self._cur[s.idx] = t
            self._pos[s.idx] = s.pos
            c["tokens_out"] += 1
            c["decode_tokens"] += 1
            self._maybe_finish(s, t, now)
        c["decode_s"] += now - t0
        if self._traced:
            self._tracer.add_span("decode_step", t0, now, live=len(live))

    def _maybe_finish(self, slot: Slot, tok: int, now: float):
        r = slot.req
        eos = r.eos if r.eos is not None else self.serve.eos
        if len(slot.outs) >= r.max_new:
            self._finish(slot, "length", now)
        elif eos is not None and tok == eos:
            self._finish(slot, "eos", now)  # the eos token stays in the output

    def _finish(self, slot: Slot, reason: str, now: float):
        n_new = len(slot.outs)
        req = self.scheduler.finish(slot, reason, now)
        self.counters["requests_done"] += 1
        span_id = None
        if self._traced:
            # the request's lifecycle, rebuilt from the scheduler's stamps:
            # queued -> prefill (admit..first token, the KV insert included)
            # -> decode; `span_id` on the ring record joins it to the trace
            tr = self._tracer
            span_id = tr.add_span("request", req.t_submit, req.t_done,
                                  stop=reason, prompt_len=int(len(req.prompt)),
                                  new_tokens=n_new)
            tr.add_span("queued", req.t_submit, req.t_admit, parent=span_id)
            tr.add_span("prefill", req.t_admit, req.t_first, parent=span_id)
            tr.add_span("decode", req.t_first, req.t_done, parent=span_id)
        self.ring.write({
            "prompt_len": int(len(req.prompt)), "new_tokens": n_new,
            "stop": reason, "truncated_tokens": req.truncated,
            "queue_s": req.t_admit - req.t_submit,
            "ttft_s": req.t_first - req.t_submit,
            "latency_s": req.t_done - req.t_submit,
            "span_id": span_id,
        })
        self._cur[slot.idx] = 0
        self._pos[slot.idx] = 0

    # -- telemetry ------------------------------------------------------------

    def telemetry(self) -> dict:
        """Counters, throughput, latency percentiles and build counts."""
        c = dict(self.counters)
        c["decode_tok_per_s"] = (c["decode_tokens"] / c["decode_s"]
                                 if c["decode_s"] > 0 else 0.0)
        c["prefill_tok_per_s"] = (c["prefill_tokens"] / c["prefill_s"]
                                  if c["prefill_s"] > 0 else 0.0)
        c["layout"] = "paged" if self.layout.paged else "contiguous"
        c["trace_counts"] = dict(self.trace_counts)
        lat = percentiles(self.ring.records, "latency_s", (50, 99))
        c["latency_p50_s"], c["latency_p99_s"] = lat[50], lat[99]
        ttft = percentiles(self.ring.records, "ttft_s", (50, 99))
        c["ttft_p50_s"], c["ttft_p99_s"] = ttft[50], ttft[99]
        return c
