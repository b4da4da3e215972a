"""The serving engines on the CPU against JAX's: the continuous-batching
engine over a paged KV cache, the run-to-completion engine, the scheduler and
the KV-page functions.

Weights come from JAX's ``lm.init_params`` through ``params_from_jax``;
requests and pools are made with numpy from a seed. Tolerances: greedy
tokens, stop reasons and every counter that is not a timing (the ``*_s`` and
``*_per_s`` fields) must equal JAX's exactly; the KV-page functions move
values without arithmetic, so their results must equal JAX's bit for bit.
The ports of ``tests/test_serve.py``'s engine tests hold the port's engines
to the port's own sequential decoding, token for token, as JAX's tests hold
JAX's. Everything runs on one intra-op thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.models import lm as jlm
from repro.nn.common import Ctx as JCtx
from repro.serve import kv_cache as jkv
from repro.serve.config import ServeConfig as JServeConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.legacy import RunToCompletionEngine as JLegacy
from repro.serve.serve_step import greedy_sample as jgreedy
from repro_torch.api import Runtime, ServeConfig
from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig
from repro_torch.interop import caches_from_jax, params_from_jax, pools_from_jax
from repro_torch.models import lm
from repro_torch.nn.common import Ctx
from repro_torch.serve import greedy_sample
from repro_torch.serve import kv_cache
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.legacy import RunToCompletionEngine
from repro_torch.serve.scheduler import Scheduler

# tests/test_serve.py's serving config
SERVE = dict(name="serve-test", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
             d_ff=128, vocab=256, q_chunk=32, kv_chunk=32)
CFG = ArchConfig(**SERVE)
JCFG = JArchConfig(**SERVE)
CPU = Runtime(device="cpu")
# the fields of telemetry() that are timings
TIMING = ("prefill_s", "decode_s", "decode_tok_per_s", "prefill_tok_per_s", "latency_p50_s",
          "latency_p99_s", "ttft_p50_s", "ttft_p99_s")
RING_TIMING = ("queue_s", "ttft_s", "latency_s", "span_id", "prefill_s", "decode_s")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test processes share the cores, and one
    thread keeps the CPU's float32 sums in one order between calls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _params():
    """(JAX params, the port's params on the CPU): the same weights."""
    if not _PARAMS:
        jp = jlm.init_params(jax.random.key(0), JCFG)
        _PARAMS["j"] = jp
        _PARAMS["t"] = params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return _PARAMS["j"], _PARAMS["t"]


def _specs(seed=0, lens=(11, 5, 23, 3, 17, 9, 30, 7), news=(6, 3, 9, 2, 12, 4, 5, 8)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, CFG.vocab, size=n).astype(np.int32), m) for n, m in zip(lens, news)]


def _mixed_requests(seed=0, lens=(11, 5, 23, 3, 17, 9, 30, 7), news=(6, 3, 9, 2, 12, 4, 5, 8),
                    cls=Request):
    return [cls(prompt=p.copy(), max_new=m) for p, m in _specs(seed, lens, news)]


_REF_CACHE = {}


def _reference_decode(params, prompt, max_new, max_len, cfg=CFG):
    """The port's sequential decoding of one prompt: prefill, the next token
    from a full forward, then ``max_new`` greedy decode steps at batch 1."""
    key = (cfg, tuple(int(t) for t in prompt), max_new, max_len)
    if key in _REF_CACHE:
        return _REF_CACHE[key]
    toks = torch.as_tensor(np.asarray(prompt)).long()[None]
    with torch.no_grad():
        _, caches = lm.prefill(params, {"tokens": toks}, Ctx(), cfg, max_len)
        logits = lm.forward(params, {"tokens": toks}, Ctx(), cfg)
        cur = greedy_sample(logits[:, -1:])
        out, pos = [], toks.shape[1]
        for _ in range(max_new):
            out.append(int(cur[0, 0]))
            logits, caches = lm.decode_step(params, caches, cur.long(), pos, Ctx(), cfg)
            cur = greedy_sample(logits)
            pos += 1
    _REF_CACHE[key] = out
    return out


def _no_timing(d, drop=TIMING):
    return {k: v for k, v in d.items() if k not in drop}


def _same_as_jax(reqs, jreqs, eng, jeng):
    """Tokens, stop reasons, truncation, counters and ring records equal."""
    for r, jr in zip(reqs, jreqs):
        assert r.out.tolist() == np.asarray(jr.out).tolist()
        assert (r.stop, r.truncated) == (jr.stop, jr.truncated)
    assert _no_timing(eng.telemetry()) == _no_timing(jeng.telemetry())
    assert ([_no_timing(x, RING_TIMING) for x in eng.ring.records]
            == [_no_timing(x, RING_TIMING) for x in jeng.ring.records])


# ---------------------------------------------------------------------------
# the engines against JAX's engines, on the same requests and weights
# ---------------------------------------------------------------------------


def test_engine_matches_jax_engine():
    jp, tp = _params()
    sv = dict(n_slots=4, max_len=64)
    reqs, jreqs = _mixed_requests(), _mixed_requests(cls=JRequest)
    eng = Engine(tp, CFG, serve=ServeConfig(**sv), runtime=CPU)
    jeng = JEngine(jp, JCFG, serve=JServeConfig(**sv))
    eng.run(reqs)
    jeng.run(jreqs)
    assert eng.layout.paged and eng.telemetry()["requests_done"] == len(reqs)
    _same_as_jax(reqs, jreqs, eng, jeng)


def test_legacy_matches_jax_legacy():
    jp, tp = _params()
    reqs, jreqs = _mixed_requests(), _mixed_requests(cls=JRequest)
    eng = RunToCompletionEngine(tp, CFG, batch=4, max_len=64, runtime=CPU)
    jeng = JLegacy(jp, JCFG, batch=4, max_len=64)
    eng.run(reqs)
    jeng.run(jreqs)
    _same_as_jax(reqs, jreqs, eng, jeng)
    assert eng.counters["wasted_decode_steps"] > 0


@pytest.mark.parametrize("perm_seed", [0, 1])
def test_engines_match_jax_under_permuted_arrival(perm_seed):
    """Both engines under two permuted arrival orders: tokens, stops and
    counters as JAX's; a request's tokens are the same in every order."""
    jp, tp = _params()
    order = np.random.default_rng(perm_seed).permutation(8)
    reqs = [_mixed_requests()[i] for i in order]
    jreqs = [_mixed_requests(cls=JRequest)[i] for i in order]
    eng = Engine(tp, CFG, serve=ServeConfig(n_slots=4, max_len=64), runtime=CPU)
    jeng = JEngine(jp, JCFG, serve=JServeConfig(n_slots=4, max_len=64))
    eng.run(reqs)
    jeng.run(jreqs)
    _same_as_jax(reqs, jreqs, eng, jeng)
    lreqs = [_mixed_requests()[i] for i in order]
    jlreqs = [_mixed_requests(cls=JRequest)[i] for i in order]
    leg = RunToCompletionEngine(tp, CFG, batch=4, max_len=64, runtime=CPU)
    jleg = JLegacy(jp, JCFG, batch=4, max_len=64)
    leg.run(lreqs)
    jleg.run(jlreqs)
    _same_as_jax(lreqs, jlreqs, leg, jleg)
    for r, lr in zip(reqs, lreqs):
        assert r.out.tolist() == lr.out.tolist()


def test_engine_decode_counters():
    """Port of tests/test_telemetry.py::test_engine_decode_counters."""
    cfg = ArchConfig(name="srv", family="dense", n_layers=1, d_model=32, n_heads=4, n_kv=2,
                     d_ff=64, vocab=64, q_chunk=16, kv_chunk=16)
    params = lm.init_params(0, cfg, device="cpu")
    eng = Engine(params, cfg, batch=2, max_len=32, runtime=CPU)
    reqs = [Request(prompt=np.asarray([1, 2, 3], np.int32), max_new=4),
            Request(prompt=np.asarray([4, 5], np.int32), max_new=4)]
    eng.run(reqs)
    assert all(r.out is not None and len(r.out) == 4 for r in reqs)
    t = eng.telemetry()
    assert t["batches"] == 1 and t["prefill_calls"] == 1
    # the first token comes from the prefill logits: 4 new tokens = 3 decodes
    assert t["decode_steps"] == 3 and t["tokens_out"] == 8
    assert t["decode_tok_per_s"] > 0 and t["prefill_tok_per_s"] > 0
    # the continuous engine rings one record per finished request
    assert len(eng.ring) == 2
    assert all(r["new_tokens"] == 4 and r["latency_s"] >= 0 for r in eng.ring.records)


# ---------------------------------------------------------------------------
# ports of tests/test_serve.py's engine tests (against the port's own
# sequential decoding)
# ---------------------------------------------------------------------------


def test_engine_matches_reference():
    _, params = _params()
    reqs = _mixed_requests()
    Engine(params, CFG, serve=ServeConfig(n_slots=4, max_len=64), runtime=CPU).run(reqs)
    for r in reqs:
        assert r.out.tolist() == _reference_decode(params, r.prompt, r.max_new, 64)
        assert r.stop == "length"


def test_mid_stream_refill():
    """8 requests through 4 slots with mixed max_new: slots refill from the
    queue mid-decode, every output matches the sequential reference, and the
    engine wastes fewer decode steps than the run-to-completion one."""
    _, params = _params()
    news = (2, 20, 2, 20, 2, 20, 2, 3)
    reqs = _mixed_requests(news=news)
    eng = Engine(params, CFG, serve=ServeConfig(n_slots=4, max_len=64), runtime=CPU)
    eng.run(reqs)
    for r in reqs:
        assert r.out.tolist() == _reference_decode(params, r.prompt, r.max_new, 64)
    c = eng.counters
    assert c["batches"] >= 2  # refill happened mid-stream
    assert c["requests_done"] == len(reqs)
    leg = RunToCompletionEngine(params, CFG, batch=4, max_len=64, runtime=CPU)
    leg.run(_mixed_requests(news=news))
    assert c["wasted_decode_steps"] < leg.counters["wasted_decode_steps"]


def test_paged_vs_contiguous_parity():
    """Paged pools and page-map decode equal contiguous slot-major decode."""
    _, params = _params()
    reqs_p, reqs_c = _mixed_requests(seed=3), _mixed_requests(seed=3)
    ep = Engine(params, CFG, serve=ServeConfig(n_slots=4, max_len=64, page_size=16), runtime=CPU)
    ec = Engine(params, CFG, serve=ServeConfig(n_slots=4, max_len=64, page_size=None),
                runtime=CPU)
    assert ep.layout.paged and not ec.layout.paged
    ep.run(reqs_p)
    ec.run(reqs_c)
    for rp, rc in zip(reqs_p, reqs_c):
        assert rp.out.tolist() == rc.out.tolist()
    assert ec.telemetry()["layout"] == "contiguous"


def test_packed_prefill_matches_unpacked():
    """Packed prefill (several prompts in one segment-masked row) changes the
    call count, not one output token."""
    _, params = _params()
    lens, news = (3, 5, 4, 7, 6, 2), (4,) * 6
    reqs_pk, reqs_un = _mixed_requests(5, lens, news), _mixed_requests(5, lens, news)
    sv = ServeConfig(n_slots=3, max_len=64, page_size=16)
    ep = Engine(params, CFG, serve=sv, runtime=CPU)
    eu = Engine(params, CFG, serve=sv.replace(pack_prefill=False), runtime=CPU)
    ep.run(reqs_pk)
    eu.run(reqs_un)
    for a, b in zip(reqs_pk, reqs_un):
        assert a.out.tolist() == b.out.tolist()
    assert ep.counters["prefill_calls"] < eu.counters["prefill_calls"]


def test_eos_stops_early_and_is_recorded():
    _, params = _params()
    p = np.random.default_rng(11).integers(1, CFG.vocab, size=9).astype(np.int32)
    ref = _reference_decode(params, p, 10, 64)
    eos = ref[3]  # stop at the 4th generated token
    cut = ref.index(eos)  # the first occurrence wins
    eng = Engine(params, CFG, serve=ServeConfig(n_slots=2, max_len=64), runtime=CPU)
    [req] = eng.run([Request(prompt=p, max_new=10, eos=int(eos))])
    assert req.out.tolist() == ref[:cut + 1]  # the eos token included
    assert req.stop == "eos"
    assert eng.ring.records[-1]["stop"] == "eos"
    eng2 = Engine(params, CFG, serve=ServeConfig(n_slots=2, max_len=64, eos=int(eos)),
                  runtime=CPU)
    [req2] = eng2.run([Request(prompt=p, max_new=10)])
    assert req2.out.tolist() == ref[:cut + 1]


def test_one_build_per_bucket_and_single_decode_build():
    """Prompt lengths bucket to powers of two: one built prefill per bucket
    used, one decode and one insert, each counted once at its first call; a
    second run builds nothing new."""
    _, params = _params()
    reqs = _mixed_requests(lens=(3, 5, 9, 17, 30, 11, 23, 4), news=(3, 4, 5, 3, 4, 5, 3, 4))
    sv = ServeConfig(n_slots=4, max_len=64, page_size=16)
    eng = Engine(params, CFG, serve=sv, runtime=CPU)
    assert eng.trace_counts == {}  # nothing counted before a call
    eng.run(reqs)
    tc = eng.trace_counts
    assert tc["decode"] == 1 and tc["insert"] == 1, tc
    prefills = {k: v for k, v in tc.items() if k.startswith("prefill[")}
    assert prefills and all(v == 1 for v in prefills.values()), tc
    assert all(int(k[len("prefill["):-1]) in sv.buckets() for k in prefills), tc
    eng.run(_mixed_requests(seed=2, lens=(6, 10, 29, 13), news=(3, 3, 3, 3)))
    assert all(v == 1 for v in eng.trace_counts.values()), eng.trace_counts


def test_serve_config_buckets():
    sv = ServeConfig(n_slots=2, max_len=64, page_size=16)
    assert sv.buckets() == (16, 32, 64)
    assert sv.bucket_for(1) == 16 and sv.bucket_for(17) == 32
    assert sv.bucket_for(64) == 64
    with pytest.raises(ValueError):
        sv.bucket_for(65)
    with pytest.raises(ValueError, match="multiple of"):
        ServeConfig(max_len=50, page_size=16)
    assert ServeConfig(n_slots=2, max_len=64, page_size=16).pool_pages == 9
    # the geometry of every config equals JAX's
    for kw in (dict(), dict(n_slots=8, max_len=1024), dict(max_len=96, prefill_buckets=(40, 8)),
               dict(n_slots=3, max_len=48, page_size=8, n_pages=7)):
        sv, jsv = ServeConfig(**kw), JServeConfig(**kw)
        assert sv.buckets() == jsv.buckets()
        assert (sv.pages_per_slot, sv.pool_pages) == (jsv.pages_per_slot, jsv.pool_pages)
        assert [sv.bucket_for(n) for n in range(1, sv.max_len + 1)] == \
            [jsv.bucket_for(n) for n in range(1, sv.max_len + 1)]
    for bad in (dict(n_slots=0), dict(max_len=1), dict(page_size=0), dict(prefill_buckets=(0,)),
                dict(max_len=64, prefill_buckets=(65,))):
        with pytest.raises(ValueError):
            ServeConfig(**bad)
        with pytest.raises(ValueError):
            JServeConfig(**bad)


def test_scheduler_page_lifecycle():
    sv = ServeConfig(n_slots=2, max_len=64, page_size=16)
    sched = Scheduler(sv, paged=True)
    assert len(sched.free_pages) == sv.pool_pages - 1  # page 0 reserved
    r = Request(prompt=np.ones(20, np.int32), max_new=10)
    sched.submit([r], now=0.0)
    [taken] = sched.take_wave(pack=True, align=16)
    slot = sched.place(taken, first_tok=1, now=0.0)
    assert len(slot.pages) == 2  # ceil((20 + 10) / 16)
    assert (sched.page_map[slot.idx][:2] > 0).all()
    assert (sched.page_map[slot.idx][2:] == 0).all()  # the tail -> trash page
    assert len(sched.free_pages) == sv.pool_pages - 3
    sched.finish(slot, "length", now=1.0)
    assert len(sched.free_pages) == sv.pool_pages - 1  # all released
    assert (sched.page_map[slot.idx] == 0).all()
    assert r.stop == "length" and r.t_done == 1.0


def test_scheduler_fifo_head_of_line_blocking():
    """A head request that does not fit the free list blocks the queue
    (strict FIFO, no overtaking) and fits again after a release."""
    sv = ServeConfig(n_slots=2, max_len=64, page_size=16, n_pages=5)
    sched = Scheduler(sv, paged=True)
    big = Request(prompt=np.ones(30, np.int32), max_new=30)  # 4 pages
    small = Request(prompt=np.ones(4, np.int32), max_new=4)  # 1 page
    sched.submit([big, small], now=0.0)
    s1 = sched.place(sched.take_wave(pack=True, align=16)[0], 1, 0.0)
    assert sched.take_wave(pack=True, align=16) == []  # 0 free pages: blocked
    assert sched.pending() == 1
    sched.finish(s1, "length", 1.0)
    assert [r is small for r in sched.take_wave(pack=True, align=16)] == [True]


def test_engine_completes_under_page_pressure():
    """A pool with room for about one request at a time slows the engine
    down, never changes a token: FIFO with worst-case reservation cannot
    deadlock."""
    _, params = _params()
    reqs = _mixed_requests(seed=4, lens=(20, 9, 14, 6), news=(8, 6, 4, 6))
    sv = ServeConfig(n_slots=4, max_len=64, page_size=16, n_pages=5)
    eng = Engine(params, CFG, serve=sv, runtime=CPU)
    eng.run(reqs)
    for r in reqs:
        assert r.out.tolist() == _reference_decode(params, r.prompt, r.max_new, 64)


@pytest.mark.parametrize("engine_cls", [Engine, RunToCompletionEngine])
def test_engine_rejects_empty_prompt(engine_cls):
    eng = engine_cls(_params()[1], CFG, batch=2, max_len=32, runtime=CPU)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.run([Request(prompt=np.zeros(0, np.int32), max_new=4)])
    assert eng.counters["batches"] == 0  # rejected before any device work


@pytest.mark.parametrize("engine_cls", [Engine, RunToCompletionEngine])
def test_engine_rejects_unservable_max_new(engine_cls):
    eng = engine_cls(_params()[1], CFG, batch=2, max_len=16, runtime=CPU)
    p = np.ones(4, np.int32)
    with pytest.raises(ValueError, match="max_new"):
        eng.run([Request(prompt=p, max_new=16)])
    with pytest.raises(ValueError, match="max_new"):
        eng.run([Request(prompt=p, max_new=0)])


def test_overlong_prompt_left_truncated_and_recorded():
    _, params = _params()
    long = np.random.default_rng(3).integers(1, CFG.vocab, size=40).astype(np.int32)
    max_new = 4
    eng = Engine(params, CFG, batch=2, max_len=32, runtime=CPU)
    [req] = eng.run([Request(prompt=long, max_new=max_new)])
    keep = long[-(32 - max_new):]  # the most recent max_len - max_new tokens
    assert req.out.tolist() == _reference_decode(params, keep, max_new, 32)
    dropped = len(long) - len(keep)
    assert req.truncated == dropped
    assert eng.counters["truncated_tokens"] == dropped
    assert eng.ring.records[-1]["truncated_tokens"] == dropped


def test_wasted_steps_counted_for_empty_lanes():
    """Two live requests in a 4-slot engine: the two free lanes decode every
    step and are counted, not hidden."""
    _, params = _params()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, CFG.vocab, size=9).astype(np.int32) for _ in range(2)]
    eng = Engine(params, CFG, serve=ServeConfig(n_slots=4, max_len=32), runtime=CPU)
    reqs = eng.run([Request(prompt=p, max_new=4) for p in prompts])
    c = eng.counters
    assert c["decode_steps"] == 3  # the first token comes from prefill
    assert c["wasted_decode_steps"] == 2 * c["decode_steps"]
    assert c["requests_done"] == 2
    for r, p in zip(reqs, prompts):
        assert r.out.tolist() == _reference_decode(params, p, 4, 32)


def test_telemetry_summary_fields():
    _, params = _params()
    eng = Engine(params, CFG, serve=ServeConfig(n_slots=2, max_len=32), runtime=CPU)
    eng.run(_mixed_requests(seed=6, lens=(5, 9, 7), news=(3, 4, 2)))
    t = eng.telemetry()
    assert t["layout"] == "paged"
    assert t["requests_done"] == 3
    assert t["decode_tok_per_s"] > 0 and t["prefill_tok_per_s"] > 0
    assert t["latency_p50_s"] is not None and t["latency_p99_s"] >= t["latency_p50_s"]
    assert t["ttft_p50_s"] is not None
    assert t["trace_counts"]["decode"] == 1
    rec = eng.ring.records[-1]
    assert {"prompt_len", "new_tokens", "stop", "queue_s", "ttft_s", "latency_s"} <= set(rec)


@pytest.mark.parametrize("window,paged", [(None, True), (16, False), (64, True), (128, True)])
def test_cache_layout_of_windowed_configs_as_jax(window, paged):
    """A window shorter than max_len gives ring caches: the contiguous layout,
    as JAX decides; a window of max_len or more stays paged."""
    kw = dict(SERVE, window=window)
    sv = dict(n_slots=4, max_len=64, page_size=16)
    lay = kv_cache.plan_layout(ArchConfig(**kw), ServeConfig(**sv))
    jlay = jkv.plan_layout(JArchConfig(**kw), JServeConfig(**sv))
    assert (lay.paged, lay.pack_ok, lay.pad_ok) == (jlay.paged, jlay.pack_ok, jlay.pad_ok)
    assert lay.paged == paged
    assert set(lay.leaf_kinds) == set(jlay.leaf_kinds)
    assert len(lay.leaf_kinds) == 2 * CFG.n_layers


def _jax_reference_decode(jparams, jcfg, prompt, max_new, max_len):
    """JAX's sequential decoding of one prompt: ``lm.prefill`` at its exact
    length, then greedy ``decode_step``s at batch 1."""
    prefill = jax.jit(lambda p, b: jlm.prefill(p, b, JCtx(), jcfg, max_len))
    decode = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, JCtx(), jcfg))
    logits, caches = prefill(jparams, {"tokens": jnp.asarray(prompt)[None]})
    cur, out = jgreedy(logits[:, -1:]), []
    for t in range(max_new):
        out.append(int(cur[0, 0]))
        logits, caches = decode(jparams, caches, cur, len(prompt) + t)
        cur = jgreedy(logits)
    return out


def test_windowed_engine_matches_jax_engine():
    """A sliding window shorter than max_len: the contiguous engine over ring
    caches. Every request equals the port's sequential decoding; where JAX's
    engine equals JAX's sequential decoding, the port equals JAX's engine
    (counters and ring records on all). JAX's engine departs on the
    23-token request: its bucket of 32 puts 9 pads into the 16-slot ring
    over positions 7-15, which decode reads (ROADMAP Queue 3 item 12); so
    it does on the 17-token one (15 pads over positions 1-15). The port
    fills each ring from the row's valid tokens alone."""
    kw = dict(SERVE, window=16)
    cfg, jcfg = ArchConfig(**kw), JArchConfig(**kw)
    jp = jlm.init_params(jax.random.key(1), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    lens, news = (11, 5, 23, 3, 17), (6, 3, 9, 2, 12)
    reqs, jreqs = _mixed_requests(7, lens, news), _mixed_requests(7, lens, news, cls=JRequest)
    eng = Engine(tp, cfg, serve=ServeConfig(n_slots=2, max_len=64), runtime=CPU)
    jeng = JEngine(jp, jcfg, serve=JServeConfig(n_slots=2, max_len=64))
    assert not eng.layout.paged
    eng.run(reqs)
    jeng.run(jreqs)
    specs = _specs(7, lens, news)
    for r, (p, m) in zip(reqs, specs):
        assert r.out.tolist() == _reference_decode(tp, p, m, 64, cfg)
    kept = [np.asarray(jr.out).tolist() == _jax_reference_decode(jp, jcfg, p, m, 64)
            for jr, (p, m) in zip(jreqs, specs)]
    # JAX departs where the bucket's pads wrap the ring: the 23- and 17-token
    # prompts (bucket 32), not those whose bucket fits the window
    assert kept == [eng.serve.bucket_for(n) <= 16 for n in lens] == [True, True, False, True,
                                                                      False]
    _same_as_jax(*zip(*[(r, jr) for r, jr, k in zip(reqs, jreqs, kept) if k]), eng, jeng)


# ---------------------------------------------------------------------------
# refusals and the host copies
# ---------------------------------------------------------------------------


def test_engines_refuse_what_the_port_cannot_serve():
    """Both engines, and ``Runtime.serve``, refuse an encoder-decoder config
    (as JAX's engine does) and parameters on another device than the
    Runtime's, before any device work; every decoder family is served
    (tests/test_torch_engine_families.py)."""
    _, params = _params()
    seamless = registry.smoke_config("seamless_m4t_large_v2")
    for build in (Engine, RunToCompletionEngine, lambda p, c, runtime: runtime.serve(p, c)):
        for cfg in (ArchConfig(**dict(SERVE, enc_layers=2)), seamless):
            with pytest.raises(ValueError, match="decoder-only"):
                build(params, cfg, runtime=CPU)
        elsewhere = dict(params, embed=params["embed"].to("meta"))
        with pytest.raises(ValueError, match="lie on"):
            build(elsewhere, CFG, runtime=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(params, CFG)  # the default Runtime is the card's


def test_runtime_serve_builds_the_engine_on_its_runtime():
    _, params = _params()
    eng = CPU.serve(params, CFG, serve=ServeConfig(n_slots=2, max_len=32))
    assert isinstance(eng, Engine) and eng.runtime is CPU and eng.serve.n_slots == 2
    legacy = CPU.serve(params, CFG, batch=3, max_len=48)
    assert legacy.serve == ServeConfig(n_slots=3, max_len=48, page_size=16)
    assert CPU.serve(params, CFG, max_len=40).layout.paged is False  # 40 % 16 != 0


def test_one_device_to_host_copy_per_decode_step_and_wave(monkeypatch):
    """The engines read the device once per decode step and once per prefill
    wave (``Tensor.cpu``), and never through ``item`` or ``tolist``."""
    _, params = _params()
    calls = {"cpu": 0, "item": 0, "tolist": 0}
    for name in calls:
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    eng = Engine(params, CFG, serve=ServeConfig(n_slots=4, max_len=64), runtime=CPU)
    eng.run(_mixed_requests())
    c = eng.counters
    assert calls == {"cpu": c["decode_steps"] + c["prefill_calls"], "item": 0, "tolist": 0}
    for k in calls:
        calls[k] = 0
    leg = RunToCompletionEngine(params, CFG, batch=4, max_len=64, runtime=CPU)
    leg.run(_mixed_requests())
    c = leg.counters
    assert calls == {"cpu": c["decode_steps"] + c["prefill_calls"], "item": 0, "tolist": 0}


# ---------------------------------------------------------------------------
# the KV-page functions against JAX's, bit for bit
# ---------------------------------------------------------------------------

SV = dict(n_slots=3, max_len=64, page_size=16)


def _random_pools(seed=0):
    """JAX-layout random pools (numpy) for CFG at SV, and the port's."""
    jsv = JServeConfig(**SV)
    shapes = jax.eval_shape(lambda: jkv.init_pools(JCFG, jsv))
    rng = np.random.default_rng(seed)
    jpools = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    return jpools, pools_from_jax(jpools, CFG, device="cpu")


def _page_map(seed=0):
    """A page map with two live slots on distinct pages and one freed slot."""
    sv = ServeConfig(**SV)
    pages = np.random.default_rng(seed).permutation(np.arange(1, sv.pool_pages))
    pm = np.zeros((sv.n_slots, sv.pages_per_slot), np.int32)
    pm[0, :3] = pages[:3]
    pm[2] = pages[3:3 + sv.pages_per_slot]
    return pm  # slot 1 is free: every entry the trash page 0


def _eq(port_tree, jax_tree):
    want = pools_from_jax(jax.tree.map(np.asarray, jax_tree), CFG, device="cpu")
    for a, b in zip(port_tree, want):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_init_pools_and_gather_slots_equal_jax():
    sv, jsv = ServeConfig(**SV), JServeConfig(**SV)
    zeros = kv_cache.init_pools(CFG, sv, device="cpu")
    _eq(zeros, jkv.init_pools(JCFG, jsv))
    jpools, pools = _random_pools()
    pm = _page_map()
    got = kv_cache.gather_slots(pools, torch.as_tensor(pm), sv)
    _eq(got, jkv.gather_slots(jpools, jnp.asarray(pm), jsv))
    # a copy: writing the gathered caches leaves the pools as they were
    before = [{k: v.clone() for k, v in layer.items()} for layer in pools]
    for layer in got:
        for v in layer.values():
            v.fill_(7.0)
    for a, b in zip(pools, before):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_scatter_token_equals_jax_and_spares_live_pages():
    sv, jsv = ServeConfig(**SV), JServeConfig(**SV)
    jpools, pools = _random_pools(1)
    pm = _page_map(1)
    pos = np.asarray([37, 0, 5], np.int32)  # slot 1 is free (position 0)
    contig = kv_cache.gather_slots(pools, torch.as_tensor(pm), sv)
    rng = np.random.default_rng(2)
    for layer in contig:  # what decode would have written at pos
        for v in layer.values():
            v[torch.arange(3), torch.as_tensor(pos).long()] = torch.as_tensor(
                rng.normal(size=(3,) + tuple(v.shape[2:])).astype(np.float32))
    jcontig = [{k: v.numpy() for k, v in layer.items()} for layer in contig]
    jnew = [[{"kv": {k: np.stack([layer[k] for layer in jcontig]) for k in ("k", "v")}}]]
    before = [{k: v.clone() for k, v in layer.items()} for layer in pools]
    out = kv_cache.scatter_token(pools, contig, torch.as_tensor(pm), torch.as_tensor(pos), sv)
    assert out is pools  # in place
    _eq(pools, jkv.scatter_token(jax.tree.map(jnp.asarray, jpools), jax.tree.map(jnp.asarray, jnew),
                                 jnp.asarray(pm), jnp.asarray(pos), jsv))
    # only (page, offset) of each live slot's position and the trash page change
    for a, b in zip(pools, before):
        for k in a:
            changed = (a[k] != b[k]).flatten(2).any(-1).nonzero().tolist()
            assert set(map(tuple, changed)) <= {(int(pm[0, 37 // 16]), 37 % 16),
                                                (int(pm[2, 0]), 5), (0, 0)}


def test_insert_prompt_pages_equals_jax_and_routes_the_tail_to_trash():
    sv, jsv = ServeConfig(**SV), JServeConfig(**SV)
    jpools, pools = _random_pools(3)
    rng = np.random.default_rng(4)
    # a packed prefill row's caches (batch 1, max_len positions)
    jpref = [[{"kv": {k: rng.normal(size=(CFG.n_layers, 1, 64, 2, 16)).astype(np.float32)
                      for k in ("k", "v")}}]]
    pref = caches_from_jax(jpref, CFG, device="cpu")
    pm = _page_map(3)
    for src_page0, g, slot in ((1, 2, 0), (3, 1, 2), (0, 4, 2)):
        phys = np.where(np.arange(sv.pages_per_slot) < g, pm[slot], 0).astype(np.int32)
        live = [int(p) for p in phys[:g]]
        before = [{k: v.clone() for k, v in layer.items()} for layer in pools]
        kv_cache.insert_prompt_pages(pools, pref, torch.as_tensor(phys), src_page0, sv)
        jpools = jkv.insert_prompt_pages(jax.tree.map(jnp.asarray, jpools),
                                         jax.tree.map(jnp.asarray, jpref), jnp.asarray(phys),
                                         jnp.asarray(src_page0, jnp.int32), jsv)
        _eq(pools, jpools)
        for a, b in zip(pools, before):  # only the slot's pages and trash change
            for k in a:
                changed = (a[k] != b[k]).flatten(1).any(-1).nonzero().flatten().tolist()
                assert set(changed) <= set(live) | {0}
        jpools = jax.tree.map(np.asarray, jpools)


def test_insert_prompt_rows_equals_jax():
    rng = np.random.default_rng(5)
    jdec = [[{"kv": {k: rng.normal(size=(CFG.n_layers, 3, 64, 2, 16)).astype(np.float32)
                     for k in ("k", "v")}}]]
    jpref = [[{"kv": {k: rng.normal(size=(CFG.n_layers, 1, 64, 2, 16)).astype(np.float32)
                      for k in ("k", "v")}}]]
    dec = caches_from_jax(jdec, CFG, device="cpu")
    pref = caches_from_jax(jpref, CFG, device="cpu")
    assert kv_cache.insert_prompt_rows(dec, pref, 1) is dec  # in place
    jarr = jax.tree.map(jnp.asarray, (jdec, jpref))
    _eq(dec, jkv.insert_prompt_rows(*jarr, jnp.asarray(1, jnp.int32)))
