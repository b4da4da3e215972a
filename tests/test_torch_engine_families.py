"""The serving engines on every ported decoder family, on the CPU against JAX.

The smoke configs of olmoe-1b-7b (MoE, paged), mixtral-8x22b (MoE over
ring caches), gemma3-1b (local rings of 16 and global layers), rwkv6-3b
(recurrent state), zamba2-7b (Mamba state and the shared attention block)
and qwen2-vl-2b (M-RoPE, text prompts) run through the continuous engine,
paged and contiguous, and the run-to-completion engine in both packages, on
JAX's ``lm.init_params`` weights (``params_from_jax``) and the same numpy
requests. The reference is each package's own sequential decoding: prefill
at the exact prompt length, then greedy decode steps at batch 1.

The engines' contract is ``tests/test_serve.py``'s: every request's greedy
tokens equal sequential decoding. The port keeps it on every request. Where
JAX's engine keeps it too, the port equals JAX's engine. JAX's
run-to-completion engine pads recurrent state and departs on the padded
rows (ROADMAP Queue 3 item 13); the port prefills those rows unpadded. MoE
capacity is shared by the tokens of a packed prefill row, pads included
(item 14): the port keeps that, so at a capacity factor of 1.0 it gives
JAX's tokens for the same waves.

Tolerances: greedy tokens, stop reasons and every counter that is not a
timing are compared exactly; cache moves (``insert_prompt_rows``) bit for
bit; ring caches filled from a padded row against the exact-length
prefill's within 1e-5 (the two prefills sum in other orders). Everything
runs on one intra-op thread.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.runtime import Runtime as JRuntime
from repro.configs import registry as jreg
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
from repro_torch.interop import caches_from_jax, params_from_jax
from repro_torch.models import lm
from repro_torch.nn import moe
from repro_torch.nn.common import Ctx
from repro_torch.serve import greedy_sample, kv_cache
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.legacy import RunToCompletionEngine

ARCHS = ("olmoe_1b_7b", "mixtral_8x22b", "gemma3_1b", "rwkv6_3b", "zamba2_7b", "qwen2_vl_2b")
# plan_layout's (paged, pack_ok, pad_ok) and leaf kinds at SV, as JAX plans them
LAYOUTS = {
    "olmoe_1b_7b": (True, True, True, {"kv_full"}),
    "mixtral_8x22b": (False, False, True, {"kv_ring"}),
    "gemma3_1b": (False, False, True, {"kv_ring", "kv_full"}),
    "rwkv6_3b": (False, False, False, {"state"}),
    "zamba2_7b": (False, False, False, {"state", "kv_full"}),
    "qwen2_vl_2b": (True, True, True, {"kv_full"}),
}
RECURRENT = ("rwkv6_3b", "zamba2_7b")
SV = dict(n_slots=2, max_len=64, page_size=16)
LEGACY_BATCH = 2
# the requests: numpy seed 0; the 23-token prompt's bucket of 32 wraps
# gemma3's 16-slot rings, and the legacy batches (11, 5) and (23, 3) pad
LENS, NEWS, SEED = (11, 5, 23, 3), (6, 3, 9, 2), 0
# two packed waves: four prompts of at most a page each fill the first
# 64-token row and finish together; four more fill the second
PACKED_SV = dict(n_slots=4, max_len=64, page_size=16)
PACKED_LENS, PACKED_NEWS, PACKED_SEED = (9, 14, 5, 16, 12, 7, 3, 15), (3, 3, 3, 3, 5, 4, 6, 2), 1
# chip_smoke.py's routing near tie: a request with a token whose k-th and
# (k+1)-th router probabilities are closer than this may route differently
# under another float32 summation order
ROUTER_TIE = 1e-5
TIMING = ("prefill_s", "decode_s", "decode_tok_per_s", "prefill_tok_per_s", "latency_p50_s",
          "latency_p99_s", "ttft_p50_s", "ttft_p99_s")
RING_TIMING = ("queue_s", "ttft_s", "latency_s", "span_id", "prefill_s", "decode_s")
CPU = Runtime(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test processes share the cores, and one
    thread keeps the CPU's float32 sums in one order between calls."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(JAX params, the port's params on the CPU): the same weights."""
    jparams = jax.device_get(jlm.init_params(jax.random.key(1), jreg.smoke_config(arch)))
    return jparams, params_from_jax(jparams, registry.smoke_config(arch), device="cpu")


def _cfgs(arch, **kw):
    return jreg.smoke_config(arch).replace(**kw), registry.smoke_config(arch).replace(**kw)


def _specs(lens=LENS, news=NEWS, seed=SEED):
    rng = np.random.default_rng(seed)
    return tuple((rng.integers(1, 256, size=n).astype(np.int32), m) for n, m in zip(lens, news))


def _requests(specs, cls=Request):
    return [cls(prompt=p.copy(), max_new=m) for p, m in specs]


def _tokens(reqs):
    return [np.asarray(r.out).tolist() for r in reqs]


def _no_timing(d, drop=TIMING):
    return {k: v for k, v in d.items() if k not in drop}


_SEQ = {}


def _port_sequential(arch, specs, max_len=64):
    """The port's sequential decoding of each request."""
    cfg = registry.smoke_config(arch)
    params = _params(arch)[1]
    prefill, decode = CPU.prefill_step(cfg, max_len), CPU.decode_step(cfg)
    out = []
    for p, m in specs:
        key = ("port", cfg, tuple(p.tolist()), m, max_len)
        if key not in _SEQ:
            logits, caches = prefill(params, {"tokens": p[None]})
            cur, toks = greedy_sample(logits[:, -1:]), []
            for t in range(m):
                toks.append(int(cur[0, 0]))
                if t + 1 < m:
                    logits, caches = decode(params, caches, cur, len(p) + t)
                    cur = greedy_sample(logits)
            _SEQ[key] = toks
        out.append(_SEQ[key])
    return out


@functools.lru_cache(maxsize=None)
def _jax_steps(jcfg, max_len):
    rt = JRuntime()
    return jax.jit(rt.prefill_step(jcfg, max_len)), jax.jit(rt.decode_step(jcfg))


def _jax_sequential(arch, specs, max_len=64):
    """JAX's sequential decoding of each request: ``lm.prefill`` at the exact
    prompt length, then ``decode_step``."""
    jcfg = jreg.smoke_config(arch)
    jparams = _params(arch)[0]
    prefill, decode = _jax_steps(jcfg, max_len)
    out = []
    for p, m in specs:
        key = ("jax", jcfg, tuple(p.tolist()), m, max_len)
        if key not in _SEQ:
            logits, caches = prefill(jparams, {"tokens": jnp.asarray(p)[None]})
            cur, toks = jgreedy(logits[:, -1:]), []
            for t in range(m):
                toks.append(int(cur[0, 0]))
                if t + 1 < m:
                    logits, caches = decode(jparams, caches, cur, len(p) + t)
                    cur = jgreedy(logits)
            _SEQ[key] = toks
        out.append(_SEQ[key])
    return out


_JAX_RUNS = {}


def _jax_engine(arch, how, specs=None, sv=SV, **kw):
    """JAX's engine (``how``: a page size or None) or its run-to-completion
    engine (``how="legacy"``) on ``specs``: (requests, telemetry, ring
    records), cached per arguments."""
    specs = _specs() if specs is None else specs
    key = (arch, how, tuple((tuple(p.tolist()), m) for p, m in specs),
           tuple(sorted(sv.items())), tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        jcfg, _ = _cfgs(arch, **kw)
        jparams = _params(arch)[0]
        if how == "legacy":
            eng = JLegacy(jparams, jcfg, batch=LEGACY_BATCH, max_len=sv["max_len"])
        else:
            eng = JEngine(jparams, jcfg, serve=JServeConfig(**dict(sv, page_size=how)))
        reqs = eng.run(_requests(specs, JRequest))
        _JAX_RUNS[key] = (reqs, eng.telemetry(), list(eng.ring.records))
    return _JAX_RUNS[key]


def _port_engine(arch, how, specs=None, sv=SV, **kw):
    specs = _specs() if specs is None else specs
    _, cfg = _cfgs(arch, **kw)
    params = _params(arch)[1]
    if how == "legacy":
        eng = RunToCompletionEngine(params, cfg, batch=LEGACY_BATCH, max_len=sv["max_len"],
                                    runtime=CPU)
    else:
        eng = Engine(params, cfg, serve=ServeConfig(**dict(sv, page_size=how)), runtime=CPU)
    return eng, eng.run(_requests(specs))


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_layout_equals_jax(arch):
    jcfg, cfg = _cfgs(arch)
    lay = kv_cache.plan_layout(cfg, ServeConfig(**SV))
    jlay = jkv.plan_layout(jcfg, JServeConfig(**SV))
    assert (lay.paged, lay.pack_ok, lay.pad_ok) == (jlay.paged, jlay.pack_ok, jlay.pad_ok)
    assert set(lay.leaf_kinds) == set(jlay.leaf_kinds)
    assert (lay.paged, lay.pack_ok, lay.pad_ok, set(lay.leaf_kinds)) == LAYOUTS[arch]
    # contiguous when asked: nothing else changes
    flat = kv_cache.plan_layout(cfg, ServeConfig(**dict(SV, page_size=None)))
    assert (flat.paged, flat.pack_ok, flat.pad_ok) == (False, lay.pack_ok, lay.pad_ok)


def test_plan_layout_names_cross_attention_as_jax():
    """The encoder-decoder's cross-attention memory is its own leaf kind, as
    in JAX (the engines refuse the config before they plan)."""
    jcfg, cfg = _cfgs("seamless_m4t_large_v2")
    lay = kv_cache.plan_layout(cfg, ServeConfig(**SV))
    jlay = jkv.plan_layout(jcfg, JServeConfig(**SV))
    assert set(lay.leaf_kinds) == set(jlay.leaf_kinds) == {"kv_full", "cross"}
    assert (lay.paged, lay.pack_ok, lay.pad_ok) == (jlay.paged, jlay.pack_ok, jlay.pad_ok)


# ---------------------------------------------------------------------------
# the continuous engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("page_size", [16, None])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_matches_jax_and_sequential(arch, page_size):
    """Paged (where the layout allows) and contiguous: every request equals
    the port's sequential decoding; where JAX's engine equals JAX's
    sequential decoding, the port equals JAX's engine; every counter that
    is not a timing, the build counts and the ring records equal JAX's."""
    specs = _specs()
    eng, reqs = _port_engine(arch, page_size)
    jreqs, jtele, jring = _jax_engine(arch, page_size)
    assert eng.layout.paged == (page_size is not None and LAYOUTS[arch][0])
    assert _tokens(reqs) == _port_sequential(arch, specs)
    kept = [a == b for a, b in zip(_tokens(jreqs), _jax_sequential(arch, specs))]
    for r, jr, k in zip(reqs, jreqs, kept):
        if k:
            assert r.out.tolist() == np.asarray(jr.out).tolist()
        assert (r.stop, r.truncated) == (jr.stop, jr.truncated)
    assert _no_timing(eng.telemetry()) == _no_timing(jtele)
    assert ([_no_timing(x, RING_TIMING) for x in eng.ring.records]
            == [_no_timing(x, RING_TIMING) for x in jring])


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_waves_are_one_prompt_at_its_exact_length(arch):
    """A recurrent layout prefills each request alone at its own length: one
    wave and one build per request (the lengths are distinct), no padded
    token."""
    eng, _ = _port_engine(arch, None)
    c = eng.telemetry()
    assert c["prefill_calls"] == c["batches"] == len(LENS)
    assert c["prefill_tokens"] == sum(LENS)
    assert {k for k in c["trace_counts"] if k.startswith("prefill[")} == {
        f"prefill[{n}]" for n in LENS}


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "qwen2_vl_2b"])
def test_two_packed_waves_match_jax_and_sequential(arch):
    """Four prompts share each of two packed prefill rows: the port equals
    JAX's engine, token for token and counter for counter, and its own
    sequential decoding."""
    specs = _specs(PACKED_LENS, PACKED_NEWS, PACKED_SEED)
    eng, reqs = _port_engine(arch, 16, specs, PACKED_SV)
    jreqs, jtele, _ = _jax_engine(arch, 16, specs, PACKED_SV)
    assert eng.counters["prefill_calls"] == 2 and eng.counters["batches"] == 2
    assert _tokens(reqs) == _tokens(jreqs) == _port_sequential(arch, specs)
    assert _no_timing(eng.telemetry()) == _no_timing(jtele)


def test_olmoe_packed_equals_unpacked_at_the_smoke_capacity():
    """At the smoke capacity factor (8.0) no replica is dropped, so packing
    changes no token."""
    specs = _specs(PACKED_LENS, PACKED_NEWS, PACKED_SEED)
    eng, packed = _port_engine("olmoe_1b_7b", 16, specs, PACKED_SV)
    _, unpacked = _port_engine("olmoe_1b_7b", 16, specs, dict(PACKED_SV, pack_prefill=False))
    assert eng.counters["prefill_calls"] < len(specs)
    assert _tokens(packed) == _tokens(unpacked)


class _RouteSpy:
    """Wraps ``nn.moe._moe_local`` and records, per call, the replicas the
    capacity dropped and each row's router margin (k-th against (k+1)-th
    probability) with the request the row belongs to (``rows``: request
    index per row, -1 for a pad or a free lane). Nothing of the layer's
    output changes."""

    def __init__(self):
        self.real, self.rows, self.kind, self.calls = moe._moe_local, None, None, []

    def __call__(self, router_w, wi, wg, wo, x2d, ctx, cfg, e_offset, n_total, cap):
        k = cfg.top_k
        probs = torch.softmax(x2d.float() @ router_w.float().t(), dim=-1)
        top = torch.topk(probs, k + 1, dim=-1)
        flat = top.indices[:, :k].reshape(-1)
        counts = torch.bincount(flat, minlength=n_total)
        self.calls.append(dict(rows=np.asarray(self.rows), kind=self.kind,
                               margin=(top.values[:, k - 1] - top.values[:, k]).numpy(),
                               dropped=int((counts - cap).clamp_min(0).sum())))
        return self.real(router_w, wi, wg, wo, x2d, ctx, cfg, e_offset, n_total, cap)

    def near_ties(self):
        """Indices of the requests with a row below ROUTER_TIE; a pad's or a
        free lane's near tie marks every request of its call (they share
        the capacity)."""
        out = set()
        for c in self.calls:
            low = c["margin"] < ROUTER_TIE
            if (c["rows"][low] < 0).any():
                out |= set(c["rows"][c["rows"] >= 0].tolist())
            out |= set(c["rows"][low & (c["rows"] >= 0)].tolist())
        return out


def test_olmoe_capacity_drops_follow_the_packed_wave_as_in_jax(monkeypatch):
    """At capacity factor 1.0 a packed prefill row of 64 tokens gives each
    expert ceil(64 * 2 * 1.0 / 8) = 16 slots, shared by the row's four
    prompts and its pads, and decode at 4 slots one each: replicas drop,
    and which depends on the wave. The port's packed run equals JAX's on the
    same waves, token for token, but for requests with a router near tie,
    which are printed and left out."""
    specs = _specs(PACKED_LENS, PACKED_NEWS, PACKED_SEED)
    _, cfg = _cfgs("olmoe_1b_7b", capacity_factor=1.0)
    eng = Engine(_params("olmoe_1b_7b")[1], cfg, serve=ServeConfig(**PACKED_SV), runtime=CPU)
    spy = _RouteSpy()
    monkeypatch.setattr(moe, "_moe_local", spy)
    reqs = _requests(specs)
    index = {id(r): i for i, r in enumerate(reqs)}
    prefill_wave, decode_one = eng._prefill_wave, eng._decode_one_step

    def wave(w, align):
        offs = np.cumsum([0] + [-(-len(r.prompt) // align) * align for r in w])
        rows = np.full(eng.serve.bucket_for(int(offs[-1])), -1)
        for r, o in zip(w, offs):
            rows[o:o + len(r.prompt)] = index[id(r)]
        spy.rows, spy.kind = rows, "prefill"
        prefill_wave(w, align)

    def step():
        spy.rows = [-1 if s.req is None else index[id(s.req)] for s in eng.scheduler.slots]
        spy.kind = "decode"
        decode_one()

    monkeypatch.setattr(eng, "_prefill_wave", wave)
    monkeypatch.setattr(eng, "_decode_one_step", step)
    eng.run(reqs)
    jreqs, jtele, _ = _jax_engine("olmoe_1b_7b", 16, specs, PACKED_SV, capacity_factor=1.0)
    assert eng.counters["prefill_calls"] == 2
    # every layer of both waves drops replicas, and decode does
    prefill = [c["dropped"] for c in spy.calls if c["kind"] == "prefill"]
    assert len(prefill) == 2 * cfg.n_layers and min(prefill) > 0, prefill
    assert sum(c["dropped"] for c in spy.calls if c["kind"] == "decode") > 0
    ties = spy.near_ties()
    if ties:
        print(f"router near ties (< {ROUTER_TIE}) in requests {sorted(ties)}: left out")
    assert len(ties) < len(specs)
    for i, (r, jr) in enumerate(zip(reqs, jreqs)):
        if i not in ties:
            assert r.out.tolist() == np.asarray(jr.out).tolist(), f"request {i}"
    assert _no_timing(eng.telemetry()) == _no_timing(jtele)


# ---------------------------------------------------------------------------
# the run-to-completion engine
# ---------------------------------------------------------------------------


def _padded_rows(lens, batch):
    """Indices of the requests whose prompt is shorter than its batch's
    longest (the rows JAX's run-to-completion engine right-pads)."""
    return [i for i, n in enumerate(lens) if n < max(lens[i - i % batch:i - i % batch + batch])]


@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_engine_equals_sequential(arch):
    """The run-to-completion engine equals the port's sequential decoding on
    every request, padded rows included. A padded layout counts as JAX's
    does; a recurrent one prefills each batch's rows of each length in one
    call, unpadded, and counts those calls and the prompts' own tokens,
    where JAX pads its state and departs on every padded row (ROADMAP
    Queue 3 item 13)."""
    specs = _specs()
    eng, reqs = _port_engine(arch, "legacy")
    jreqs, jtele, _ = _jax_engine(arch, "legacy")
    assert _tokens(reqs) == _port_sequential(arch, specs)
    tele = _no_timing(eng.telemetry())
    jtele = _no_timing(jtele)
    if arch in RECURRENT:
        padded = _padded_rows(LENS, LEGACY_BATCH)
        assert padded == [1, 3]
        jseq = _jax_sequential(arch, specs)
        for i, (jr, want) in enumerate(zip(_tokens(jreqs), jseq)):
            assert (jr != want) == (i in padded), f"request {i}"
        assert tele.pop("prefill_calls") == len(LENS)  # distinct lengths in each batch
        assert tele.pop("prefill_tokens") == sum(LENS)
        assert tele.pop("trace_counts") == dict({f"prefill[{n}]": 1 for n in LENS}, decode=1)
        for k in ("prefill_calls", "prefill_tokens", "trace_counts"):
            jtele.pop(k)
    assert tele == jtele


def test_legacy_engine_prefills_equal_lengths_together():
    """Recurrent rows of one length share one unpadded prefill call (one
    build), and a short final batch's padding lane stays out of it."""
    specs = _specs((7, 7, 4, 7, 4), (3, 2, 4, 2, 3), seed=2)
    params = _params("rwkv6_3b")[1]
    eng = RunToCompletionEngine(params, registry.smoke_config("rwkv6_3b"), batch=3, max_len=64,
                                runtime=CPU)
    reqs = eng.run(_requests(specs))
    assert _tokens(reqs) == _port_sequential("rwkv6_3b", specs)
    c = eng.counters
    assert (c["batches"], c["prefill_calls"], c["prefill_tokens"]) == (2, 4, 29)
    assert eng.trace_counts == {"prefill[7]": 1, "prefill[4]": 1, "decode": 1}
    assert c["dead_slot_steps"] == 2  # the second batch's empty lane, two steps


# ---------------------------------------------------------------------------
# the ring repair, cache moves and the recurrent segment rule
# ---------------------------------------------------------------------------


def test_ring_prefill_of_a_padded_row_keeps_the_prompts_last_window():
    """gemma3's local rings (16 slots) filled from a 23-token prompt padded
    to its bucket of 32: the port's rings hold the prompt's positions 7-22
    at their slots, as the exact-length prefill's do; JAX's hold the pads'
    keys at the slots of positions 7-15 (ROADMAP Queue 3 item 12)."""
    jcfg, cfg = _cfgs("gemma3_1b")
    jparams, params = _params("gemma3_1b")
    p = _specs()[2][0]
    assert len(p) == 23
    toks, segs = np.zeros((1, 32), np.int32), np.zeros((1, 32), np.int32)
    toks[0, :23], segs[0, :23] = p, 1
    padded = {"tokens": toks, "segments": segs}
    _, exact = lm.prefill(params, {"tokens": torch.as_tensor(p).long()[None]}, Ctx(), cfg, 64)
    _, got = lm.prefill(params, {k: torch.as_tensor(v).long() for k, v in padded.items()},
                        Ctx(), cfg, 64)
    rings = [i for i, k in enumerate(lm.layer_kinds(cfg)) if k.window]
    assert rings and all(exact[i]["k"].shape[1] == 16 for i in rings)
    for i in rings:
        for name in ("k", "v"):
            torch.testing.assert_close(got[i][name], exact[i][name], rtol=1e-5, atol=1e-5)
    _, jexact = jlm.prefill(jparams, {"tokens": jnp.asarray(p)[None]}, JCtx(), jcfg, 64)
    _, jgot = jlm.prefill(jparams, {k: jnp.asarray(v) for k, v in padded.items()}, JCtx(),
                          jcfg, 64)
    jexact = caches_from_jax(jax.device_get(jexact), cfg, device="cpu")
    jgot = caches_from_jax(jax.device_get(jgot), cfg, device="cpu")
    for i in rings:
        torch.testing.assert_close(jexact[i]["k"], exact[i]["k"], rtol=1e-5, atol=1e-5)
        bad = (jgot[i]["k"] - jexact[i]["k"]).abs().amax(dim=(0, 2, 3)) > 1e-3
        assert bad.nonzero().flatten().tolist() == list(range(7, 16))


def _random_caches(jcfg, batch, seed):
    """JAX's cache tree of ``jcfg`` at ``batch`` rows filled with numpy
    normals (float32 leaves) from ``seed``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jlm.init_cache(jcfg, batch, 64))
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)


@pytest.mark.parametrize("arch", RECURRENT)
def test_insert_prompt_rows_equals_jax_on_recurrent_states(arch):
    """The contiguous insert copies every leaf of a recurrent state (nested
    per layer, batch first) into its slot: bit for bit JAX's."""
    jcfg, cfg = _cfgs(arch)
    jdec, jpref = _random_caches(jcfg, 3, 5), _random_caches(jcfg, 1, 6)
    dec = caches_from_jax(jdec, cfg, device="cpu")
    pref = caches_from_jax(jpref, cfg, device="cpu")
    assert kv_cache.insert_prompt_rows(dec, pref, 2) is dec  # in place
    want = caches_from_jax(jax.device_get(jkv.insert_prompt_rows(
        jax.tree.map(jnp.asarray, jdec), jax.tree.map(jnp.asarray, jpref),
        jnp.asarray(2, jnp.int32))), cfg, device="cpu")
    kinds = {k.kind for k in lm.layer_kinds(cfg)}
    assert kinds & {"rwkv", "mamba"}
    for layer, wlayer in zip(dec, want):
        assert layer.keys() == wlayer.keys()
        for k in layer:
            assert torch.equal(layer[k], wlayer[k]), k


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_takes_one_unpadded_segment(arch):
    """An exact-length wave's segment ids (one segment, no pad) reach the
    recurrent layers: the caches and logits equal the prefill without
    segments exactly, and JAX's (which ignores them) within 1e-5. A packed
    row still raises, in the model and in the prefill step, which checks
    its host segments before the copy to the device."""
    jcfg, cfg = _cfgs(arch)
    jparams, params = _params(arch)
    p = _specs()[0][0]
    toks = torch.as_tensor(p).long()[None]
    one = torch.ones_like(toks)
    logits, caches = lm.prefill(params, {"tokens": toks, "segments": one}, Ctx(), cfg, 64)
    plain, plain_caches = lm.prefill(params, {"tokens": toks}, Ctx(), cfg, 64)
    assert torch.equal(logits, plain)
    for layer, want in zip(caches, plain_caches):
        for k in layer:
            assert torch.equal(layer[k], want[k])
    jlogits, _ = jlm.prefill(jparams, {"tokens": jnp.asarray(p)[None],
                                       "segments": jnp.ones((1, len(p)), jnp.int32)},
                             JCtx(), jcfg, 64)
    torch.testing.assert_close(logits, torch.as_tensor(np.array(jlogits)), rtol=1e-5,
                               atol=1e-5)
    packed = torch.as_tensor([[1] * 5 + [2] * (len(p) - 5)])
    with pytest.raises(ValueError, match="one segment without padding"):
        lm.prefill(params, {"tokens": toks, "segments": packed}, Ctx(), cfg, 64)
    with pytest.raises(ValueError, match="one segment without padding"):
        CPU.prefill_step(cfg, 64)(params, {"tokens": toks.numpy(), "segments": packed.numpy()})


# ---------------------------------------------------------------------------
# every decoder config is served
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [a for a in registry.ARCH_IDS if a != "seamless_m4t_large_v2"])
def test_every_decoder_config_is_served_by_both_engines(arch):
    """Every named config's smoke variant but the encoder-decoder's passes
    the engines' checks and serves two requests, paged or contiguous as its
    layout allows, and run to completion, each equal to sequential
    decoding."""
    cfg = registry.smoke_config(arch)
    params = lm.init_params(3, cfg, device="cpu")
    specs = _specs((9, 4), (3, 2), seed=4)
    want = []
    prefill, decode = CPU.prefill_step(cfg, 32), CPU.decode_step(cfg)
    for p, m in specs:
        logits, caches = prefill(params, {"tokens": p[None]})
        cur, toks = greedy_sample(logits[:, -1:]), []
        for t in range(m):
            toks.append(int(cur[0, 0]))
            logits, caches = decode(params, caches, cur, len(p) + t)
            cur = greedy_sample(logits)
        want.append(toks)
    for eng in (Engine(params, cfg, serve=ServeConfig(n_slots=2, max_len=32), runtime=CPU),
                RunToCompletionEngine(params, cfg, batch=2, max_len=32, runtime=CPU)):
        assert _tokens(eng.run(_requests(specs))) == want
