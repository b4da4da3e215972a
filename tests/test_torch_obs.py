"""The port's observability layer (``repro_torch.obs``) on the CPU: spans and
their Chrome-trace and JSONL exports, the metrics registry, the compile and
memory ledgers, the flight recorder, and their hooks in the Runtime, the
trainer, the checkpoint writer and the serving engine.

Ports of ``tests/test_obs.py``'s tests that need no resilience. Where the
JAX package computes the same thing (registry snapshots, Prometheus text,
ledger summaries, memory summaries, config validation), the same sequence of
operations runs through both and the results must be equal exactly: these
are host computations with no float reordering. Observability must never
change a number: a trainer run with it on equals one with it off bit for bit
(one intra-op thread, as the trainer tests run).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.obs import ObsConfig as JObsConfig
from repro.obs import observability as jobservability
from repro.obs.flight import FlightRecorder as JFlightRecorder
from repro.obs.ledgers import CompileLedger as JCompileLedger
from repro.obs.ledgers import memory_summary as jmemory_summary
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.obs.tracing import Tracer as JTracer
from repro_torch.api import ExecutionConfig, Observability, ObsConfig, Runtime, ServeConfig
from repro_torch.api import SketchConfig, SketchPolicy, StragglerController
from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import LMStream
from repro_torch.models import lm
from repro_torch.obs import NULL_OBS, clock, ledgers, observability
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.ledgers import CompileLedger, first_call_memory, memory_summary
from repro_torch.obs.metrics import CounterView, MetricsRegistry
from repro_torch.obs.tracing import NULL_TRACER, Tracer
from repro_torch.optim import sgd
from repro_torch.serve.engine import Engine, Request
from repro_torch.train.trainer import TrainerConfig, train_loop
from repro_torch.tree import tree_leaves

TINY = dict(name="obs-tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
            d_ff=128, vocab=128, q_chunk=32, kv_chunk=32)
SERVE_CFG = ArchConfig(name="obs-test", family="dense", n_layers=2, d_model=64, n_heads=4,
                       n_kv=2, d_ff=128, vocab=256, q_chunk=32, kv_chunk=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the bit-for-bit comparison of two trainer runs
    needs the CPU's reductions in one order on every call."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _obs_cfg(tmp_path, **kw):
    """A per-test ObsConfig: ``observability()`` shares state between equal
    configs, so the test's own crash_dir keeps its tracer and registries
    apart."""
    kw.setdefault("crash_dir", str(tmp_path / "crash"))
    return ObsConfig(**kw)


def _data(seed=0):
    return LMStream(vocab=TINY["vocab"], seed=seed).batches(4, 16)


def _runtime(obs=None, policy=None):
    return Runtime(policy=policy, execution=ExecutionConfig(obs=obs), device="cpu")


# ---------------------------------------------------------------------------
# config and shared state
# ---------------------------------------------------------------------------


def test_obsconfig_validation_and_keyed_sharing(tmp_path):
    for bad in (dict(trace_capacity=0), dict(flight_capacity=0)):
        with pytest.raises(ValueError):
            ObsConfig(**bad)
        with pytest.raises(ValueError):
            JObsConfig(**bad)
    cfg = _obs_cfg(tmp_path)
    assert hash(cfg) == hash(_obs_cfg(tmp_path))  # frozen and hashable
    assert observability(cfg) is observability(_obs_cfg(tmp_path))  # one state per config
    assert isinstance(observability(cfg), Observability)
    assert observability(None) is NULL_OBS
    assert not NULL_OBS.enabled
    assert NULL_OBS.tracer is NULL_TRACER
    assert NULL_OBS.report() == {"enabled": False}
    assert NULL_OBS.dump_crash("anything") is None
    # the same fields and defaults as JAX's
    assert ([(f.name, f.default) for f in dataclasses.fields(ObsConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JObsConfig)])


def test_execution_config_takes_obs_and_stays_hashable(tmp_path):
    ex = ExecutionConfig(obs=_obs_cfg(tmp_path))
    assert hash(ex) == hash(ExecutionConfig(obs=_obs_cfg(tmp_path)))
    assert hash(_runtime(_obs_cfg(tmp_path))) == hash(_runtime(_obs_cfg(tmp_path)))
    with pytest.raises(ValueError, match="ObsConfig"):
        ExecutionConfig(obs="trace please")


def test_runtime_observability_accessor(tmp_path):
    cfg = _obs_cfg(tmp_path)
    rt = _runtime(cfg)
    assert rt.observability() is observability(cfg)
    assert _runtime().observability() is NULL_OBS


def test_disabled_features_are_none(tmp_path):
    ob = observability(_obs_cfg(tmp_path, trace=False, metrics=False, compile_ledger=False,
                                memory_ledger=False, flight=False))
    assert ob.tracer is NULL_TRACER
    assert ob.metrics is None and ob.flight is None
    assert ob.compile_ledger is None and ob.memory_ledger is None
    assert ob.dump_crash("no-flight") is None


# ---------------------------------------------------------------------------
# the tracer and its exports
# ---------------------------------------------------------------------------


def test_tracer_nesting_and_ring_bound():
    tr = Tracer(capacity=4)
    with tr.span("outer", step=1) as outer:
        assert tr.current_id() == outer.sid
        with tr.span("inner") as inner:
            assert inner.parent == outer.sid
            assert tr.current_id() == inner.sid
    assert tr.current_id() is None
    [inner_done, outer_done] = tr.spans()  # completion order
    assert (inner_done.name, outer_done.name) == ("inner", "outer")
    assert outer_done.attrs == {"step": 1}
    assert 0.0 <= inner_done.duration_s <= outer_done.duration_s
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.spans()) == 4  # bounded ring: oldest dropped
    tr.clear()
    assert tr.spans() == []


def test_tracer_records_error_spans():
    tr = Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("doomed"):
            raise RuntimeError("boom")
    [s] = tr.spans("doomed")
    assert s.attrs["error"] == "RuntimeError"


def test_add_span_returns_joinable_id():
    tr = Tracer()
    sid = tr.add_span("request", 1.0, 3.0, stop="eos")
    tr.add_span("decode", 2.0, 3.0, parent=sid)
    [req] = tr.spans("request")
    [dec] = tr.spans("decode")
    assert req.sid == sid and dec.parent == sid
    assert req.duration_s == 2.0


def test_spans_and_records_equal_jax_on_explicit_stamps():
    """The same explicit spans give JAX's records and Chrome events."""
    tr, jtr = Tracer(), JTracer()
    tr.origin = jtr.origin = 0.5
    for t in (tr, jtr):
        sid = t.add_span("request", 1.0, 3.0, stop="length", new_tokens=4)
        t.add_span("queued", 1.0, 1.25, parent=sid)
        t.add_span("open", 2.0, -1.0)  # still open: zero width in Chrome form
    assert tr.records() == jtr.records()
    assert tr.to_chrome() == jtr.to_chrome()


def test_chrome_trace_roundtrip(tmp_path):
    """export_chrome writes the JSON object Perfetto loads: complete events
    (ph "X"), microsecond times from the tracer origin, span and parent ids
    under args."""
    tr = Tracer()
    with tr.span("parent", step=3):
        with tr.span("child"):
            pass
    path = tr.export_chrome(str(tmp_path / "sub" / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    assert [e["name"] for e in events] == ["child", "parent"]
    by_name = {e["name"]: e for e in events}
    for e in events:
        assert e["ph"] == "X" and e["pid"] == 1
        assert e["dur"] >= 0.0 and e["ts"] >= 0.0
    assert by_name["child"]["args"]["parent_id"] == by_name["parent"]["args"]["span_id"]
    assert by_name["parent"]["args"]["step"] == 3
    p, c = by_name["parent"], by_name["child"]
    assert p["ts"] <= c["ts"]
    assert c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1e-6


def test_jsonl_export_one_record_per_span(tmp_path):
    tr = Tracer()
    for i in range(3):
        with tr.span("step", step=i):
            pass
    path = tr.export_jsonl(str(tmp_path / "spans.jsonl"))
    recs = [json.loads(line) for line in open(path) if line.strip()]
    assert [r["name"] for r in recs] == ["step"] * 3
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(r["dur_s"] >= 0 and "sid" in r for r in recs)


def test_null_tracer_is_falsy_noop():
    assert not NULL_TRACER and not NULL_TRACER.enabled
    with NULL_TRACER.span("x", a=1) as s:
        assert s is None
    assert NULL_TRACER.add_span("x", 0.0, 1.0) is None
    assert NULL_TRACER.spans() == [] and NULL_TRACER.records() == []
    assert NULL_TRACER.to_chrome()["traceEvents"] == []


def test_annotated_spans_show_in_the_profiler():
    """``annotate=True`` opens a ``torch.profiler.record_function`` range per
    span (JAX opens a TraceAnnotation); without it the profiler sees none."""
    from torch.profiler import ProfilerActivity, profile

    for annotate in (True, False):
        tr = Tracer(annotate=annotate)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tr.span("obs_annotated_span"):
                torch.ones(4).sum()
        names = {e.key for e in prof.key_averages()}
        assert ("obs_annotated_span" in names) == annotate
        assert [s.name for s in tr.spans()] == ["obs_annotated_span"]


# ---------------------------------------------------------------------------
# the metrics registry, against JAX's
# ---------------------------------------------------------------------------


def _registry_ops(reg):
    c = reg.counter("serve.tokens_out")
    c.inc(5)
    assert reg.counter("serve.tokens_out") is c  # idempotent constructor
    reg.gauge("serve.live_slots").set(3)
    reg.gauge("train.budget").set(-1.0)
    h = reg.histogram("serve.latency_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    d = reg.histogram("serve.ttft_s")  # the default doubling buckets
    for v in (3e-6, 2.5e-3, 0.7, 1e3):
        d.observe(v)
    reg.counter("serve-legacy.decode_s").inc(0.125)
    reg.histogram("empty.h")
    return reg


def test_registry_snapshot_and_prometheus_equal_jax():
    reg, jreg = _registry_ops(MetricsRegistry()), _registry_ops(JMetricsRegistry())
    snap = reg.snapshot()
    assert snap == jreg.snapshot()
    assert reg.to_prometheus() == jreg.to_prometheus()
    assert snap["serve.tokens_out"] == 5.0
    assert snap["serve.live_slots"] == 3.0
    assert snap["serve.latency_s.count"] == 3
    assert snap["serve.latency_s.max"] == 5.0
    assert snap["serve.latency_s.mean"] == pytest.approx(5.55 / 3)
    text = reg.to_prometheus()
    assert "# TYPE serve_tokens_out counter" in text
    assert "serve_live_slots 3" in text
    assert 'serve_latency_s_bucket{le="+Inf"} 3' in text
    assert "serve_latency_s_count 3" in text
    assert "serve_legacy_decode_s 0.125" in text
    with pytest.raises(TypeError):
        reg.gauge("serve.tokens_out")  # a kind mismatch is a bug
    with pytest.raises(TypeError):
        reg.histogram("serve.tokens_out")
    assert MetricsRegistry().to_prometheus() == JMetricsRegistry().to_prometheus() == ""


def test_counter_view_keeps_dict_ergonomics():
    for reg in (MetricsRegistry(), JMetricsRegistry()):
        view = reg.view("serve", ["tokens_out", "decode_s"])
        view["tokens_out"] += 7
        view["decode_s"] += 0.25
        view["new_key"] = 2  # assignment grows the view, like a dict
        assert dict(view) == {"tokens_out": 7, "decode_s": 0.25, "new_key": 2}
        assert view["tokens_out"] == 7 and isinstance(view["tokens_out"], int)
        assert reg.snapshot()["serve.tokens_out"] == 7.0  # lives in the registry
        with pytest.raises(KeyError):
            view["never_registered"]
        with pytest.raises(TypeError):
            del view["tokens_out"]
        assert len(view) == 3
    assert isinstance(MetricsRegistry().view("a", ["b"]), CounterView)


def test_observability_merges_adopted_registries_as_jax(tmp_path):
    ob = observability(_obs_cfg(tmp_path))
    job = jobservability(JObsConfig(crash_dir=str(tmp_path / "jax")))
    for o, R in ((ob, MetricsRegistry), (job, JMetricsRegistry)):
        o.metrics.counter("train.steps").inc(4)
        for n, name in ((9, "engine0"), (3, "engine1")):
            eng = R()
            eng.counter("serve.tokens_out").inc(n)
            o.adopt(name, eng)
    snap = ob.metrics_snapshot()
    assert snap == job.metrics_snapshot()
    assert snap == {"train.steps": 4.0, "serve.tokens_out": 9.0, "serve.tokens_out#1": 3.0}
    assert ob.prometheus() == job.prometheus()
    assert "train_steps 4" in ob.prometheus() and "serve_tokens_out 9" in ob.prometheus()
    NULL_OBS.adopt("ignored", MetricsRegistry())
    assert NULL_OBS.components == []


# ---------------------------------------------------------------------------
# ledgers
# ---------------------------------------------------------------------------


def test_compile_ledger_summary_and_write_as_jax(tmp_path):
    led, jled = CompileLedger(), JCompileLedger()
    for ledger in (led, jled):
        ledger.record_compile("k1", trace_s=0.5, compile_s=2.0)
        ledger.record_compile("k2", first_call_s=1.0)
        ledger.record_hit("k1")
        ledger.record_hit("k1")
        ledger.record_hit("k3")
    s = led.summary()
    assert s == jled.summary()
    assert s == {"compiles": 2, "hits": 3, "distinct_keys": 3,
                 "total_compile_s": 2.0, "total_first_call_s": 1.0}
    path = led.write(str(tmp_path / "ledger.json"))
    doc = json.load(open(path))
    assert doc["summary"] == s
    assert doc["hits_by_key"] == {"k1": 2, "k3": 1}
    assert [e["key"] for e in doc["entries"]] == ["k1", "k2"]


def test_memory_summary_fields_as_jax():
    class MA:  # the stable slice of a memory_analysis() result
        argument_size_in_bytes = 4e9
        output_size_in_bytes = 1e9
        temp_size_in_bytes = 2e9
        alias_size_in_bytes = 1e9

    for hbm in (int(8e9), int(4e9), None):
        assert memory_summary(MA(), hbm_bytes=hbm) == jmemory_summary(MA(), hbm_bytes=hbm)
    out = memory_summary(MA(), hbm_bytes=int(8e9))
    assert out["peak_GB_per_dev"] == pytest.approx(6.0)
    assert out["fits_hbm"] is True
    assert memory_summary(MA(), hbm_bytes=int(4e9))["fits_hbm"] is False
    assert "fits_hbm" not in memory_summary(MA())


def test_memory_on_the_cpu_is_not_measured():
    """On the CPU the allocator view is None with its reason; nothing is
    invented. ``device_memory_stats`` lists only CUDA devices."""
    out, summ = first_call_memory(lambda: 41 + 1, "cpu")
    assert out == 42
    assert summ == {"peak_GB_per_dev": None, "reason": ledgers.NO_ALLOCATOR}
    if not torch.cuda.is_available():
        assert ledgers.device_memory_stats() == []


def test_runtime_train_step_is_cached_and_feeds_ledgers(tmp_path):
    """One Runtime.train_step build: one compile-ledger entry with its
    first-call time under a ``first_call`` span, and a memory-ledger entry
    under the same key (None on the CPU, with the reason); a second
    train_step call returns the same step and counts as a hit."""
    cfg = _obs_cfg(tmp_path)
    rt = _runtime(cfg)
    arch, opt = ArchConfig(**TINY), sgd(0.1)
    step = rt.train_step(arch, opt)
    state = rt.init_state(0, arch, opt)
    state, _ = step(state, next(_data()), 1)
    ob = rt.observability()
    [entry] = ob.compile_ledger.entries
    assert entry["key"].startswith("train_step/obs-tiny/budget=1.0")
    assert entry["first_call_s"] > 0 and entry["trace_s"] is None and entry["compile_s"] is None
    [span] = ob.tracer.spans("first_call")
    assert span.attrs["key"] == entry["key"] and span.duration_s >= entry["first_call_s"]
    assert rt.train_step(arch, opt) is step  # cached
    assert rt.train_step(arch, opt, budget=0.5) is step  # no policy: one exact step
    assert ob.compile_ledger.summary()["hits"] == 2
    [(mkey, mem)] = ob.memory_ledger.to_json()["by_key"].items()
    assert mkey == entry["key"]
    assert mem["peak_GB_per_dev"] is None and "CPU" in mem["reason"]
    rep = ob.report()
    assert rep["enabled"] and rep["compile"]["summary"]["compiles"] == 1
    assert mkey in rep["memory"]["by_key"]
    state, _ = step(state, next(_data(1)), 2)  # later calls are not recorded again
    assert len(ob.compile_ledger.entries) == 1


def test_step_cache_keys_on_runtime_cfg_opt_and_budget():
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.5))
    rt, arch, opt = _runtime(policy=pol), ArchConfig(**TINY), sgd(0.1)
    a = rt.train_step(arch, opt, budget=0.5)
    assert rt.train_step(arch, opt, budget=0.5) is a
    assert _runtime(policy=pol).train_step(arch, opt, budget=0.5) is a  # equal Runtimes share
    assert rt.train_step(arch, opt, budget=0.2) is not a
    assert rt.train_step(arch, sgd(0.1), budget=0.5) is not a
    assert rt.train_step(arch.replace(name="other"), opt, budget=0.5) is not a
    # a list in the policy cannot be hashed: the step is built, uncached
    listed = _runtime(policy=SketchPolicy(base=pol.base, exclude_roles=["lm_head"]))
    assert listed.train_step(arch, opt) is not listed.train_step(arch, opt)


def test_clock_is_the_timebase_of_the_straggler_controller(monkeypatch):
    """The straggler controller reads ``obs.clock.now`` (as JAX's lint asks
    of every host timing)."""
    t = [100.0]
    monkeypatch.setattr(clock, "now", lambda: t[0])
    ctl = StragglerController((1.0, 0.5), window=3, target_step_s=1.0)
    for dt in (2.0, 2.0, 2.0):
        ctl.step_begin()
        t[0] += dt
        ctl.step_end()
    assert ctl.budget == 0.5  # three 2 s steps against a 1 s target: one bucket down


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def test_flight_recorder_dump_bundle_as_jax(tmp_path):
    """A crash bundle holds JAX's four files; the events, the snapshot ring
    and the span events equal JAX's for the same inputs."""
    dirs = {}
    for name, (T, R, F) in {"port": (Tracer, MetricsRegistry, FlightRecorder),
                            "jax": (JTracer, JMetricsRegistry, JFlightRecorder)}.items():
        tr, reg = T(), R()
        tr.origin = 0.0
        tr.add_span("train_step", 1.0, 2.0, step=0)
        reg.counter("train.steps").inc(2)
        fr = F(tr, reg, capacity=2)
        for i in range(3):
            fr.note({"event": "fault_injected", "step": i})
        fr.snapshot(step=1)
        path = fr.dump(str(tmp_path / name), "ckpt io!", {"step": 3})
        assert os.path.basename(path) == "crash_000_ckpt_io_" and fr.dumps == [path]
        assert fr.dump(str(tmp_path / name), "again").endswith("crash_001_again")
        dirs[name] = path
    for fname in ("meta.json", "spans.json", "metrics.json", "events.json"):
        port, jax_ = (json.load(open(os.path.join(dirs[n], fname))) for n in ("port", "jax"))
        if fname == "meta.json":
            port.pop("wall_time"), jax_.pop("wall_time")
        if fname == "metrics.json":
            for d in (port, jax_):
                for s in d["snapshots"]:
                    s.pop("at")
        assert port == jax_, fname
    events = json.load(open(os.path.join(dirs["port"], "events.json")))
    assert [e["step"] for e in events] == [1, 2]  # the ring keeps the newest two
    assert FlightRecorder(None, None).dump(str(tmp_path / "bare"), "x")


# ---------------------------------------------------------------------------
# the trainer, the checkpoint writer and the engine report through it
# ---------------------------------------------------------------------------


def test_trainer_exports_configured_traces(tmp_path):
    chrome = str(tmp_path / "trace.json")
    jsonl = str(tmp_path / "spans.jsonl")
    cfg = _obs_cfg(tmp_path, chrome_trace=chrome, trace_jsonl=jsonl)
    rt = _runtime(cfg)
    train_loop(rt, ArchConfig(**TINY), sgd(0.1), _data(), TrainerConfig(steps=4),
               on_metrics=lambda m: None)
    doc = json.load(open(chrome))
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"train_loop", "build_buckets", "train_step", "first_call"} <= names
    steps = [e for e in doc["traceEvents"] if e["name"] == "train_step"]
    assert sorted(e["args"]["step"] for e in steps) == [0, 1, 2, 3]
    [loop] = [e for e in doc["traceEvents"] if e["name"] == "train_loop"]
    assert loop["args"]["start_step"] == 0 and loop["args"]["steps"] == 4
    assert all(e["args"]["parent_id"] == loop["args"]["span_id"] for e in steps)
    [first] = [e for e in doc["traceEvents"] if e["name"] == "first_call"]
    assert first["args"]["parent_id"] == min(steps, key=lambda e: e["ts"])["args"]["span_id"]
    recs = [json.loads(line) for line in open(jsonl) if line.strip()]
    assert {r["name"] for r in recs} == names
    snap = rt.observability().metrics_snapshot()
    assert snap["train.steps"] == 4.0 and snap["train.budget"] == 1.0


def test_checkpoint_waits_and_writes_are_spanned(tmp_path):
    """The async writer records ``ckpt_io_write`` on its own thread; the
    loop's final wait is a ``ckpt_wait`` span; the flight recorder holds one
    metrics snapshot per logged step."""
    cfg = _obs_cfg(tmp_path)
    rt = _runtime(cfg)
    train_loop(rt, ArchConfig(**TINY), sgd(0.1), _data(),
               TrainerConfig(steps=6, log_every=2, ckpt_dir=str(tmp_path / "ck"), ckpt_every=3),
               on_metrics=lambda m: None)
    tr = rt.observability().tracer
    writes = tr.spans("ckpt_io_write")
    assert sorted(s.attrs["step"] for s in writes) == [3, 6]
    [loop] = tr.spans("train_loop")
    assert all(s.tid != loop.tid and s.parent is None for s in writes)
    assert len(tr.spans("ckpt_wait")) == 1
    snaps = list(rt.observability().flight._snaps)
    assert [s["step"] for s in snaps] == [0, 2, 4, 5]
    assert all(s["train.steps"] == s["step"] + 1 for s in snaps)


def test_observability_never_changes_numerics(tmp_path):
    """obs=None against the full ObsConfig, sketched and with checkpoints:
    the same final parameters and optimizer state, bit for bit."""
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.5))
    arch = ArchConfig(**TINY)
    states = []
    for obs in (None, _obs_cfg(tmp_path)):
        rt = Runtime(policy=pol, execution=ExecutionConfig(obs=obs), device="cpu")
        st, _ = train_loop(rt, arch, sgd(0.1, momentum=0.9), _data(),
                           TrainerConfig(steps=5, log_every=2, seed=0,
                                         ckpt_dir=str(tmp_path / f"ck{obs is None}"),
                                         ckpt_every=2),
                           on_metrics=lambda m: None)
        states.append(st)
    off, on = states
    assert on.step == off.step == 5
    for a, b in zip(tree_leaves({"p": off.params, "o": off.opt_state}),
                    tree_leaves({"p": on.params, "o": on.opt_state})):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_serve_ring_span_ids_reconstruct_lifecycles(tmp_path):
    """Every finished request's ring record carries the sid of its
    ``request`` span; the queued, prefill and decode children parent onto it
    and their durations are the ring's stamps. The engine's counters reach
    the shared registry, and its run exports the configured trace."""
    chrome = str(tmp_path / "serve.json")
    cfg = _obs_cfg(tmp_path, chrome_trace=chrome)
    rt = _runtime(cfg)
    params = lm.init_params(0, SERVE_CFG, device="cpu")
    eng = Engine(params, SERVE_CFG, serve=ServeConfig(n_slots=2, max_len=64, page_size=16),
                 runtime=rt)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, SERVE_CFG.vocab, size=n).astype(np.int32),
                    max_new=m) for n, m in [(5, 4), (9, 3), (3, 6), (7, 2)]]
    eng.run(reqs)
    tracer = rt.observability().tracer
    by_sid = {s.sid: s for s in tracer.spans()}
    recs = [r for r in eng.ring.records if r["span_id"] is not None]
    assert len(recs) == 4
    for rec in recs:
        req_span = by_sid[rec["span_id"]]
        assert req_span.name == "request"
        assert req_span.attrs["stop"] in ("length", "eos")
        assert req_span.attrs["new_tokens"] == rec["new_tokens"]
        assert req_span.duration_s == rec["latency_s"]
        kids = {s.name: s for s in tracer.spans() if s.parent == rec["span_id"]}
        assert set(kids) == {"queued", "prefill", "decode"}
        assert kids["queued"].duration_s == rec["queue_s"]
        assert kids["queued"].duration_s + kids["prefill"].duration_s == \
            pytest.approx(rec["ttft_s"])
    assert tracer.spans("serve.run") and tracer.spans("decode_step")
    assert tracer.spans("prefill_wave")
    snap = rt.observability().metrics_snapshot()
    assert snap["serve.requests_done"] == 4.0
    assert snap["serve.tokens_out"] == sum(r.max_new for r in reqs)
    assert "serve_requests_done 4" in rt.observability().prometheus()
    doc = json.load(open(chrome))
    assert sum(e["name"] == "request" for e in doc["traceEvents"]) == 4
    # with obs off the engine records nothing and its ring has no span ids
    off = Engine(params, SERVE_CFG, serve=ServeConfig(n_slots=2, max_len=64), runtime=_runtime())
    off.run([Request(prompt=np.asarray([1, 2, 3], np.int32), max_new=2)])
    assert off.ring.records[-1]["span_id"] is None
