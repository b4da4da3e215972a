"""The serving slice on the CPU against JAX: flash attention's plain
version, segment masks, decode attention, and prefill + greedy decode
through each package's ``Runtime`` on the same weights and prompts.

Inputs come from numpy with a seed; weights and caches come across with
``params_from_jax`` and ``caches_from_jax``. JAX runs its Pallas flash
kernel in interpret mode where a test says so. Tolerances are stated where
they are used; float32 differences come from sums taken in other orders
(JAX's kernel and chunked path normalise their softmax online).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.runtime import Runtime as JRuntime
from repro.configs.base import ArchConfig as JArchConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.nn.common import Ctx as JCtx
from repro.serve.serve_step import greedy_sample as jgreedy
from repro_torch.api import Runtime
from repro_torch.configs.base import ArchConfig
from repro_torch.interop import caches_from_jax, params_from_jax
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.nn import attention
from repro_torch.nn.common import Ctx
from repro_torch.serve import greedy_sample, make_decode_step, make_prefill

ROOT = Path(__file__).resolve().parents[1]
# the serving config of tests/test_serve.py (head width 16)
SERVE = dict(name="serve-test", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
             d_ff=128, vocab=256, q_chunk=32, kv_chunk=32)
# the training config of tests/test_torch_lm.py, for the segment repair
TINY = dict(name="lm-tiny", family="dense", n_layers=2, d_model=128, n_heads=4, n_kv=2,
            d_ff=512, vocab=512, q_chunk=64, kv_chunk=64)
# float32 logits of a 2-layer model whose attention sums in another order
# (JAX's online softmax, its kernel's tiles): ~1e-6 of |logits| per layer
LOGIT_TOL = 2e-5

# tests/test_kernels.py's flash shapes (GQA, window, Skv > Sq right-aligned,
# non-causal, bf16, ragged 100), plus a windowed GQA set at dh 128
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, "float32"),
    (1, 96, 96, 4, 4, 64, True, 32, "float32"),
    (2, 64, 192, 4, 1, 128, True, None, "float32"),
    (1, 128, 128, 2, 2, 64, False, None, "float32"),
    (1, 128, 128, 4, 2, 64, True, None, "bfloat16"),
    (1, 100, 100, 2, 2, 64, True, None, "float32"),
    (1, 96, 96, 4, 2, 128, True, 40, "float32"),
]


def _qkv(B, Sq, Skv, H, Kv, dh, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, Sq, H, dh)).astype(np.float32),
            r.normal(size=(B, Skv, Kv, dh)).astype(np.float32),
            r.normal(size=(B, Skv, Kv, dh)).astype(np.float32))


def _to(arrays, dtype):
    return ([torch.tensor(a).to(getattr(torch, dtype)) for a in arrays],
            [jnp.asarray(a, dtype=dtype) for a in arrays])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,Sq,Skv,H,Kv,dh,causal,window,dtype", FLASH_CASES)
def test_flash_plain_matches_jax_ref_and_interpret_kernel(B, Sq, Skv, H, Kv, dh, causal,
                                                           window, dtype):
    (q, k, v), (jq, jk, jv) = _to(_qkv(B, Sq, Skv, H, Kv, dh, seed=Sq + H), dtype)
    got = flash.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == (B, Sq, H, dh)
    # against the oracle: float32 1e-5 (one einsum each, other summation
    # order); bfloat16 outputs 1e-2 (a float32 difference may round to the
    # neighbouring bfloat16, one ulp is 2^-7 at |o| < 2)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    # against the Pallas kernel in interpret mode, at JAX's own tolerance
    # (tests/test_kernels.py: online softmax over 64-key tiles)
    kern = jflash(jq, jk, jv, causal=causal, window=window, interpret=True, tile_q=64, tile_k=64)
    tol = 3e-2 if dtype == "bfloat16" else 3e-4
    np.testing.assert_allclose(_f32(got), _f32(kern), rtol=tol, atol=tol)
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal, window=window), got)


def test_flash_causal_with_more_queries_than_keys_raises():
    """JAX's kernel and oracle disagree for queries that see no key; the
    port raises in the plain version, the dispatcher and the kernel's
    argument check (ROADMAP Queue 3)."""
    (q, k, v), _ = _to(_qkv(1, 64, 32, 2, 2, 64), "float32")
    for fn in (flash.flash_attention_plain, ops.flash_attention):
        with pytest.raises(ValueError, match="Sq <= Skv"):
            fn(q, k, v, causal=True)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        ref.check_flash_causal(64, 32, True)
    ref.check_flash_causal(64, 32, False)  # non-causal: every query sees every key
    assert ops.flash_attention(q, k, v, causal=False).shape == q.shape


def test_flash_kernel_wrapper_refuses_cpu_and_mixed_devices():
    (q, k, v), _ = _to(_qkv(1, 64, 64, 2, 2, 64), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, k, v)
    meta = torch.empty(k.shape, device="meta")
    with pytest.raises(ValueError, match="all lie on the CPU or all on a CUDA device"):
        ops.flash_attention(q, meta, v)


def test_flash_plain_is_differentiable_on_cpu():
    """The CPU path stays differentiable (JAX's CPU path is its oracle):
    gradients match jax.grad of flash_attention_ref at float32 1e-5."""
    arrays = _qkv(2, 64, 64, 4, 2, 64, seed=3)
    r = np.random.default_rng(4)
    w = r.normal(size=(2, 64, 4, 64)).astype(np.float32)
    tq = [torch.tensor(a, requires_grad=True) for a in arrays]
    (ops.flash_attention(*tq, causal=True, window=24) * torch.tensor(w)).sum().backward()
    jg = jax.grad(lambda q, k, v: jnp.sum(jref.flash_attention_ref(q, k, v, causal=True,
                                                                   window=24) * w),
                  argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    for t, g in zip(tq, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-5)


def _segments():
    """Two rows of 32 tokens: two packed prompts each, the first row padded."""
    segs = np.zeros((2, 32), np.int32)
    segs[0, :12], segs[0, 12:26] = 1, 2
    segs[1, :19], segs[1, 19:] = 1, 2
    pos = np.zeros_like(segs)
    for b in range(2):
        for s in (1, 2):
            n = int((segs[b] == s).sum())
            pos[b, segs[b] == s] = np.arange(n)
    return segs, pos


@pytest.mark.parametrize("impl", ["chunked", "einsum"])
@pytest.mark.parametrize("window", [None, 6])
def test_multi_head_attention_segments_match_jax(impl, window):
    """Segment masks with the causal and window masks, against both JAX
    plain impls; the port's pallas dispatch takes the kernel only without
    segments."""
    segs, _ = _segments()
    arrays = _qkv(2, 32, 32, 4, 2, 16, seed=5)
    jcfg = jattn.AttnCfg(n_heads=4, n_kv=2, d_head=16, window=window, q_chunk=16, kv_chunk=16,
                         impl=impl)
    want = jattn.multi_head_attention(*map(jnp.asarray, arrays), jcfg, segs=jnp.asarray(segs))
    q, k, v = map(torch.tensor, arrays)
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return flash.flash_attention_plain(*a, **kw)

    real = ops.flash_attention
    ops.flash_attention = spy
    try:
        for port_impl in ("chunked", "einsum", "pallas"):
            cfg = attention.AttnCfg(n_heads=4, n_kv=2, d_head=16, window=window, impl=port_impl)
            got = attention.multi_head_attention(q, k, v, cfg, segs=torch.tensor(segs))
            # a padding query (segment 0) sees no key and its output is a
            # placeholder that JAX's impls fill differently (the chunked
            # window path averages V over its zero-padded span): compare
            # the real rows
            real_rows = segs > 0
            np.testing.assert_allclose(got.numpy()[real_rows], np.asarray(want)[real_rows],
                                       rtol=1e-5, atol=1e-5)
        assert calls == []
        cfg = attention.AttnCfg(n_heads=4, n_kv=2, d_head=16, window=window, impl="pallas")
        attention.multi_head_attention(q, k, v, cfg)
        assert calls == [1]
    finally:
        ops.flash_attention = real


@pytest.mark.parametrize("impl", ["chunked", "einsum"])
def test_forward_and_loss_honour_segments_like_jax(impl):
    """The repaired fault: the port's forward segment-masks a packed batch
    as JAX's does (the parent ignored ``segments``). Per-segment positions,
    two prompts per row, one row padded; loss masked to the real tokens."""
    jcfg = JArchConfig(**dict(TINY, attn_impl=impl))
    cfg = ArchConfig(**TINY)
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    segs, pos = _segments()
    r = np.random.default_rng(1)
    toks = r.integers(1, TINY["vocab"], size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "segments": segs,
             "positions": pos, "mask": (segs > 0).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.tensor(v).long() if k != "mask" else torch.tensor(v)
              for k, v in batch.items()}
    jlogits, _ = jlm.forward(jparams, jbatch, JCtx(), jcfg)
    logits = lm.forward(params, tbatch, Ctx(), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    jloss, _ = jlm.lm_loss(jparams, jbatch, JCtx(), jcfg)
    loss, _ = lm.lm_loss(params, tbatch, Ctx(), cfg)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-6)
    # and the masks matter: without segments the logits differ
    unmasked = lm.forward(params, {k: v for k, v in tbatch.items() if k != "segments"},
                          Ctx(), cfg)
    assert not np.allclose(unmasked.numpy(), np.asarray(jlogits), atol=1e-3)


@pytest.mark.parametrize("case,window,size,pos", [
    ("scalar", None, 24, 17),
    ("vector", None, 24, [3, 17]),
    ("window", 8, 24, [3, 17]),
    ("ring", 8, 8, [5, 13]),
    ("ring-scalar", 8, 8, 13),
])
def test_decode_attention_matches_jax(case, window, size, pos):
    """One query per row against a cache: scalar and per-row positions, a
    window on a longer cache, and a ring cache no longer than the window
    (warming up and warm). float32 1e-5: one einsum each."""
    r = np.random.default_rng(len(case))
    q = r.normal(size=(2, 1, 4, 16)).astype(np.float32)
    kc = r.normal(size=(2, size, 2, 16)).astype(np.float32)
    vc = r.normal(size=(2, size, 2, 16)).astype(np.float32)
    jcfg = jattn.AttnCfg(n_heads=4, n_kv=2, d_head=16, window=window)
    cfg = attention.AttnCfg(n_heads=4, n_kv=2, d_head=16, window=window)
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = pos if isinstance(pos, int) else torch.tensor(pos)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jpos, jcfg)
    got = attention.decode_attention(torch.tensor(q), torch.tensor(kc), torch.tensor(vc), tpos,
                                     cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _serve_setup(window):
    jcfg = JArchConfig(**dict(SERVE, attn_impl="pallas", window=window))
    cfg = ArchConfig(**dict(SERVE, attn_impl="pallas", window=window))
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _compare_caches(got, jcaches, cfg):
    want = caches_from_jax(jax.device_get(jcaches), cfg, device="cpu")
    assert len(got) == len(want) == cfg.n_layers
    for g, w in zip(got, want):
        for name in ("k", "v"):
            assert g[name].shape == w[name].shape
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(), rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)


@pytest.mark.parametrize("window", [None, 8])
def test_prefill_and_greedy_decode_match_jax(monkeypatch, window):
    """The slice as a whole: each package's Runtime prefills two 20-token
    prompts with attn_impl="pallas" (JAX runs its Pallas kernel in interpret
    mode, the port its dispatcher's CPU path) and decodes 8 greedy tokens.
    Same logits, same caches (through caches_from_jax), same tokens; with a
    window of 8 the caches are rings of 8 slots."""
    monkeypatch.setenv("REPRO_FORCE_INTERPRET", "1")
    jcfg, cfg, jparams, params = _serve_setup(window)
    jkernel = []
    real_jflash = jops._flash_pallas
    monkeypatch.setattr(jops, "_flash_pallas", lambda *a, **kw: jkernel.append(1)
                        or real_jflash(*a, **kw))
    port_calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: port_calls.append(1)
                        or real(*a, **kw))

    S, steps = 20, 8
    max_len = S + steps
    toks = np.random.default_rng(11).integers(1, SERVE["vocab"], size=(2, S)).astype(np.int32)
    jrt, rt = JRuntime(), Runtime(device="cpu")
    jlogits, jcaches = jrt.prefill_step(jcfg, max_len)(jparams, {"tokens": jnp.asarray(toks)})
    logits, caches = rt.prefill_step(cfg, max_len)(params, {"tokens": toks})
    assert jkernel, "JAX's prefill did not reach its Pallas kernel"
    assert len(port_calls) == cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    size = max_len if window is None else window
    assert caches[0]["k"].shape == (2, size, SERVE["n_kv"], SERVE["d_model"] // SERVE["n_heads"])
    _compare_caches(caches, jcaches, cfg)

    jdecode, decode = jrt.decode_step(jcfg), rt.decode_step(cfg)
    jcur, cur = jgreedy(jlogits[:, -1:]), greedy_sample(logits[:, -1:])
    for i in range(steps):
        assert np.array_equal(cur.numpy(), np.asarray(jcur)), f"step {i}"
        jlg, jcaches = jdecode(jparams, jcaches, jcur, S + i)
        lg, caches = decode(params, caches, cur, S + i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=LOGIT_TOL, atol=LOGIT_TOL)
        jcur, cur = jgreedy(jlg), greedy_sample(lg)
    assert len(port_calls) == cfg.n_layers  # decode never reaches the kernel
    _compare_caches(caches, jcaches, cfg)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_matches_teacher_forced_forward(window, per_row):
    """Prefill 15 tokens, then decode 5 teacher-forced: each step's logits
    equal the port's full forward at that position (the port's analogue of
    tests/test_serve.py:79-88). float32 1e-5: plain attention on both sides,
    masked differently."""
    _, cfg, _, params = _serve_setup(window)
    toks = torch.tensor(np.random.default_rng(2).integers(0, SERVE["vocab"], size=(2, 20)))
    full = lm.forward(params, {"tokens": toks}, Ctx(), cfg)
    rt = Runtime(device="cpu")
    logits, caches = rt.prefill_step(cfg, 24)(params, {"tokens": toks[:, :15]})
    np.testing.assert_allclose(logits.numpy(), full[:, :15].numpy(), rtol=1e-5, atol=1e-5)
    decode = rt.decode_step(cfg)
    for i in range(15, 20):
        pos = torch.tensor([i, i]) if per_row else i
        lg, caches = decode(params, caches, toks[:, i:i + 1], pos)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(), rtol=1e-5, atol=1e-5)


def test_per_row_positions_decode_each_row_at_its_own_step():
    """With per-row positions, row b writes and attends at pos[b]: decoding
    rows that were prefilled to different lengths gives each row's own
    teacher-forced logits."""
    _, cfg, _, params = _serve_setup(None)
    toks = torch.tensor(np.random.default_rng(6).integers(1, SERVE["vocab"], size=(2, 12)))
    full = [lm.forward(params, {"tokens": toks[b:b + 1]}, Ctx(), cfg) for b in range(2)]
    caches = lm.init_cache(cfg, 2, 16, device="cpu")
    lens = (7, 10)
    for b, n in enumerate(lens):
        _, cb = lm.prefill(params, {"tokens": toks[b:b + 1, :n]}, Ctx(), cfg, 16)
        for c, one in zip(caches, cb):
            c["k"][b], c["v"][b] = one["k"][0], one["v"][0]
    decode = make_decode_step(cfg, device="cpu")
    pos = torch.tensor(lens)
    for _ in range(2):
        cur = toks[torch.arange(2), pos][:, None]
        lg, caches = decode(params, caches, cur, pos)
        for b in range(2):
            np.testing.assert_allclose(lg[b, 0].numpy(), full[b][0, int(pos[b])].numpy(),
                                       rtol=1e-5, atol=1e-5)
        pos = pos + 1


def test_caches_from_jax_round_trips():
    jcfg, cfg, jparams, _ = _serve_setup(8)
    toks = jnp.asarray(np.random.default_rng(3).integers(0, 256, size=(2, 11)), jnp.int32)
    _, jcaches = jlm.prefill(jparams, {"tokens": toks}, JCtx(), jcfg, 16)
    caches = caches_from_jax(jax.device_get(jcaches), cfg, device="cpu")
    assert [tuple(c["k"].shape) for c in caches] == [(2, 8, 2, 16)] * 2
    for name in ("k", "v"):
        np.testing.assert_array_equal(np.stack([c[name].numpy() for c in caches]),
                                      np.asarray(jcaches[0][0]["kv"][name]))
    zeros = caches_from_jax(jax.device_get(jlm.init_cache(jcfg, 3, 5)), cfg, device="cpu")
    assert all(torch.equal(c["k"], t["k"]) for c, t in
               zip(zeros, lm.init_cache(cfg, 3, 5, device="cpu")))
    with pytest.raises(ValueError, match="layers"):
        caches_from_jax(jax.device_get(jcaches), ArchConfig(**dict(SERVE, n_layers=3)),
                        device="cpu")


def test_serving_entry_points_default_to_the_card():
    cfg = ArchConfig(**SERVE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Runtime().prefill_step(cfg, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Runtime().decode_step(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_prefill(cfg, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm.init_cache(cfg, 1, 8)


def test_greedy_sample_matches_jax():
    logits = np.random.default_rng(8).normal(size=(3, 1, 50)).astype(np.float32)
    got = greedy_sample(torch.tensor(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgreedy(jnp.asarray(logits))))


def test_port_scan_finds_the_serving_files():
    """tests/test_torch_lm.py's import scan reads every module of the port;
    it reaches the new subpackage and kernel module, which import no JAX."""
    files = {p.relative_to(ROOT).as_posix()
             for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert {"src/repro_torch/serve/__init__.py", "src/repro_torch/serve/serve_step.py",
            "src/repro_torch/kernels/flash_attention.py"} <= files
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    assert not [f for f in files if "serve" in f or "flash" in f
                if pat.search((ROOT / f).read_text())]
