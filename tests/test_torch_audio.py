"""The encoder-decoder audio family (seamless-m4t-large-v2: a bidirectional
encoder over a stub speech frontend, a decoder with cross-attention) on the
CPU against JAX.

The smoke config (2 encoder + 2 decoder layers, d 64, 4 heads of 16) runs
in both packages on JAX's ``lm.init_params`` weights (``params_from_jax``;
JAX with ``remat="none"``: the same function, a shorter compile) and the
same numpy inputs: target tokens [B, S] and ``src_embeds`` [B, S_ENC, d]
(normal x 0.02, as JAX's smoke tests feed the stub), S_ENC != S so the
cross-attention's query and key lengths differ. The gradient tests cut the
config to 1 + 1 layers: JAX's grad compile of the full smoke config is what
marks its own seamless train step slow (tests/test_models_smoke.py).

Tolerances (float32), each stated where it is used: ``TOL`` 1e-5 (rtol and
atol) for attention outputs, logits, caches and gradients
(test_torch_lm.py's: both packages sum the same matmuls in other orders),
``RTOL``/``ATOL`` 1e-5/1e-6 for losses, JAX's own 3e-5 for prefill plus
decode against the forward, and 1e-4 (relative) for the probe vectors,
sums of squared gradient rows. Bits are compared on one torch intra-op
thread.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.execution import ExecutionConfig as JExecutionConfig
from repro.api.runtime import Runtime as JRuntime
from repro.configs import registry as jreg
from repro.core import SketchConfig as JSketchConfig
from repro.core import SketchPolicy as JSketchPolicy
from repro.kernels import ref as jkref
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.nn.common import Ctx as JCtx
from repro.optim import sgd as jsgd
from repro.serve.serve_step import greedy_sample as jgreedy
from repro.telemetry import TelemetryConfig as JTelemetryConfig
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import rng
from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
from repro_torch.configs import registry
from repro_torch.core.policy import ROLES
from repro_torch.interop import caches_from_jax, params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.nn import attention
from repro_torch.nn.common import Ctx
from repro_torch.optim import sgd
from repro_torch.serve import greedy_sample
from repro_torch.telemetry import TelemetryConfig
from repro_torch.telemetry import probes
from repro_torch.tree import tree_leaves, tree_map
from test_torch_vlm import same_slot_paths

ARCH = "seamless_m4t_large_v2"
TOL, RTOL, ATOL, CONSISTENCY_TOL, PROBE_RTOL = 1e-5, 1e-5, 1e-6, 3e-5, 1e-4
B, S, S_ENC = 2, 24, 20
ONE = dict(n_layers=1, enc_layers=1)  # the gradient tests' cut


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the bit-for-bit comparisons need the CPU's
    reductions to give the same bits on every call, and the test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(cut=False):
    jcfg = jreg.smoke_config(ARCH).replace(remat="none")
    cfg = registry.smoke_config(ARCH)
    if cut:
        jcfg, cfg = jcfg.replace(**ONE), cfg.replace(**ONE)
    jparams = jax.device_get(jlm.init_params(jax.random.key(1), jcfg))
    rs = np.random.default_rng(3)
    toks = rs.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "src_embeds": (rs.normal(size=(B, S_ENC, cfg.d_model)) * 0.02).astype(np.float32)}
    return jcfg, cfg, jparams, batch


def _port(cut=False):
    _, cfg, jparams, _ = _setup(cut)
    return params_from_jax(jparams, cfg, device="cpu")


def _tb(batch):
    return {k: torch.tensor(v).long() if k in ("labels", "tokens") else torch.tensor(v)
            for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), rtol=tol, atol=tol)


def _policy(pkg, budget, backend="pallas", block=128):
    kw = dict(method="l1", budget=budget, backend=backend, block=block)
    return (JSketchPolicy(base=JSketchConfig(**kw)) if pkg == "jax"
            else SketchPolicy(base=SketchConfig(**kw)))


# ---------------------------------------------------------------------------
# cross-attention and the non-causal flash path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv", [(7, 13), (13, 7)])
def test_cross_attention_matches_jax(sq, skv):
    """``attention(..., memory=)`` with the decoder's cross config at Sq !=
    Skv, both ways round: the output and the gradients of the stream, the
    memory and every projection (1e-5)."""
    jcfg, cfg, _, _ = _setup()
    jccfg, ccfg = jlm._cross_cfg(jcfg), lm.cross_cfg(cfg)
    assert (ccfg.causal, ccfg.rope, ccfg.cross) == (False, "none", True)
    jp = jax.device_get(jattn.attn_init(jax.random.key(4), cfg.d_model, jccfg))
    rs = np.random.default_rng(sq)
    x = rs.normal(size=(B, sq, cfg.d_model)).astype(np.float32)
    mem = rs.normal(size=(B, skv, cfg.d_model)).astype(np.float32)
    w = rs.normal(size=(B, sq, cfg.d_model)).astype(np.float32)

    def jf(p, xx, mm):
        o = jattn.attention(p, xx, JCtx(), jccfg, None, memory=mm, role_prefix="cross")
        return jnp.sum(o * w), o

    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jp, jnp.asarray(x), jnp.asarray(mem))
    p = tree_map(lambda a: torch.tensor(np.asarray(a), requires_grad=True), jp)
    tx, tm = torch.tensor(x, requires_grad=True), torch.tensor(mem, requires_grad=True)
    o = attention.attention(p, tx, Ctx(), ccfg, None, memory=tm, role_prefix="cross")
    assert o.shape == (B, sq, cfg.d_model)
    _close(o, jo)
    leaves = tree_leaves(p)
    g = torch.autograd.grad((o * torch.tensor(w)).sum(), leaves + [tx, tm])
    want = tree_leaves(jg[0]) + [jg[1], jg[2]]
    for a, b in zip(g, want):
        _close(a, b)


@pytest.mark.parametrize("sq,skv", [(12, 40), (40, 12)])
def test_flash_plain_version_non_causal_matches_jax_reference(sq, skv):
    """``ops.flash_attention`` on CPU tensors (the plain version), without
    the causal mask at Sq != Skv both ways round, GQA 4:2, against JAX's
    ``flash_attention_ref`` (1e-5)."""
    rs = np.random.default_rng(skv)
    q = rs.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k = rs.normal(size=(2, skv, 2, 16)).astype(np.float32)
    v = rs.normal(size=(2, skv, 2, 16)).astype(np.float32)
    want = jkref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=False)
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=False)
    _close(got, want)


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------


def test_params_from_jax_unstacks_the_encoder_and_cross_leaves():
    jcfg, cfg, jparams, _ = _setup()
    params = _port()
    assert lm.num_params(params) == jlm.num_params(jparams)
    assert lm.num_params(lm.init_params(0, cfg, device="cpu")) == lm.num_params(params)
    enc = params["encoder"]
    assert len(enc["layers"]) == cfg.enc_layers and set(enc) == {"layers", "final_norm"}
    assert all(set(layer) == {"norm1", "attn", "norm2", "mlp"} for layer in enc["layers"])
    assert all(set(layer) == {"norm1", "attn", "norm2", "mlp", "cross", "norm_c"}
               for layer in params["layers"])
    assert [k.causal for k in lm.encoder_kinds(cfg)] == [False] * cfg.enc_layers
    assert lm.jax_layer_paths(cfg, encoder=True) == ["encoder/segments/0/0"] * cfg.enc_layers
    for rep in range(cfg.enc_layers):
        np.testing.assert_array_equal(
            enc["layers"][rep]["attn"]["k"]["w"].numpy(),
            np.asarray(jparams["encoder"]["segments"][0][0]["attn"]["k"]["w"][rep]))
        np.testing.assert_array_equal(
            params["layers"][rep]["cross"]["v"]["w"].numpy(),
            np.asarray(jparams["segments"][0][0]["cross"]["v"]["w"][rep]))
    lm.check_decoder(registry.get_config(ARCH))


def test_forward_from_tokens_and_src_embeds_matches_jax():
    jcfg, cfg, jparams, batch = _setup()
    jlogits, _ = jlm.forward(jparams, _jb(batch), JCtx(), jcfg)
    jloss, _ = jlm.lm_loss(jparams, _jb(batch), JCtx(), jcfg)
    params = _port()
    logits = lm.forward(params, _tb(batch), Ctx(), cfg)
    loss, _ = lm.lm_loss(params, _tb(batch), Ctx(), cfg)
    _close(logits, jlogits)
    assert float(loss) == pytest.approx(float(jloss), rel=RTOL, abs=ATOL)
    jmem = jlm.encode(jparams, jnp.asarray(batch["src_embeds"]), JCtx(), jcfg)
    _close(lm.encode(params, torch.tensor(batch["src_embeds"]), Ctx(), cfg), jmem)


def _grads(cfg, params, batch, policy, key=7):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    ctx = Ctx(policy=policy, key=key if policy else None, n_layers=cfg.n_layers)
    loss, _ = lm.lm_loss(params, _tb(batch), ctx, cfg, key if policy else None)
    return float(loss.detach()), list(torch.autograd.grad(loss, leaves))


def test_exact_gradients_match_jax():
    """Every leaf's gradient (the encoder's and the cross sub-block's among
    them) against ``jax.grad`` of ``lm_loss`` at 1 + 1 layers (1e-5)."""
    jcfg, cfg, jparams, batch = _setup(True)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, _jb(batch), JCtx(), jcfg)[0]))(jparams)
    loss, g = _grads(cfg, _port(True), batch, None)
    assert loss == pytest.approx(float(jloss), rel=RTOL, abs=ATOL)
    want = tree_leaves(params_from_jax(jax.device_get(jg), cfg, device="cpu"))
    assert len(g) == len(want)
    for a, b in zip(g, want):
        _close(a, b.numpy())


@pytest.mark.parametrize("backend", ["pallas", "onepass", "stale"])
def test_budget_0999_equals_exact(backend):
    """At budget 0.999 every site (block 128 wider than each site: one
    column per row of G kept with scale 1) gives exact backprop's
    gradient, the encoder's and the cross sites' included (1e-5)."""
    _, cfg, _, batch = _setup(True)
    loss_e, g_e = _grads(cfg, _port(True), batch, None)
    loss_s, g_s = _grads(cfg, _port(True), batch, _policy("torch", 0.999, backend))
    assert loss_s == loss_e
    for a, b in zip(g_s, g_e):
        _close(a, b.numpy())


def test_prefill_and_decode_match_jax():
    """Each package's Runtime prefills two 20-token prefixes over the source
    frames and decodes 4 greedy tokens: the same logits, self and cross
    caches (through ``caches_from_jax``) and tokens."""
    jcfg, cfg, jparams, batch = _setup()
    params = _port()
    P, steps = 20, 4
    max_len = P + steps + 2
    prompt = {"tokens": batch["tokens"][:, :P], "src_embeds": batch["src_embeds"]}
    jrt, rt = JRuntime(), Runtime(device="cpu")
    jlogits, jcaches = jrt.prefill_step(jcfg, max_len)(jparams, _jb(prompt))
    logits, caches = rt.prefill_step(cfg, max_len)(params, prompt)
    _close(logits, jlogits)

    def same_caches():
        want = caches_from_jax(jax.device_get(jcaches), cfg, device="cpu")
        for c, w in zip(caches, want):
            assert c["cross"]["k"].shape == (B, S_ENC, cfg.n_kv, cfg.head_dim)
            for a, b in ((c["k"], w["k"]), (c["v"], w["v"]), (c["cross"]["k"], w["cross"]["k"]),
                         (c["cross"]["v"], w["cross"]["v"])):
                _close(a, b.numpy())

    same_caches()
    jdecode, decode = jrt.decode_step(jcfg), rt.decode_step(cfg)
    jcur, cur = jgreedy(jlogits[:, -1:]), greedy_sample(logits[:, -1:])
    for i in range(steps):
        assert np.array_equal(cur.numpy(), np.asarray(jcur)), f"step {i}"
        jlg, jcaches = jdecode(jparams, jcaches, jcur, P + i)
        lg, caches = decode(params, caches, cur, P + i)
        _close(lg, jlg)
        jcur, cur = jgreedy(jlg), greedy_sample(lg)
    assert np.array_equal(cur.numpy(), np.asarray(jcur))
    same_caches()


def test_prefill_then_decode_equals_the_forward():
    """JAX's consistency rule (3e-5 of the logits): prefill over S - 1
    tokens plus one decode step, which attends to the cached memory, gives
    the full forward's last logits."""
    _, cfg, _, batch = _setup()
    params = _port()
    tb = _tb(batch)
    full = lm.forward(params, {"tokens": tb["tokens"], "src_embeds": tb["src_embeds"]}, Ctx(),
                      cfg)
    _, caches = lm.prefill(params, {"tokens": tb["tokens"][:, :-1],
                                    "src_embeds": tb["src_embeds"]}, Ctx(), cfg, S + 2)
    last, _ = lm.decode_step(params, caches, tb["tokens"][:, -1:], S - 1, Ctx(), cfg)
    _close(last[:, 0], full[:, -1].detach(), CONSISTENCY_TOL)


def test_pallas_prefill_runs_flash_for_every_attention(monkeypatch):
    """With attn_impl="pallas" the prefill reaches the flash dispatcher once
    per attention: the encoder's layers without the causal mask (Sq = Skv =
    S_ENC), each decoder layer's self-attention with it (S x S), then its
    cross-attention without it (Sq = S, Skv = S_ENC); the logits as JAX's
    (through its plain reference on the CPU, 1e-5)."""
    jcfg, cfg, jparams, batch = _setup()
    jcfg, cfg = jcfg.replace(attn_impl="pallas"), cfg.replace(attn_impl="pallas")
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, **kw: calls.append(
        (q.shape[1], k.shape[1], kw["causal"])) or real(q, k, v, **kw))
    prompt = {"tokens": batch["tokens"], "src_embeds": batch["src_embeds"]}
    jlogits, _ = JRuntime().prefill_step(jcfg, S + 2)(jparams, _jb(prompt))
    logits, _ = Runtime(device="cpu").prefill_step(cfg, S + 2)(_port(), prompt)
    assert calls == ([(S_ENC, S_ENC, False)] * cfg.enc_layers
                     + [(S, S, True), (S, S_ENC, False)] * cfg.n_layers)
    _close(logits, jlogits)


# ---------------------------------------------------------------------------
# the callers: seeds, slots, probes
# ---------------------------------------------------------------------------


def test_encoder_sites_draw_under_their_own_uids(monkeypatch):
    """One sketched step's generators, in order: each encoder layer i under
    uid 10,000 + i (JAX's ``seg_base``), then each decoder layer's
    self-attention, cross-attention and MLP under uid i; seed = step → uid →
    role id, as in JAX."""
    _, cfg, _, batch = _setup()
    seeds = []
    real = rng.generator
    monkeypatch.setattr(rng, "generator", lambda s, d: seeds.append(s) or real(s, d))
    _grads(cfg, _port(), batch, _policy("torch", 0.5, "pallas", 16), key=13)

    def seed(uid, roles):
        return [rng.fold_in(rng.fold_in(13, uid), ROLES.index(r)) for r in roles]

    attn = ["attn_q", "attn_k", "attn_v", "attn_o"]
    ffn = ["mlp_in", "mlp_out"]  # gelu
    want = [s for i in range(cfg.enc_layers) for s in seed(lm.ENCODER_UID_BASE + i, attn + ffn)]
    want += [s for i in range(cfg.n_layers)
             for s in seed(i, attn + ["cross_q", "cross_k", "cross_v", "cross_o"] + ffn)]
    assert seeds == want and len(set(seeds)) == len(seeds)


def test_slot_builders_put_slots_where_jax_does():
    """gslot, sslot and pslot at JAX's paths: the encoder's attention and MLP
    sites and the decoder's self, cross and MLP sites."""
    jcfg, cfg, jparams, _ = _setup()
    seen = same_slot_paths(jparams, _port(), cfg, jcfg)
    assert {p.rsplit("/", 1)[0] for p in seen["gslot"]} == {
        "encoder/segments/0/0/attn", "encoder/segments/0/0/mlp", "segments/0/0/attn",
        "segments/0/0/cross", "segments/0/0/mlp"}


def test_site_key_maps_encoder_layers_through_their_paths():
    """An encoder site maps through ``jax_layer_paths(cfg, encoder=True)``,
    the one rule for the encoder's JAX path; without that list it raises
    rather than guess a segment."""
    cfg = registry.smoke_config(ARCH)
    enc = lm.jax_layer_paths(cfg, encoder=True)
    assert probes.site_key("encoder/layers/1/attn/q", None, enc) == f"{enc[1]}/attn/q"
    assert probes.site_key("layers/0/cross/k", lm.jax_layer_paths(cfg), enc) == (
        "segments/0/0/cross/k")
    with pytest.raises(ValueError, match="encoder_paths"):
        probes.site_key("encoder/layers/0/mlp/in")


def test_probe_sites_match_jax():
    """One train step with probes at budget 0.999 (pallas, SGD) at 1 + 1
    layers in each package: ``probe_sites`` has JAX's keys, the encoder's
    under ``encoder/segments/0/0``, and JAX's vectors (relative 1e-4: sums
    of squared gradient rows; every column kept with probability 1, so the
    variance is 0 in both); loss and parameters as JAX's."""
    jcfg, cfg, jparams, batch = _setup(True)
    jopt = jsgd(0.1)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, _policy("jax", 0.999),
                                     execution=JExecutionConfig(telemetry=JTelemetryConfig())))
    jstate = JTrainState(params=jparams, opt_state=jopt.init(jparams),
                         step=jnp.zeros((), jnp.int32))
    jstate, jm = jstep(jstate, _jb(batch), jax.random.key(1))
    runtime = Runtime(policy=_policy("torch", 0.999),
                      execution=ExecutionConfig(telemetry=TelemetryConfig()), device="cpu")
    opt = sgd(0.1)
    state = runtime.init_state(0, cfg, opt, params=_port(True))
    state, m = runtime.train_step(cfg, opt)(state, batch, 1)
    jsites = jax.device_get(jm["probe_sites"])
    assert sorted(m["probe_sites"]) == sorted(jsites)
    assert "encoder/segments/0/0/attn/q" in jsites and "segments/0/0/cross/k" in jsites
    for key, v in m["probe_sites"].items():
        want = np.asarray(jsites[key])
        np.testing.assert_allclose(v.numpy(), want, rtol=PROBE_RTOL,
                                   atol=PROBE_RTOL * np.abs(want).max())
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL, abs=ATOL)
    want = tree_leaves(params_from_jax(jax.device_get(jstate.params), cfg, device="cpu"))
    for a, b in zip(tree_leaves(state.params), want):
        _close(a, b.numpy())
