"""The named-config registry, gemma3's local/global interleave and the MoE
family on the CPU against JAX.

The smoke configs of the ported architectures (the dense yi-6b, llama3-405b
and nemotron-4-340b, gemma3-1b's 5 local : 1 global layers, the MoE
olmoe-1b-7b and mixtral-8x22b) run in both packages on JAX's
``lm.init_params`` weights (``params_from_jax``) and the same numpy tokens.
JAX runs with ``remat="none"`` (the same function, a shorter compile) and
reaches its kernels' plain references on the CPU, as its own tests do.

Tolerances: float32, rtol 1e-5 with atol 1e-6 for the loss and aux and 1e-5
for logits, gradients and caches (test_torch_lm.py's): both packages sum the
same matmuls in other orders over up to 7 layers. Routing agrees exactly (the
router's top-k of identical float32 probabilities), so the MoE outputs differ
only by those sums. Bits are compared on one torch intra-op thread.
"""
import dataclasses
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
from repro.models import lm as jlm
from repro.nn import moe as jmoe
from repro.nn.common import Ctx as JCtx
from repro.optim import sgd as jsgd
from repro.serve.serve_step import greedy_sample as jgreedy
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import rng
from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
from repro_torch.configs import base, registry
from repro_torch.core import compact_grad as cgrad
from repro_torch.core.policy import ROLES
from repro_torch.interop import caches_from_jax, params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.nn import moe
from repro_torch.nn.common import Ctx
from repro_torch.optim import sgd
from repro_torch.serve import greedy_sample
from repro_torch.telemetry import TelemetryConfig
from repro_torch.tree import tree_leaves

RTOL, ATOL, TOL = 1e-5, 1e-6, 1e-5
PORTED = ("yi_6b", "llama3_405b", "nemotron_4_340b", "gemma3_1b", "olmoe_1b_7b",
          "mixtral_8x22b")
RECURRENT = ("zamba2_7b", "rwkv6_3b")  # refused until their port; tests/test_torch_ssm.py
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the bit-for-bit comparisons need the CPU's
    reductions to give the same bits on every call, and the test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policy(pkg, budget, backend="pallas", block=128):
    kw = dict(method="l1", budget=budget, backend=backend, block=block)
    return (JSketchPolicy(base=JSketchConfig(**kw)) if pkg == "jax"
            else SketchPolicy(base=SketchConfig(**kw)))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = jreg.smoke_config(arch).replace(remat="none")
    cfg = registry.smoke_config(arch)
    jparams = jax.device_get(jlm.init_params(jax.random.key(1), jcfg))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    return jcfg, cfg, jparams, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _port(arch):
    _, cfg, jparams, _ = _setup(arch)
    return params_from_jax(jparams, cfg, device="cpu")


def _tb(batch):
    return {k: torch.tensor(v).long() for k, v in batch.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_configs_and_cells_equal_jax(arch):
    assert registry.ARCH_IDS == jreg.ARCH_IDS
    assert registry._ALIASES == jreg._ALIASES
    alias = arch.replace("_", "-")
    for get in ("get_config", "smoke_config"):
        got = dataclasses.asdict(getattr(registry, get)(alias))
        assert got == dataclasses.asdict(getattr(jreg, get)(alias)), get
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    assert [c.name for c in registry.cells_for(cfg)] == [c.name for c in jreg.cells_for(jcfg)]
    assert ([dataclasses.astuple(c) for c in registry.skipped_cells_for(cfg)]
            == [dataclasses.astuple(c) for c in jreg.skipped_cells_for(jcfg)])
    from repro.configs.base import SHAPE_CELLS as JCELLS

    assert ({k: dataclasses.astuple(v) for k, v in base.SHAPE_CELLS.items()}
            == {k: dataclasses.astuple(v) for k, v in JCELLS.items()})
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ("qwen2_vl_2b", "seamless_m4t_large_v2"))
def test_vlm_and_audio_families_build(arch):
    """The VLM and audio families, once refused here, now build: the
    decoder check takes the full config, and the smoke config's weights
    have JAX's leaves (its stacked layers counted one by one) and parameter
    count (their parity with JAX: test_torch_vlm.py and
    test_torch_audio.py)."""
    cfg = registry.get_config(arch)
    assert cfg.name == jreg.get_config(arch).name
    lm.check_decoder(cfg)
    smoke = registry.smoke_config(arch)
    lm.check_decoder(smoke)
    params = lm.init_params(0, smoke, device="cpu")
    jparams = jax.device_get(jlm.init_params(jax.random.key(0), jreg.smoke_config(arch)))
    want = tree_leaves(params_from_jax(jparams, smoke, device="cpu"))
    assert len(tree_leaves(params)) == len(want) > len(jax.tree.leaves(jparams))
    assert lm.num_params(params) == jlm.num_params(jparams)


def test_unknown_families_and_frontends_refuse_by_name():
    """A family, frontend, rope or block kind outside the ported ones is
    refused by name before any work."""
    base = registry.smoke_config("yi_6b")
    for change, what in ((dict(family="diffusion"), "the diffusion family"),
                         (dict(frontend="video"), "the video frontend"),
                         (dict(rope="yarn"), "rope 'yarn'"),
                         (dict(block_kind="mamba"), "block kind 'mamba'"),
                         (dict(block_kind="rwkv", enc_layers=2), "an encoder-decoder")):
        cfg = base.replace(name="odd", **change)
        for call in (lambda: lm.init_params(0, cfg, device="cpu"),
                     lambda: lm.init_cache(cfg, 1, 8, device="cpu"),
                     lambda: lm.check_decoder(cfg)):
            with pytest.raises(NotImplementedError, match=f"odd: {what}"):
                call()


@pytest.mark.parametrize("arch", RECURRENT)
def test_ssm_and_hybrid_families_run(arch):
    """The SSM and hybrid families, once refused here, now run: the decoder
    check takes the full config, and the smoke config's weights, caches and
    forward build on the CPU (their parity with JAX: test_torch_ssm.py)."""
    cfg = registry.get_config(arch)
    assert cfg.name == jreg.get_config(arch).name
    lm.check_decoder(cfg)
    smoke = registry.smoke_config(arch)
    params = lm.init_params(0, smoke, device="cpu")
    caches = lm.init_cache(smoke, 1, 8, device="cpu")
    assert len(params["layers"]) == len(caches) == len(lm.layer_kinds(smoke))
    toks = torch.randint(0, smoke.vocab, (1, 8), generator=torch.Generator().manual_seed(0))
    logits = lm.forward(params, {"tokens": toks}, Ctx(), smoke)
    assert logits.shape == (1, 8, smoke.vocab) and torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# gemma3's layer plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which,n_full,rem", [("smoke", 1, 1), ("full", 4, 2)])
def test_gemma3_plan_is_five_local_one_global_then_the_remainder(which, n_full, rem):
    get = registry.smoke_config if which == "smoke" else registry.get_config
    jget = jreg.smoke_config if which == "smoke" else jreg.get_config
    cfg = get("gemma3_1b")
    plan, jplan = lm.plan_segments(cfg), jlm.plan_segments(jget("gemma3_1b"))
    assert ([(tuple(map(dataclasses.astuple, p)), n) for p, n in plan]
            == [(tuple(map(dataclasses.astuple, p)), n) for p, n in jplan])
    kinds = lm.layer_kinds(cfg)
    assert len(kinds) == cfg.n_layers == 6 * n_full + rem
    is_global = [k.window is None for k in kinds]
    assert is_global == ([False] * 5 + [True]) * n_full + [False] * rem
    for uid, kind in enumerate(kinds):
        acfg = lm.attn_cfg(cfg, kind)
        if is_global[uid]:
            assert (acfg.window, acfg.theta) == (None, cfg.rope_theta_global)
        else:
            assert (acfg.window, acfg.theta) == (cfg.window, cfg.rope_theta)
        assert acfg.n_kv == 1 and acfg.d_head == cfg.head_dim
    assert lm.jax_layer_paths(cfg) == (
        [f"segments/0/{i}" for _ in range(n_full) for i in range(6)]
        + ["segments/1/0"] * rem)
    # the caches: a ring of the window's size in local layers, full in global
    caches = lm.init_cache(cfg, 1, 4 * cfg.window, device="cpu")
    assert [c["k"].shape[1] for c in caches] == [4 * cfg.window if g else cfg.window
                                                 for g in is_global]


# ---------------------------------------------------------------------------
# each ported architecture against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PORTED)
def test_params_from_jax_unstacks_every_segment(arch):
    jcfg, cfg, jparams, _ = _setup(arch)
    params = _port(arch)
    assert lm.num_params(params) == jlm.num_params(jparams)
    assert lm.active_params_per_token(params, cfg) == jlm.active_params_per_token(jparams, jcfg)
    assert len(params["layers"]) == cfg.n_layers
    paths = lm.jax_layer_paths(cfg)
    for uid, layer in enumerate(params["layers"]):
        _, si, sub = paths[uid].split("/")
        rep = sum(p == paths[uid] for p in paths[:uid])
        jlayer = jparams["segments"][int(si)][int(sub)]
        np.testing.assert_array_equal(layer["attn"]["q"]["w"].numpy(),
                                      np.asarray(jlayer["attn"]["q"]["w"][rep]))
        ffn = "moe" if cfg.n_experts else "mlp"
        assert set(layer) == {"norm1", "attn", "norm2", ffn}
        if ffn == "moe":  # the expert axis stays
            assert layer["moe"]["wi"].shape == (cfg.n_experts, cfg.d_ff, cfg.d_model)
            np.testing.assert_array_equal(layer["moe"]["wo"].numpy(),
                                          np.asarray(jlayer["moe"]["wo"][rep]))


@pytest.mark.parametrize("arch", PORTED)
def test_logits_aux_and_loss_match_jax(arch):
    jcfg, cfg, jparams, batch = _setup(arch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, jaux = jlm.forward(jparams, jbatch, JCtx(), jcfg)
    jloss, jm = jlm.lm_loss(jparams, jbatch, JCtx(), jcfg)
    params = _port(arch)
    logits, aux = lm.forward_with_aux(params, _tb(batch), Ctx(), cfg)
    loss, m = lm.lm_loss(params, _tb(batch), Ctx(), cfg)
    _close(logits, jlogits)
    assert set(m) == set(jm) == {"loss", "aux", "nll"}
    for got, want in ((aux, jaux), (loss, jloss), (m["nll"], jm["nll"])):
        assert float(got) == pytest.approx(float(want), rel=RTOL, abs=ATOL)
    assert (float(aux) > 0) == (cfg.n_experts > 0)


def _jax_grads(arch, budget, backend="pallas"):
    jcfg, _, jparams, batch = _setup(arch)
    pol = None if budget is None else _policy("jax", budget, backend)
    key = None if budget is None else jax.random.key(5)
    ctx = JExecutionConfig().make_ctx(policy=pol, key=key)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jbatch, ctx, jcfg, key)[0]))(jparams)
    return float(loss), jax.device_get(g)


def _grads(cfg, params, batch, policy, key=7):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    ctx = Ctx(policy=policy, key=key if policy else None, n_layers=cfg.n_layers)
    loss, _ = lm.lm_loss(params, _tb(batch), ctx, cfg, key if policy else None)
    return float(loss.detach()), list(torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("budget", [None, 0.999])
def test_every_gradient_matches_jax(arch, budget):
    """Exact backprop, and the pallas policy at budget 0.999 (every block
    kept with scale 1; sites narrower than a block run per column with r =
    n): every leaf's gradient, the expert stacks and the router included."""
    _, cfg, _, batch = _setup(arch)
    jloss, jg = _jax_grads(arch, budget)
    loss, g = _grads(cfg, _port(arch), batch,
                     None if budget is None else _policy("torch", budget))
    assert loss == pytest.approx(jloss, rel=RTOL, abs=ATOL)
    want = tree_leaves(params_from_jax(jg, cfg, device="cpu"))
    assert len(g) == len(want)
    for a, b in zip(g, want):
        assert a.shape == b.shape
        _close(a, b.numpy())


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_four_decode_steps_match_jax(arch):
    """Each package's Runtime prefills two 20-token prompts (longer than
    gemma3's smoke window of 16: its local layers' caches are rings) and
    decodes 4 greedy tokens: the same logits, caches (through
    ``caches_from_jax``) and tokens. MoE decode routes its N = B tokens under
    their own capacity."""
    jcfg, cfg, jparams, _ = _setup(arch)
    params = _port(arch)
    P, steps = 20, 4
    max_len = P + steps + 2
    toks = np.random.default_rng(11).integers(1, cfg.vocab, size=(2, P)).astype(np.int32)
    jrt, rt = JRuntime(), Runtime(device="cpu")
    jlogits, jcaches = jrt.prefill_step(jcfg, max_len)(jparams, {"tokens": jnp.asarray(toks)})
    logits, caches = rt.prefill_step(cfg, max_len)(params, {"tokens": toks})
    _close(logits, jlogits)
    want_sizes = [max_len if k.window is None else min(k.window, max_len)
                  for k in lm.layer_kinds(cfg)]
    assert [c["k"].shape[1] for c in caches] == want_sizes

    def same_caches():
        for c, w in zip(caches, caches_from_jax(jax.device_get(jcaches), cfg, device="cpu")):
            _close(c["k"], w["k"].numpy())
            _close(c["v"], w["v"].numpy())

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


def test_gemma3_prefill_runs_flash_per_layer_with_its_window(monkeypatch):
    """With attn_impl="pallas" every layer's prefill reaches the flash
    dispatcher: the local layers with their window, the global one without
    (JAX runs its Pallas kernel in interpret mode); logits as JAX's."""
    monkeypatch.setenv("REPRO_FORCE_INTERPRET", "1")
    jcfg, cfg, jparams, _ = _setup("gemma3_1b")
    jcfg, cfg = jcfg.replace(attn_impl="pallas"), cfg.replace(attn_impl="pallas")
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: calls.append(kw["window"])
                        or real(*a, **kw))
    toks = np.random.default_rng(12).integers(1, cfg.vocab, size=(2, 20)).astype(np.int32)
    jlogits, _ = JRuntime().prefill_step(jcfg, 24)(jparams, {"tokens": jnp.asarray(toks)})
    logits, _ = Runtime(device="cpu").prefill_step(cfg, 24)(_port("gemma3_1b"),
                                                            {"tokens": toks})
    assert calls == [cfg.window] * 5 + [None] + [cfg.window]
    # JAX's kernel normalises its softmax online over tiles: its test's 3e-4
    _close(logits, jlogits, 3e-4)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def _moe_problem(cf, N=40, d=16, F=8, E=4, k=2, seed=0):
    cfg = moe.MoECfg(E, k, F, capacity_factor=cf)
    jcfg = jmoe.MoECfg(E, k, F, capacity_factor=cf)
    jp = jax.device_get(jmoe.moe_init(jax.random.key(seed), d, jcfg))
    x = np.random.default_rng(seed).normal(size=(N, d)).astype(np.float32)
    return cfg, jcfg, jp, x


def _tp(jp):
    return {k: ({"w": torch.tensor(np.asarray(v["w"]))} if isinstance(v, dict)
                else torch.tensor(np.asarray(v))) for k, v in jp.items()}


@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_moe_local_matches_jax(cf):
    """Dispatch, the experts and the combine, at capacity factor 1.0 (replicas
    dropped: the overflow slot) and 8.0 (none dropped): outputs, load
    statistics and the gradients of the input, router and expert stacks."""
    cfg, jcfg, jp, x = _moe_problem(cf)
    N = x.shape[0]
    cap = moe.capacity(N, cfg)
    assert cap == max(1, -(-int(N * cfg.top_k * cf) // cfg.n_experts))
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jf(p, xx):
        y, st = jmoe._moe_local(p["router"]["w"], p["wi"], p["wg"], p["wo"], xx, JCtx(), jcfg,
                                0, cfg.n_experts, cap)
        return jnp.sum(y * w) + jnp.sum(st["me"] * st["disp"]), (y, st)

    (_, (jy, jst)), (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    p = _tp(jp)
    for t in tree_leaves(p):
        t.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    y, st = moe._moe_local(p["router"]["w"], p["wi"], p["wg"], p["wo"], tx, Ctx(), cfg, 0,
                           cfg.n_experts, cap)
    _close(y, jy)
    _close(st["me"], jst["me"])
    np.testing.assert_array_equal(st["disp"].numpy(), np.asarray(jst["disp"]))
    (y * torch.tensor(w)).sum().add((st["me"] * st["disp"]).sum()).backward()
    _close(tx.grad, jgx)
    for key in ("wi", "wg", "wo"):
        _close(p[key].grad, jgp[key])
    _close(p["router"]["w"].grad, jgp["router"]["w"])
    # at 1.0 some replica overflows its expert's bucket, at 8.0 none does
    loads = (st["disp"] * N * cfg.top_k).round().long()
    dropped = int((loads - cap).clamp_min(0).sum())
    assert (dropped > 0) == (cf == 1.0), dropped


def test_moe_decode_routes_batch_tokens_under_their_own_capacity():
    """moe_ffn on [B, 1, d] (decode): N = B tokens, capacity from N, output and
    aux as JAX's."""
    cfg, jcfg, jp, x = _moe_problem(1.25, N=3)
    x3 = x.reshape(3, 1, -1)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x3), JCtx(), jcfg)
    y, aux = moe.moe_ffn(_tp(jp), torch.tensor(x3), Ctx(), cfg)
    assert moe.capacity(3, cfg) == 2
    _close(y, jy)
    assert float(aux) == pytest.approx(float(jaux), rel=RTOL, abs=ATOL)


@pytest.mark.parametrize("backend", ["pallas", "onepass", "stale"])
def test_sketched_moe_at_full_keep_equals_exact(backend):
    """olmoe's smoke config at budget 0.999, block 16 (the expert sites' 32-
    and 64-wide G keep every block with scale 1; the plan-carry backends
    sample the uniform prior, having no carry on expert sites): every
    gradient equals exact backprop's, routing being backward-free."""
    _, cfg, _, batch = _setup("olmoe_1b_7b")
    _, g_exact = _grads(cfg, _port("olmoe_1b_7b"), batch, None)
    loss, g_sk = _grads(cfg, _port("olmoe_1b_7b"), batch, _policy("torch", 0.999, backend, 16))
    for a, b in zip(g_exact, g_sk):
        _close(b, a.numpy())


def test_expert_weight_sketch_is_unbiased():
    """E[sketched dW] = exact dW for the expert stacks: 400 draws of the
    block-4 l1 pallas estimator at budget 0.5 (one of two blocks kept per
    expert site), each element's mean within 6 standard errors of the
    exact gradient (plus 1e-6 of its scale for elements the sketch never
    drops)."""
    cfg, _, jp, x = _moe_problem(8.0, N=24)
    p = _tp(jp)
    for t in tree_leaves(p):
        t.requires_grad_(True)
    pol = _policy("torch", 0.5, "pallas", 4)
    xt = torch.tensor(x).reshape(1, 24, -1)
    wt = torch.tensor(np.random.default_rng(2).normal(size=xt.shape).astype(np.float32))
    stacks = [p["wi"], p["wg"], p["wo"]]

    def grads(ctx):
        y, _ = moe.moe_ffn(p, xt, ctx, cfg)
        return torch.autograd.grad((y * wt).sum(), stacks)

    exact = grads(Ctx())
    n = 400
    draws = [grads(Ctx(policy=pol, key=rng.fold_in(99, i))) for i in range(n)]
    for j, g in enumerate(exact):
        d = torch.stack([dr[j] for dr in draws]).double()
        assert not torch.equal(d[0], d[1]), "the sketch drew the same plan twice"
        se = d.std(0) / np.sqrt(n)
        err = (d.mean(0) - g.double()).abs()
        assert bool((err <= 6 * se + 1e-6 * g.abs().max()).all()), j


def test_expert_sites_never_share_a_seed(monkeypatch):
    """One sketched olmoe smoke step: every sketched site (4 attention + 3
    per expert, in each of 2 layers) draws from a generator of its own seed,
    derived layer → 1000 → expert → role."""
    _, cfg, _, batch = _setup("olmoe_1b_7b")
    seeds = []
    real = rng.generator
    monkeypatch.setattr(rng, "generator", lambda s, d: seeds.append(s) or real(s, d))
    _grads(cfg, _port("olmoe_1b_7b"), batch, _policy("torch", 0.5, "pallas", 16), key=13)
    E = cfg.n_experts
    assert len(seeds) == len(set(seeds)) == cfg.n_layers * (4 + 3 * E)
    layer = rng.fold_in(13, 1)
    want = rng.fold_in(rng.fold_in(rng.fold_in(layer, 1000), E - 1), ROLES.index("expert_out"))
    assert want in seeds


def test_moe_refuses_a_mesh():
    """A model axis that divides neither the experts (4) nor their d_ff (8)
    is refused by name, as JAX refuses it, before any collective (the EP and
    TPX modes: tests/test_torch_distributed_moe.py)."""
    from repro_torch.launch.mesh import layout

    cfg, _, jp, x = _moe_problem(1.0)
    ctx = Ctx(mesh=layout((1, 3), ("data", "model")))
    with pytest.raises(ValueError, match=r"neither experts \(4\) nor expert d_ff \(8\)"):
        moe.moe_ffn(_tp(jp), torch.tensor(x)[None], ctx, cfg)


# ---------------------------------------------------------------------------
# the callers: the train step, its slots and probes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "gemma3_1b"])
def test_sgd_step_matches_jax(arch):
    """One step through each package's step function at budget 0.999."""
    jcfg, cfg, jparams, batch = _setup(arch)
    jopt = jsgd(0.5)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, _policy("jax", 0.999),
                                     execution=JExecutionConfig()))
    jstate = JTrainState(params=jparams, opt_state=jopt.init(jparams),
                         step=jnp.zeros((), jnp.int32))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(1))
    runtime = Runtime(policy=_policy("torch", 0.999), device="cpu")
    opt = sgd(0.5)
    state = runtime.init_state(0, cfg, opt, params=_port(arch))
    state, m = runtime.train_step(cfg, opt)(state, batch, 1)
    for key in ("loss", "aux", "nll"):
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=RTOL, abs=ATOL), key
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    want = tree_leaves(params_from_jax(jax.device_get(jstate.params), cfg, device="cpu"))
    for a, b in zip(tree_leaves(state.params), want):
        _close(a, b.numpy())


def test_expert_leaves_take_no_slots():
    """Compact gradients, the plan carry and probes under ``stale`` on
    olmoe's smoke config: the attention sites get their gslot, sslot and
    pslot; the router and expert stacks are not sites and keep dense
    gradients, as in JAX."""
    _, cfg, _, batch = _setup("olmoe_1b_7b")
    pol = _policy("torch", 0.5, "stale", 16)
    runtime = Runtime(policy=pol, execution=ExecutionConfig(
        compact_grads=True, telemetry=TelemetryConfig()), device="cpu")
    opt = sgd(0.1)
    state = runtime.init_state(0, cfg, opt, params=_port("olmoe_1b_7b"))
    layer = state.params["layers"][0]
    assert "sslot" in layer["attn"]["q"] and "sslot" not in layer["moe"]
    seen = {}
    real = cgrad.fold_slot_grads
    monkey = pytest.MonkeyPatch()
    monkey.setattr(cgrad, "fold_slot_grads", lambda g: seen.setdefault("g", real(g)))
    try:
        state, m = runtime.train_step(cfg, opt)(state, batch, 3)
    finally:
        monkey.undo()
    g = seen["g"]["layers"][0]
    assert isinstance(g["attn"]["q"]["w"], cgrad.CompactGrad)
    assert all(isinstance(g["moe"][k], torch.Tensor) for k in ("wi", "wg", "wo"))
    assert isinstance(g["moe"]["router"]["w"], torch.Tensor)
    assert set(m["probe_sites"]) == {f"segments/0/0/attn/{s}" for s in "qkvo"}
    assert all(np.isfinite(float(m[k])) for k in ("loss", "aux", "grad_norm"))


def test_gemma3_probe_keys_are_jax_segment_paths():
    """Probe sites of a model of two segments sum under JAX's paths."""
    _, cfg, _, batch = _setup("gemma3_1b")
    runtime = Runtime(policy=_policy("torch", 0.5, "pallas", 16),
                      execution=ExecutionConfig(telemetry=TelemetryConfig()), device="cpu")
    opt = sgd(0.1)
    state = runtime.init_state(0, cfg, opt, params=_port("gemma3_1b"))
    _, m = runtime.train_step(cfg, opt)(state, batch, 3)
    prefixes = {k.rsplit("/", 2)[0] for k in m["probe_sites"]}
    assert prefixes == {f"segments/0/{i}" for i in range(6)} | {"segments/1/0"}
    assert np.isfinite(float(m["probe_snr"]))
