"""The slice as a whole on the CPU: the tiny LM of examples/train_lm.py
(--tiny) in both packages on the same weights and tokens.

JAX's ``lm.init_params`` weights are carried across with ``params_from_jax``.
Tolerance: float32 rtol=1e-5 with atol=1e-6 for the loss and atol=1e-5 for
gradients and updated parameters — JAX's chunked attention normalises its
softmax online and both packages sum the 64- to 512-term matmuls in other
orders, so an element that cancels keeps that absolute rounding.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.execution import ExecutionConfig as JExecutionConfig
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import SketchConfig as JSketchConfig
from repro.core import SketchPolicy as JSketchPolicy
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import cosine_warmup as jcosine_warmup
from repro.optim import sgd as jsgd
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import rng
from repro_torch.api import Runtime, SketchConfig, SketchPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import ROLES
from repro_torch.interop import params_from_jax
from repro_torch.models import lm
from repro_torch.nn.common import Ctx
from repro_torch.optim import adamw, cosine_warmup, sgd
from repro_torch.train.trainer import TrainerConfig
from repro_torch.tree import tree_leaves

RTOL, ATOL, GRAD_ATOL = 1e-5, 1e-6, 1e-5
TINY = dict(name="lm-tiny", family="dense", n_layers=2, d_model=128, n_heads=4, n_kv=2,
            d_ff=512, vocab=512, q_chunk=64, kv_chunk=64)
B, S = 2, 32
ROOT = Path(__file__).resolve().parents[1]


def _slice_policy(pkg, budget):
    cfg = dict(method="l1", budget=budget, backend="pallas", block=128)
    if pkg == "jax":
        return JSketchPolicy(base=JSketchConfig(**cfg))
    return SketchPolicy(base=SketchConfig(**cfg))


@pytest.fixture(scope="module")
def setup():
    jcfg = JArchConfig(**TINY)
    cfg = ArchConfig(**TINY)
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    r = np.random.default_rng(0)
    toks = r.integers(0, TINY["vocab"], size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return jcfg, cfg, jparams, batch


def _torch_batch(batch):
    return {k: torch.tensor(v).long() for k, v in batch.items()}


def _jax_grads(jcfg, jparams, batch, policy):
    ctx = JExecutionConfig().make_ctx(policy=policy, key=jax.random.key(5) if policy else None)
    key = jax.random.key(5) if policy else None

    def f(p):
        return jlm.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, ctx, jcfg, key)[0]

    loss, g = jax.jit(jax.value_and_grad(f))(jparams)
    return float(loss), jax.device_get(g)


def _torch_grads(cfg, params, batch, policy):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    ctx = Ctx(policy=policy, key=7 if policy else None, n_layers=cfg.n_layers)
    loss, _ = lm.lm_loss(params, _torch_batch(batch), ctx, cfg, 7 if policy else None)
    return float(loss.detach()), list(torch.autograd.grad(loss, leaves))


def _compare_trees(got_leaves, want_tree, cfg, atol):
    want = tree_leaves(params_from_jax(want_tree, cfg, device="cpu"))
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=RTOL, atol=atol)


def test_params_from_jax_keeps_every_weight(setup):
    jcfg, cfg, jparams, _ = setup
    params = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    assert lm.num_params(params) == jlm.num_params(jparams)
    np.testing.assert_array_equal(params["layers"][1]["attn"]["k"]["w"].numpy(),
                                  np.asarray(jparams["segments"][0][0]["attn"]["k"]["w"][1]))
    assert params["layers"][0]["mlp"]["gate"]["w"].shape == (512, 128)


@pytest.mark.parametrize("budget", [None, 0.999])
def test_lm_loss_and_grads_match_jax(setup, budget):
    """Exact backprop, and the sketched pallas policy at budget 0.999 — where
    every block-granular site keeps all its blocks (rb == nb) and the 64-wide
    k/v sites fall back to per-column with r == n — give JAX's gradients."""
    jcfg, cfg, jparams, batch = setup
    jpol = None if budget is None else _slice_policy("jax", budget)
    pol = None if budget is None else _slice_policy("torch", budget)
    jloss, jg = _jax_grads(jcfg, jparams, batch, jpol)
    params = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    loss, g = _torch_grads(cfg, params, batch, pol)
    assert loss == pytest.approx(jloss, rel=RTOL, abs=ATOL)
    _compare_trees(g, jg, cfg, GRAD_ATOL)


def test_sketched_grads_at_full_keep_equal_exact(setup):
    _, cfg, jparams, batch = setup
    params = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    _, g_exact = _torch_grads(cfg, params, batch, None)
    _, g_sk = _torch_grads(cfg, params, batch, _slice_policy("torch", 0.999))
    for a, b in zip(g_exact, g_sk):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=GRAD_ATOL)


def test_sgd_step_matches_jax(setup):
    """One train step through each package's step function (SGD: AdamW's
    first step is ~lr·sign(g) and would amplify rounding)."""
    jcfg, cfg, jparams, batch = setup
    jopt = jsgd(0.5)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, _slice_policy("jax", 0.999),
                                     execution=JExecutionConfig()))
    jstate = JTrainState(params=jparams, opt_state=jopt.init(jparams),
                         step=jnp.zeros((), jnp.int32))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(1))
    runtime = Runtime(policy=_slice_policy("torch", 0.999), device="cpu")
    opt = sgd(0.5)
    state = runtime.init_state(0, cfg, opt,
                               params=params_from_jax(jax.device_get(jparams), cfg,
                                                      device="cpu"))
    state, m = runtime.train_step(cfg, opt)(state, batch, 1)
    assert state.step == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL, abs=ATOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    _compare_trees(tree_leaves(state.params), jax.device_get(jstate.params), cfg, GRAD_ATOL)


def test_adamw_matches_jax_on_identical_gradients():
    """Three AdamW steps (cosine warmup, weight decay on matrices only, clip)
    on the same parameters and gradients."""
    r = np.random.default_rng(9)
    shapes = {"w": (6, 5), "b": (5,), "layers": [{"g": (4,)}, {"w": (3, 4)}]}

    def make(fn):
        return {"w": fn(shapes["w"]), "b": fn(shapes["b"]),
                "layers": [{"g": fn((4,))}, {"w": fn((3, 4))}]}

    p0 = make(lambda s: r.normal(size=s).astype(np.float32))
    grads = [make(lambda s: (3.0 * r.normal(size=s)).astype(np.float32)) for _ in range(3)]
    sched = dict(peak=1e-2, warmup=1, total=10)
    jopt = jadamw(jcosine_warmup(**sched), weight_decay=0.1, clip=1.0)
    opt = adamw(cosine_warmup(**sched), weight_decay=0.1, clip=1.0)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = jax.tree.map(torch.tensor, p0)
    ts = opt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.int32(step))
        tp, ts = opt.update(jax.tree.map(torch.tensor, g), ts, tp, step)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    for a, b in zip(tree_leaves(ts["v"]), jax.tree.leaves(js["v"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_runtime_train_on_cpu_and_default_device_raises(setup):
    _, cfg, _, _ = setup
    from repro_torch.data.synthetic import LMStream

    data = LMStream(vocab=cfg.vocab, seed=0).batches(B, S)
    opt = adamw(cosine_warmup(3e-4, 2, 4), weight_decay=0.1, clip=1.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Runtime(policy=_slice_policy("torch", 0.2)).train(cfg, opt, data,
                                                                 TrainerConfig(steps=2))
    state, hist = Runtime(policy=_slice_policy("torch", 0.2), device="cpu").train(
        cfg, opt, data, TrainerConfig(steps=3, log_every=1), on_metrics=lambda m: None)
    assert state.step == 3 and [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and h["loss"] > 0 for h in hist)


def test_site_seeds_follow_step_layer_role_and_never_repeat():
    """Seeds derive step → layer uid → role id; no two sites of a model (over
    several steps) share one, and the same derivation gives the same seed."""
    seen = set()
    for step in range(3):
        step_key = rng.fold_in(0, step + 1)
        ctx = Ctx(policy=None, key=None, n_layers=12)
        for uid in range(12):
            lctx = ctx.for_layer(step_key, uid)
            assert lctx.key == rng.fold_in(step_key, uid)
            for role in ROLES:
                seed = lctx.site_seed(role)
                assert seed == rng.fold_in(rng.fold_in(step_key, uid), ROLES.index(role))
                assert seed not in seen
                seen.add(seed)
    assert len(seen) == 3 * 12 * len(ROLES)
    g1, g2 = rng.generator(123, "cpu"), rng.generator(123, "cpu")
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))


def test_port_imports_neither_jax_nor_repro():
    """The package (the §5 models, rcs and variance, the serving engines, the
    observability and resilience layers included), its benchmarks (the §5
    figure experiments included) and chip_smoke.py import no JAX and nothing
    of repro."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
             + sorted((ROOT / "benchmarks" / "torch").glob("*.py")) + [ROOT / "chip_smoke.py"])
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/models/mlp.py", "src/repro_torch/models/vision.py",
            "src/repro_torch/nn/ssm.py",
            "src/repro_torch/core/variance.py", "benchmarks/torch/quickstart.py",
            "benchmarks/torch/fig3_larger_archs.py", "benchmarks/torch/serve_lm.py",
            "benchmarks/torch/bench_resilience.py", "benchmarks/torch/trace_drops.py"} <= names
    # the §5 figure experiments and their harness
    assert {f"benchmarks/torch/{m}.py" for m in (
        "common", "fig1a_correlation", "fig1b_mask_vs_sketch", "fig2a_proxies", "fig2b_spectral",
        "fig4_location", "bench_block_granularity", "bench_variance", "bench_adaptive",
        "sketch_comparison")} <= names
    # the serving engines, the observability and resilience layers,
    # pure-Python modules included: the port keeps its own copy of each
    for sub, mods in (("obs", ("__init__", "clock", "metrics", "tracing", "ledgers", "flight")),
                      ("serve", ("config", "scheduler", "kv_cache", "engine", "legacy")),
                      ("resilience", ("__init__", "faults", "sentinel", "supervisor"))):
        assert {f"src/repro_torch/{sub}/{m}.py" for m in mods} <= names
    assert len(files) > 20
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert offenders == []


def test_unported_configs_raise():
    for family in ("diffusion", "retrieval"):
        cfg = ArchConfig(**dict(TINY, family=family))
        with pytest.raises(NotImplementedError, match=f"the {family} family"):
            lm.init_params(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        lm.check_supported(ArchConfig(**dict(TINY, rope="alibi")))
