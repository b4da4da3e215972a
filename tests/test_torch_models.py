"""The paper's §5 models in repro_torch (the MLP, ViT and BagNet) against the
JAX package, at small sizes on the CPU.

Both packages get the same numpy inputs and the same JAX parameters, carried
across by ``repro_torch.interop``. Tolerances:

* logits and losses: rtol 1e-5 (float32, a few layers summed in another
  order), accuracy exactly;
* gradients: 1e-4 of each leaf's largest magnitude (float32 backprop through
  up to nine layers, convolutions and attention summed in another order);
* budget-0.999 sketched gradients against exact ones, in the port: the same
  1e-4 (every block and column is kept with scale 1; only the order of the
  sums changes);
* the MC unbiasedness tests: t-statistics over 400 draws with the thresholds
  of ``tests/test_sketching.py`` (mean |t| < 2.2, 95th percentile < 5, a
  standard-error floor of 1e-3 of the leaf's scale);
* 20 exact MLP steps: each step's loss within rtol 1e-4 of JAX's.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Runtime as JRuntime
from repro.api.execution import ExecutionConfig as JExecutionConfig
from repro.models import mlp as jmlp
from repro.models import vision as jvision
from repro.optim import constant as jconstant
from repro.optim import sgd as jsgd
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import interop, rng
from repro_torch.api import Runtime, SketchConfig, SketchPolicy
from repro_torch.data.synthetic import classification
from repro_torch.models import lm
from repro_torch.models import mlp as tmlp
from repro_torch.models import vision as tvision
from repro_torch.nn.common import Ctx
from repro_torch.optim import constant, sgd
from repro_torch.train.trainer import TrainerConfig
from repro_torch.tree import tree_leaves, tree_map

sketched_linear = importlib.import_module("repro_torch.core.sketched_linear")

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
MLP_SIZES = (20, 16, 16, 5)
VIT = dict(img=8, patch=4, d=32, depth=2, heads=4, d_ff=64)
BAGNET = dict(width=8, n_blocks=(1, 1, 1))
N_DRAWS = 400


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the MC draws are tiny, and with several test
    processes on the machine, each process's full thread pool oversubscribes
    the cores and slows every draw many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(model, seed=0):
    r = np.random.default_rng(seed)
    if model == "mlp":
        x = r.normal(size=(8, MLP_SIZES[0])).astype(np.float32)
        y = r.integers(0, MLP_SIZES[-1], 8).astype(np.int32)
    else:
        x = r.normal(size=(2, 8, 8, 3)).astype(np.float32)
        y = r.integers(0, 10, 2).astype(np.int32)
    return {"x": x, "y": y}


@functools.lru_cache(maxsize=None)
def _jax_params(model):
    key = jax.random.key(0)
    if model == "mlp":
        return jax.device_get(jmlp.mlp_init(key, MLP_SIZES))
    if model == "vit":
        return jax.device_get(jvision.vit_init(key, **VIT))
    return jax.device_get(jvision.bagnet_init(key, **BAGNET))


def _port_params(model):
    jp = _jax_params(model)
    if model == "mlp":
        return interop.params_from_jax(jp, tmlp.mlp_arch(MLP_SIZES), device="cpu")
    if model == "vit":
        return interop.vit_params_from_jax(jp, device="cpu")
    return interop.bagnet_params_from_jax(jp, device="cpu")


def _apply(pkg, model):
    if model == "mlp":
        return (jmlp if pkg == "jax" else tmlp).mlp_apply
    mod = jvision if pkg == "jax" else tvision
    if model == "vit":
        return functools.partial(mod.vit_apply, heads=VIT["heads"])
    return mod.bagnet_apply


def _loss(pkg, model, params, batch, ctx):
    if model == "mlp":
        return (jmlp if pkg == "jax" else tmlp).mlp_loss(params, batch, ctx)
    return (jvision if pkg == "jax" else tvision).cls_loss(_apply(pkg, model), params, batch,
                                                           ctx)


def _jax_exact(model, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(p):
        return _loss("jax", model, p, jb, JRuntime().ctx())

    (loss, acc), g = jax.jit(jax.value_and_grad(f, has_aux=True))(_jax_params(model))
    logits = _apply("jax", model)(_jax_params(model), jb["x"], JRuntime().ctx())
    return float(loss), float(acc), np.asarray(logits), jax.device_get(g)


def _grad_tree(model, params, batch, ctx):
    """(loss, acc, gradient tree shaped like ``params``) in the port."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tb = {"x": torch.tensor(batch["x"]), "y": torch.tensor(batch["y"]).long()}
    loss, acc = _loss("torch", model, params, tb, ctx)
    it = iter(torch.autograd.grad(loss, leaves))
    return float(loss.detach()), float(acc), tree_map(lambda _: next(it), params)


def _port_grads_of_jax(model, g):
    """JAX's gradient tree in the port's layout (conv weights OIHW)."""
    if model == "mlp":
        return interop.params_from_jax(g, tmlp.mlp_arch(MLP_SIZES), device="cpu")
    if model == "vit":
        return interop.vit_params_from_jax(g, device="cpu")
    return interop.bagnet_params_from_jax(g, device="cpu")


def _assert_trees_close(got, want, rel):
    """Every leaf of ``got`` within ``rel`` of its ``want`` leaf's largest
    magnitude (leaves paired by path, whatever the dicts' key order)."""
    pairs = []
    tree_map(lambda a, b: pairs.append((a, b)), got, want)
    assert pairs
    for a, b in pairs:
        assert a.shape == b.shape
        err = (a.detach() - b.detach()).abs().max().item()
        assert err <= rel * b.abs().max().item() + 1e-12, (tuple(a.shape), err)


def _policy(budget, block, **kw):
    return SketchPolicy(base=SketchConfig(method="l1", budget=budget, backend="pallas",
                                          block=block), exclude_roles=(), **kw)


MODELS = ["mlp", "vit", "bagnet"]


def test_interop_carries_each_family():
    jp = _jax_params("mlp")
    params = _port_params("mlp")
    assert len(params) == 3 and params[1]["w"].shape == (16, 16)
    np.testing.assert_array_equal(params[2]["b"].numpy(), np.asarray(jp[2]["b"]))
    jv, vit = _jax_params("vit"), _port_params("vit")
    np.testing.assert_array_equal(vit["layers"][1]["attn"]["v"]["w"].numpy(),
                                  np.asarray(jv["layers"][1]["attn"]["v"]["w"]))
    assert vit["pos"].shape == (1, 5, 32)
    jb, bag = _jax_params("bagnet"), _port_params("bagnet")
    # HWIO -> OIHW
    assert np.asarray(jb["stem"]["w"]).shape == (3, 3, 3, 8) and bag["stem"]["w"].shape == (8, 3,
                                                                                           3, 3)
    np.testing.assert_array_equal(bag["blocks"][1][0]["c2"]["w"][:, :, 0, 2].numpy(),
                                  np.asarray(jb["blocks"][1][0]["c2"]["w"])[0, 2].T)
    assert bag["blocks"][0][0]["c3"]["w"].shape == (16, 8) and bag["head"]["w"].shape == (10, 32)
    assert sum(p.numel() for p in tree_leaves(bag)) == sum(
        np.asarray(a).size for a in jax.tree.leaves(jb))


@pytest.mark.parametrize("model", MODELS)
def test_exact_logits_loss_and_grads_match_jax(model):
    batch = _inputs(model)
    jloss, jacc, jlogits, jg = _jax_exact(model, batch)
    params = _port_params(model)
    with torch.no_grad():
        logits = _apply("torch", model)(params, torch.tensor(batch["x"]), Ctx())
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * np.abs(jlogits).max())
    loss, acc, g = _grad_tree(model, params, batch, Runtime(device="cpu").ctx(budget=None))
    assert loss == pytest.approx(jloss, rel=LOSS_RTOL) and acc == jacc
    _assert_trees_close(g, _port_grads_of_jax(model, jg), GRAD_REL)


@pytest.mark.parametrize("model", MODELS)
def test_sketched_grads_at_budget_0999_equal_exact(model):
    """Block 8 (or per column where a width is no multiple of 8) at budget
    0.999 keeps every block and column with scale 1."""
    batch = _inputs(model)
    params = _port_params(model)
    _, _, exact = _grad_tree(model, params, batch, Ctx())
    runtime = Runtime(policy=_policy(0.999, 8), device="cpu")
    _, _, sk = _grad_tree(model, params, batch, runtime.ctx(rng.fold_in(3, 1)))
    _assert_trees_close(sk, exact, GRAD_REL)


@pytest.mark.parametrize("block", [0, 8])
@pytest.mark.parametrize("model", MODELS)
def test_sketched_model_gradient_unbiased_mc(model, block):
    """E[ĝ] = g for the whole model under l1 @ 0.5 on every site (the plain
    path of the pallas backend): the sketches of successive sites compose
    unbiasedly (each is unbiased given its input)."""
    batch = _inputs(model, seed=1)
    params = _port_params(model)
    _, _, exact = _grad_tree(model, params, batch, Ctx())
    runtime = Runtime(policy=_policy(0.5, block), device="cpu")
    draws = [_grad_tree(model, params, batch, runtime.ctx(rng.fold_in(100, i)))[2]
             for i in range(N_DRAWS)]
    n_sketched = 0
    for i, want in enumerate(tree_leaves(exact)):
        d = np.stack([tree_leaves(g)[i].numpy() for g in draws])
        want = want.numpy()
        scale = np.abs(want).max() + 1e-9
        std = d.std(0)
        det = std < 1e-6 * scale
        np.testing.assert_allclose(d.mean(0)[det], want[det], rtol=1e-3, atol=1e-4 * scale)
        if det.all():
            continue
        n_sketched += 1
        se = std[~det] / np.sqrt(N_DRAWS) + 1e-3 * scale
        t = np.abs(d.mean(0)[~det] - want[~det]) / se
        assert np.mean(t) < 2.2 and np.percentile(t, 95) < 5.0, (i, np.mean(t))
    assert n_sketched >= 2


def _mlp_batches(n):
    x, y = classification(16 * n, MLP_SIZES[0], MLP_SIZES[-1], seed=4)
    return [{"x": x[16 * i:16 * (i + 1)], "y": y[16 * i:16 * (i + 1)]} for i in range(n)]


def test_mlp_training_follows_jax():
    """20 exact MLP steps through ``Runtime(device="cpu").train`` (the
    ``family="mlp"`` dispatch of ``lm``) and through JAX's train step, from
    the same parameters on the same batches: the same loss at every step."""
    cfg = tmlp.mlp_arch(MLP_SIZES)
    jcfg = jmlp.mlp_arch(MLP_SIZES)
    batches = _mlp_batches(20)
    jp = _jax_params("mlp")
    jopt = jsgd(jconstant(0.2), clip=1.0)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, None, execution=JExecutionConfig()))
    jstate = JTrainState(params=jax.tree.map(jnp.asarray, jp), opt_state=jopt.init(jp),
                         step=jnp.zeros((), jnp.int32))
    jlosses, jaccs = [], []
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.key(i))
        jlosses.append(float(jm["loss"]))
        jaccs.append(float(jm["acc"]))
    runtime = Runtime(device="cpu")
    opt = sgd(constant(0.2), clip=1.0)
    state = runtime.init_state(0, cfg, opt, params=_port_params("mlp"))
    state, hist = runtime.train(cfg, opt, batches, TrainerConfig(steps=20, log_every=1),
                                state=state, on_metrics=lambda m: None)
    assert state.step == 20
    np.testing.assert_allclose([h["loss"] for h in hist], jlosses, rtol=1e-4)
    assert [h["acc"] for h in hist] == pytest.approx(jaccs, abs=1e-6)
    assert jlosses[-1] < jlosses[0]


def test_mlp_arch_dispatch():
    cfg = tmlp.mlp_arch((784, 64, 64, 10))
    assert tmlp.mlp_sizes(cfg) == (784, 64, 64, 10)
    assert tmlp.mlp_sizes(cfg) == jmlp.mlp_sizes(jmlp.mlp_arch((784, 64, 64, 10)))
    params = lm.init_params(0, cfg, device="cpu")
    assert [tuple(p["w"].shape) for p in params] == [(64, 784), (64, 64), (10, 64)]
    with pytest.raises(ValueError, match="one hidden width"):
        tmlp.mlp_arch((10, 8, 6, 2))
    with pytest.raises(NotImplementedError, match="dense decoder family"):
        lm.init_cache(cfg, 1, 4, device="cpu")
    batch = {"x": torch.randn(4, 784), "y": torch.tensor([0, 1, 2, 3])}
    loss, m = lm.lm_loss(params, batch, Ctx(), cfg)
    assert set(m) == {"loss", "acc", "nll"} and 0.0 <= float(m["acc"]) <= 1.0


@pytest.mark.parametrize("location,layer", [("first", 0), ("last", 2)])
def test_location_sketches_only_the_named_layer(monkeypatch, location, layer):
    """``location="first"``/``"last"`` sketches one MLP layer: only that
    site samples a plan, and with "first" every later layer's gradient is
    exact (it is computed before the sketched backward)."""
    batch = _inputs("mlp")
    params = _port_params("mlp")
    planned = []
    real = sketched_linear.column_plan

    def spy(cfg, G2d, W, gen, **kw):
        planned.append(tuple(W.shape))
        return real(cfg, G2d, W, gen, **kw)

    monkeypatch.setattr(sketched_linear, "column_plan", spy)
    _, _, exact = _grad_tree("mlp", params, batch, Ctx())
    runtime = Runtime(policy=_policy(0.5, 0, location=location), device="cpu")
    _, _, sk = _grad_tree("mlp", params, batch, runtime.ctx(rng.fold_in(9, 1)))
    assert planned == [tuple(params[layer]["w"].shape)]
    assert not torch.allclose(sk[layer]["w"], exact[layer]["w"])
    if location == "first":
        for i in (1, 2):
            assert torch.equal(sk[i]["w"], exact[i]["w"])
