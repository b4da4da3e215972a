"""The VLM family (qwen2-vl-2b: M-RoPE over a stub vision frontend) on the
CPU against JAX.

The smoke config (2 layers, d 48, GQA 6:2, d_head 8) runs in both packages
on JAX's ``lm.init_params`` weights (``params_from_jax``; JAX with
``remat="none"``: the same function, a shorter compile) and the same numpy
inputs: ``embeds`` (normal x 0.02, as JAX's smoke tests feed the stub) and
M-RoPE ``positions`` [3, B, S] in Qwen2-VL's layout for one image and then
text. A 4 x 4 patch grid takes the first 16 tokens (t 0, h the row, w the
column); the text tokens after it take g + i in all three streams, g = 4.
With three distinct streams the sections of the head's frequency slots
matter; with equal streams M-RoPE is plain RoPE.

Tolerances (float32), each stated where it is used: ``TOL`` 1e-5 (rtol and
atol) for rotations, logits, caches and gradients (test_torch_lm.py's: both
packages sum the same matmuls in other orders), ``RTOL``/``ATOL`` 1e-5/1e-6
for losses, and JAX's own 3e-5 for prefill plus decode against the
forward. Bits are compared on one torch intra-op thread.
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
from repro.core import compact_grad as jcgrad
from repro.core import plan_state as jpstate
from repro.models import lm as jlm
from repro.nn import rope as jrope
from repro.nn.common import Ctx as JCtx
from repro.optim import sgd as jsgd
from repro.telemetry import probes as jprobes
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
from repro_torch.configs import registry
from repro_torch.core import compact_grad as cgrad
from repro_torch.core import plan_state as pstate
from repro_torch.interop import caches_from_jax, params_from_jax
from repro_torch.models import lm
from repro_torch.nn import rope
from repro_torch.nn.common import Ctx
from repro_torch.optim import sgd
from repro_torch.telemetry import probes
from repro_torch.train.train_step import _split_batch
from repro_torch.tree import tree_leaves

ARCH = "qwen2_vl_2b"
TOL, RTOL, ATOL, CONSISTENCY_TOL = 1e-5, 1e-5, 1e-6, 3e-5
B, S, GRID = 2, 24, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the bit-for-bit comparisons need the CPU's
    reductions to give the same bits on every call, and the test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grid_positions(batch: int, seq: int, grid: int) -> np.ndarray:
    """[3, batch, seq] int32 M-RoPE positions in Qwen2-VL's layout: a grid x
    grid image (t 0, h the row, w the column), then text at grid + i in all
    three streams."""
    n = grid * grid
    pos = np.empty((3, seq), np.int32)
    cells = np.arange(n)
    pos[0, :n], pos[1, :n], pos[2, :n] = 0, cells // grid, cells % grid
    pos[:, n:] = grid + np.arange(seq - n)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, batch, seq)))


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jreg.smoke_config(ARCH).replace(remat="none")
    cfg = registry.smoke_config(ARCH)
    jparams = jax.device_get(jlm.init_params(jax.random.key(1), jcfg))
    rs = np.random.default_rng(3)
    batch = {"embeds": (rs.normal(size=(B, S, cfg.d_model)) * 0.02).astype(np.float32),
             "positions": grid_positions(B, S, GRID),
             "labels": rs.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    return jcfg, cfg, jparams, batch


def _port():
    _, cfg, jparams, _ = _setup()
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
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dh,sizes,theta", [(8, [2, 1, 1], 1e4), (128, [32, 16, 16], 1e6)])
def test_apply_mrope_matches_jax_with_three_distinct_streams(dh, sizes, theta):
    """The port's rotation equals JAX's at the grid layout (rtol/atol 1e-5:
    cos and sin of the same float32 angles from two libraries), with JAX's
    2:1:1 sections (32/16/16 at qwen2-vl's d_head 128 and theta 1e6); and
    the sections matter: the t stream alone (plain RoPE) gives another
    rotation."""
    assert rope.mrope_sections(dh) == sizes
    x = np.random.default_rng(dh).normal(size=(B, S, 3, dh)).astype(np.float32)
    pos = grid_positions(B, S, GRID)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = rope.apply_mrope(torch.tensor(x), torch.tensor(pos), theta)
    _close(got, want)
    plain = rope.apply_rope(torch.tensor(x), torch.tensor(pos[0]), theta)
    assert (got - plain).abs().max() > 1e-3  # float32 noise is ~1e-6
    # equal streams: plain RoPE
    text = np.broadcast_to(pos[2][None], pos.shape)
    _close(rope.apply_mrope(torch.tensor(x), torch.tensor(text), theta),
           rope.apply_rope(torch.tensor(x), torch.tensor(pos[2]), theta))


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------


def test_params_from_jax_and_the_config():
    jcfg, cfg, jparams, _ = _setup()
    params = _port()
    assert lm.num_params(params) == jlm.num_params(jparams)
    assert len(params["layers"]) == cfg.n_layers and "encoder" not in params
    assert lm.attn_cfg(cfg, lm.layer_kinds(cfg)[0]).rope == "mrope"
    lm.check_decoder(registry.get_config(ARCH))


def test_forward_from_embeds_and_grid_positions_matches_jax():
    jcfg, cfg, jparams, batch = _setup()
    jlogits, _ = jlm.forward(jparams, _jb(batch), JCtx(), jcfg)
    jloss, _ = jlm.lm_loss(jparams, _jb(batch), JCtx(), jcfg)
    params = _port()
    logits = lm.forward(params, _tb(batch), Ctx(), cfg)
    loss, _ = lm.lm_loss(params, _tb(batch), Ctx(), cfg)
    _close(logits, jlogits)
    assert float(loss) == pytest.approx(float(jloss), rel=RTOL, abs=ATOL)
    # the positions reach the model: text positions give other logits
    text = dict(batch)
    del text["positions"]
    assert (lm.forward(params, _tb(text), Ctx(), cfg) - logits).abs().max() > 1e-4


def test_exact_gradients_match_jax():
    """Every leaf's gradient against ``jax.grad`` of ``lm_loss`` (1e-5)."""
    jcfg, cfg, jparams, batch = _setup()
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, _jb(batch), JCtx(), jcfg)[0]))(jparams)
    params = _port()
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = lm.lm_loss(params, _tb(batch), Ctx(), cfg)
    # the embedding table is unused from embeds: zeros, as JAX's gradient
    g = [torch.zeros_like(p) if d is None else d
         for d, p in zip(torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    assert not g[0].any() and g[0].shape == params["embed"].shape
    assert float(loss) == pytest.approx(float(jloss), rel=RTOL, abs=ATOL)
    want = tree_leaves(params_from_jax(jax.device_get(jg), cfg, device="cpu"))
    assert len(g) == len(want)
    for a, b in zip(g, want):
        _close(a, b.numpy())


def test_prefill_and_decode_from_embeds_match_jax():
    """Each package's Runtime prefills the grid prompt and decodes 3 steps of
    embeds [B, 1, d]: the same logits and caches (through
    ``caches_from_jax``)."""
    jcfg, cfg, jparams, batch = _setup()
    params = _port()
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    steps = (np.random.default_rng(8).normal(size=(3, B, 1, cfg.d_model)) * 0.02
             ).astype(np.float32)
    max_len = S + 4
    jrt, rt = JRuntime(), Runtime(device="cpu")
    jlogits, jcaches = jrt.prefill_step(jcfg, max_len)(jparams, _jb(prompt))
    logits, caches = rt.prefill_step(cfg, max_len)(params, prompt)
    _close(logits, jlogits)
    jdecode, decode = jrt.decode_step(jcfg), rt.decode_step(cfg)
    for i, e in enumerate(steps):
        jlg, jcaches = jdecode(jparams, jcaches, jnp.asarray(e), S + i)
        lg, caches = decode(params, caches, e, S + i)
        _close(lg, jlg)
    for c, w in zip(caches, caches_from_jax(jax.device_get(jcaches), cfg, device="cpu")):
        _close(c["k"], w["k"].numpy())
        _close(c["v"], w["v"].numpy())


def test_prefill_then_decode_equals_the_forward_at_text_positions():
    """JAX's consistency rule (3e-5 of the logits): with text positions (the
    three streams equal to the index) prefill over S - 1 embeds plus one
    decode step gives the full forward's last logits."""
    _, cfg, _, batch = _setup()
    params = _port()
    emb = torch.tensor(batch["embeds"])
    full = lm.forward(params, {"embeds": emb}, Ctx(), cfg)
    _, caches = lm.prefill(params, {"embeds": emb[:, :-1]}, Ctx(), cfg, S + 2)
    last, _ = lm.decode_step(params, caches, emb[:, -1:], S - 1, Ctx(), cfg)
    _close(last[:, 0], full[:, -1].detach(), CONSISTENCY_TOL)


def test_decode_after_an_image_grid_departs_from_the_forward_as_in_jax():
    """ROADMAP Queue 3 item 11, a behaviour of the reference that the port
    keeps: ``decode_step`` rotates the new token by its cache index in all
    three streams, while Qwen2-VL's layout gives text after a g x g grid
    the position g + i. Prefill over the grid prompt plus one decode step
    so departs from the forward over the whole sequence (whose last token
    sits at g + (S - g*g), the text layout) by the same gap in both
    packages (gap equal within 1e-5, and larger than 1e-3 of the largest
    logit)."""
    jcfg, cfg, jparams, batch = _setup()
    params = _port()
    emb, pos = batch["embeds"], grid_positions(B, S + 1, GRID)
    nxt = (np.random.default_rng(9).normal(size=(B, 1, cfg.d_model)) * 0.02).astype(np.float32)
    whole = {"embeds": np.concatenate([emb, nxt], axis=1), "positions": pos}

    def gap(full, last):
        full, last = np.asarray(full), np.asarray(last)
        return np.abs(last[:, 0] - full[:, -1]).max() / np.abs(full[:, -1]).max()

    jfull, _ = jlm.forward(jparams, _jb(whole), JCtx(), jcfg)
    _, jc = jlm.prefill(jparams, _jb({"embeds": emb, "positions": pos[:, :, :S]}), JCtx(),
                        jcfg, S + 2)
    jlast, _ = jlm.decode_step(jparams, jc, jnp.asarray(nxt), S, JCtx(), jcfg)
    full = lm.forward(params, _tb(whole), Ctx(), cfg).detach()
    _, c = lm.prefill(params, _tb({"embeds": emb, "positions": pos[:, :, :S]}), Ctx(), cfg,
                      S + 2)
    last, _ = lm.decode_step(params, c, torch.tensor(nxt), S, Ctx(), cfg)
    jgap, tgap = gap(jfull, jlast), gap(full, last)
    assert jgap > 1e-3 and tgap > 1e-3, (jgap, tgap)
    assert tgap == pytest.approx(jgap, abs=1e-5)


# ---------------------------------------------------------------------------
# the callers: slots, probes, accumulation
# ---------------------------------------------------------------------------


def _slot_paths(tree, slot, path=()):
    """(path, stacked layers) of every dict in ``tree`` that holds ``slot``."""
    out = []
    if isinstance(tree, dict):
        if slot in tree:
            w = tree["w"]
            out.append(("/".join(map(str, path)), w.shape[0] if w.ndim == 3 else 1))
        for k, v in tree.items():
            if k != slot:
                out += _slot_paths(v, slot, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += _slot_paths(v, slot, path + (i,))
    return out


def same_slot_paths(jparams, params, cfg, jcfg):
    """The gslot, sslot and pslot builders put their slots at JAX's paths,
    once per layer of JAX's stacks. Returns the JAX paths of each slot."""
    seen = {}
    jtree = jax.tree.map(jnp.asarray, jparams)
    layer_paths = lm.jax_layer_paths(cfg)
    encoder_paths = lm.jax_layer_paths(cfg, encoder=True)
    for slot, backend, jbuild, build in (
            ("gslot", "pallas", jcgrad.with_grad_slots, cgrad.with_grad_slots),
            ("sslot", "stale", jpstate.with_plan_state, pstate.with_plan_state),
            ("pslot", "pallas", jprobes.with_probe_slots, probes.with_probe_slots)):
        jgot = _slot_paths(jbuild(jtree, _policy("jax", 0.5, backend, 16),
                                  n_layers=jcfg.n_layers), slot)
        got = _slot_paths(build(params, _policy("torch", 0.5, backend, 16),
                                n_layers=cfg.n_layers), slot)
        assert jgot, slot
        keys = [probes.site_key(p, layer_paths, encoder_paths) for p, _ in got]
        assert sorted(set(keys)) == sorted(p for p, _ in jgot), slot
        assert len(keys) == sum(n for _, n in jgot), slot
        seen[slot] = sorted(p for p, _ in jgot)
    return seen


def test_slot_builders_put_slots_where_jax_does():
    jcfg, cfg, jparams, _ = _setup()
    seen = same_slot_paths(jparams, _port(), cfg, jcfg)
    assert {p.rsplit("/", 1)[0] for p in seen["pslot"]} == {"segments/0/0/attn",
                                                            "segments/0/0/mlp"}


def test_accum_two_step_splits_positions_like_jax():
    """An accum-2 step of the smoke config at budget 0.999 (pallas, SGD)
    against JAX's: both split the [3, B, S] positions on axis 1 and every
    other entry on axis 0; loss, grad norm and every updated parameter
    agree."""
    jcfg, cfg, jparams, batch = _setup()
    micro = _split_batch(_tb(batch), 2)
    assert [tuple(m["positions"].shape) for m in micro] == [(3, 1, S)] * 2
    assert [tuple(m["embeds"].shape) for m in micro] == [(1, S, cfg.d_model)] * 2
    assert torch.equal(micro[1]["positions"][:, 0], torch.tensor(batch["positions"][:, 1]))
    jopt = jsgd(0.5)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, _policy("jax", 0.999),
                                     execution=JExecutionConfig(accum=2)))
    jstate = JTrainState(params=jparams, opt_state=jopt.init(jparams),
                         step=jnp.zeros((), jnp.int32))
    jstate, jm = jstep(jstate, _jb(batch), jax.random.key(1))
    runtime = Runtime(policy=_policy("torch", 0.999), execution=ExecutionConfig(accum=2),
                      device="cpu")
    opt = sgd(0.5)
    state = runtime.init_state(0, cfg, opt, params=_port())
    state, m = runtime.train_step(cfg, opt)(state, batch, 1)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL, abs=ATOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    want = tree_leaves(params_from_jax(jax.device_get(jstate.params), cfg, device="cpu"))
    for a, b in zip(tree_leaves(state.params), want):
        _close(a, b.numpy())
