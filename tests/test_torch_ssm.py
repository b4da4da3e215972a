"""The SSM (rwkv6-3b) and hybrid (zamba2-7b) families on the CPU against JAX.

``nn/ssm.py``'s functions take the same numpy inputs and JAX's own
parameters in both packages; the smoke configs run through
``params_from_jax`` (JAX with ``remat="none"``: the same function, a
shorter compile). zamba's smoke config is cut to 5 Mamba layers with the
shared block every 2, so both of its segment kinds run and the shared block
is applied twice, at 7 layer uids.

Tolerances (float32), each stated where it is used:
* ``TOL`` 1e-5 (rtol and atol) for one block or scan (``_causal_conv``, the
  RWKV mixers, ``_ssd``, a Mamba block): both packages sum the same terms
  in other orders;
* ``DEEP_TOL`` 5e-5 for the zamba model's logits, loss and gradients: JAX
  takes each decay exp(la_i - la_j) as the difference of two cumulative
  sums (|la| ~ 35 within a chunk of 16), whose absolute rounding (~1e-6)
  becomes a relative error of the decay, compounding over 7 layers (JAX
  is 1.5e-5 from the port on logits of magnitude 3.5 at 9 layer uids);
* ``FAULT_TOL`` 3e-5 of the largest magnitude for the chunk-256 case: the
  chunked form against a step-by-step scan, with |la| up to ~540; and
  ``F64_TOL`` 1e-6 of it for the port's chunk-256 forward against a float64
  recurrence (JAX's loses digits there: 5e-6 to 1.5e-5).
Bits are compared on one torch intra-op thread.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.runtime import Runtime as JRuntime
from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.nn import ssm as jssm
from repro.nn.common import Ctx as JCtx
from repro.serve.serve_step import greedy_sample as jgreedy
from repro_torch import rng
from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
from repro_torch.configs import registry
from repro_torch.core import compact_grad as cgrad
from repro_torch.core import plan_state as pstate
from repro_torch.core.policy import ROLES
from repro_torch.interop import caches_from_jax, params_from_jax
from repro_torch.models import lm
from repro_torch.nn import ssm
from repro_torch.nn.common import Ctx
from repro_torch.optim import sgd
from repro_torch.serve import greedy_sample
from repro_torch.telemetry import probes
from repro_torch.tree import tree_leaves, tree_map

TOL, DEEP_TOL, FAULT_TOL, F64_TOL = 1e-5, 5e-5, 3e-5, 1e-6
ARCHS = ("rwkv6_3b", "zamba2_7b")
CUT = {"rwkv6_3b": {}, "zamba2_7b": dict(n_layers=5, shared_attn_every=2)}
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(arch):
    return DEEP_TOL if arch == "zamba2_7b" else TOL


def _policy(budget, backend="pallas", block=128):
    return SketchPolicy(base=SketchConfig(method="l1", budget=budget, backend=backend,
                                          block=block))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = jreg.smoke_config(arch).replace(remat="none", **CUT[arch])
    cfg = registry.smoke_config(arch).replace(**CUT[arch])
    jparams = jax.device_get(jlm.init_params(jax.random.key(1), jcfg))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    return jcfg, cfg, jparams, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@functools.lru_cache(maxsize=None)
def _jax_grads(arch):
    jcfg, _, jparams, batch = _setup(arch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jbatch, JCtx(), jcfg)[0]))(jparams)
    return float(loss), jax.device_get(g)


def _port(arch):
    _, cfg, jparams, _ = _setup(arch)
    return params_from_jax(jparams, cfg, device="cpu")


def _tb(batch):
    return {k: torch.tensor(v).long() for k, v in batch.items()}


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _close_scaled(got, want, tol):
    """max |got - want| within ``tol`` of the largest |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _grads(cfg, params, batch, policy=None, key=7):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    ctx = Ctx(policy=policy, key=key if policy else None, n_layers=cfg.n_layers)
    loss, _ = lm.lm_loss(params, _tb(batch), ctx, cfg, key if policy else None)
    return float(loss.detach()), list(torch.autograd.grad(loss, leaves))


# ---------------------------------------------------------------------------
# nn/ssm.py against JAX
# ---------------------------------------------------------------------------


def _mamba_cfgs(chunk=16):
    kw = dict(d_model=32, d_state=8, head_dim=8, chunk=chunk)
    return jssm.MambaCfg(**kw), ssm.MambaCfg(**kw)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 9, 12)).astype(np.float32)
    w = r.standard_normal((4, 12)).astype(np.float32)
    st = r.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    jy, jst = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if st is None else jnp.asarray(st))
    y, new = ssm._causal_conv(_t(x), _t(w), None if st is None else _t(st))
    _close(y, jy)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jst))


@pytest.mark.parametrize("S_in", [32, 37, 8])
def test_ssd_matches_jax(S_in):
    """Whole chunks, a ragged tail (padded with inert steps) and S below the
    chunk: outputs, final state and the gradients of every input."""
    jc, c = _mamba_cfgs()
    r = np.random.default_rng(S_in)
    H, P, N = 4, 8, 8
    x = r.standard_normal((2, S_in, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(0, 0.5, (2, S_in, H)) - 2)).astype(np.float32)
    A = np.linspace(1, 16, H).astype(np.float32)
    Bm, Cm = (r.standard_normal((2, S_in, N)).astype(np.float32) for _ in range(2))
    s0 = r.standard_normal((2, H, P, N)).astype(np.float32)
    wy = r.standard_normal((2, S_in, H, P)).astype(np.float32)

    def jloss(x, dt, Bm, Cm, s0):
        y, s = jssm._ssd(x, dt, jnp.asarray(A), Bm, Cm, jc, s0, False)
        return jnp.sum(y * wy) + jnp.sum(s), (y, s)

    (_, (jy, js)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, (x, dt, Bm, Cm, s0)))
    ins = [_t(a, grad=True) for a in (x, dt, Bm, Cm, s0)]
    y, s = ssm._ssd(ins[0], ins[1], _t(A), ins[2], ins[3], c, ins[4])
    g = torch.autograd.grad((y * _t(wy)).sum() + s.sum(), ins)
    _close(y, jy)
    _close(s, js)
    for a, b in zip(g, jg):
        _close(a, b, 3 * TOL)  # dt's gradient sums every later step's decay


def _mamba_params(jc):
    jp = jax.device_get(jssm.mamba_init(jax.random.key(0), jc))
    return jp, tree_map(lambda a: _t(a), jp)


def test_mamba_block_and_decode_match_jax():
    """The block over a ragged sequence (20 steps, chunk 16), then three
    decode steps from its prefill state, and the block's gradients."""
    jc, c = _mamba_cfgs()
    jp, p = _mamba_params(jc)
    x = np.random.default_rng(1).standard_normal((2, 23, 32)).astype(np.float32)
    jy = jssm.mamba_block(jp, jnp.asarray(x[:, :20]), JCtx(), jc)
    y, state = ssm.mamba_prefill(p, _t(x[:, :20]), Ctx(), c)
    _close(y, jy)
    _close(ssm.mamba_block(p, _t(x[:, :20]), Ctx(), c), jy)
    jstate = jssm.mamba_state_init(2, jc, jnp.float32)
    for t in range(20):  # JAX's decode from zeros reaches the same state
        _, jstate = jssm.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), JCtx(), jc, jstate)
    _close(state["ssm"], jstate["ssm"])
    _close(state["conv"], jstate["conv"])
    for t in range(20, 23):
        jo, jstate = jssm.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), JCtx(), jc, jstate)
        o, state = ssm.mamba_decode(p, _t(x[:, t:t + 1]), Ctx(), c, state)
        _close(o, jo)
        _close(state["ssm"], jstate["ssm"])
        _close(state["conv"], jstate["conv"])
    jg = jax.grad(lambda q: jnp.sum(jssm.mamba_block(q, jnp.asarray(x), JCtx(), jc) ** 2))(jp)
    leaves = tree_leaves(p)
    for q in leaves:
        q.requires_grad_(True)
    g = torch.autograd.grad((ssm.mamba_block(p, _t(x), Ctx(), c) ** 2).sum(), leaves)
    for a, b in zip(g, tree_leaves(tree_map(np.asarray, jax.device_get(jg)))):
        _close(a, b, 3 * TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_mixers_match_jax(with_state):
    """Time mix over a ragged sequence (19 steps, chunk 8: inert padding),
    channel mix, with and without carried state; the new states and every
    parameter's gradient."""
    kw = dict(d_model=32, head_dim=8, d_ff=48, chunk=8, decay_lora=8)
    jc, c = jssm.RWKVCfg(**kw), ssm.RWKVCfg(**kw)
    jp = jax.device_get(jssm.rwkv_init(jax.random.key(2), jc))
    p = tree_map(lambda a: _t(a), jp)
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 19, 32)).astype(np.float32)
    st = None
    if with_state:
        st = {"wkv": r.standard_normal((2, 4, 8, 8)).astype(np.float32),
              "shift": r.standard_normal((2, 1, 32)).astype(np.float32)}

    def jrun(q):
        js = None if st is None else {k: jnp.asarray(v) for k, v in st.items()}
        y, new = jssm.rwkv_time_mix(q, jnp.asarray(x), JCtx(), jc, js)
        y2, cm = jssm.rwkv_channel_mix(q, y, JCtx(), jc, None if st is None else js["shift"])
        return jnp.sum(y2 ** 2) + jnp.sum(new["wkv"]), (y, y2, new, cm)

    (_, (jy, jy2, jnew, jcm)), jg = jax.value_and_grad(jrun, has_aux=True)(jp)
    leaves = tree_leaves(p)
    for q in leaves:
        q.requires_grad_(True)
    ts = None if st is None else {k: _t(v) for k, v in st.items()}
    y, new = ssm.rwkv_time_mix(p, _t(x), Ctx(), c, ts)
    y2, cm = ssm.rwkv_channel_mix(p, y, Ctx(), c, None if ts is None else ts["shift"])
    g = torch.autograd.grad((y2 ** 2).sum() + new["wkv"].sum(), leaves)
    _close(y, jy)
    _close(y2, jy2)
    _close(new["wkv"], jnew["wkv"])
    np.testing.assert_array_equal(new["shift"].detach().numpy(), np.asarray(jnew["shift"]))
    _close(cm, jcm)  # the last token of y
    for a, b in zip(g, tree_leaves(tree_map(np.asarray, jax.device_get(jg)))):
        _close(a, b, 3 * TOL)


# ---------------------------------------------------------------------------
# the SSD chunk's NaN gradient (Queue 3 item 8)
# ---------------------------------------------------------------------------


def test_ssd_chunk_256_gradient_is_finite_where_jax_gives_nan():
    """At the full configs' chunk of 256, with dt = softplus(N(0, 0.02) - 2)
    (``mamba_init``'s dt_bias) and A = linspace(1, 16): JAX's dt gradient
    has non-finite entries (exp overflows above the diagonal before its
    where() masks it: 0 * inf in the backward). The port's forward equals
    JAX's, and its gradients are finite and equal a step-by-step lax.scan
    of mamba_decode's one-step update, within FAULT_TOL."""
    jc, c = _mamba_cfgs(chunk=256)
    r = np.random.default_rng(0)
    Bsz, S_, H, P, N = 1, 256, 8, 4, 8
    x = r.standard_normal((Bsz, S_, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(0, 0.02, (Bsz, S_, H)) - 2)).astype(np.float32)
    A = np.linspace(1, 16, H).astype(np.float32)
    Bm, Cm = (r.standard_normal((Bsz, S_, N)).astype(np.float32) for _ in range(2))
    wy = r.standard_normal((Bsz, S_, H, P)).astype(np.float32)
    s0 = jnp.zeros((Bsz, H, P, N))

    def jax_chunked(x, dt, Bm, Cm):
        y, _ = jssm._ssd(x, dt, jnp.asarray(A), Bm, Cm, jc, s0, False)
        return jnp.sum(y * wy), y

    def jax_scan(x, dt, Bm, Cm):
        def step(s, inp):  # mamba_decode's update, one token
            xt, dtt, bt, ct = inp
            dA = jnp.exp(-jnp.asarray(A)[None, :] * dtt)
            s = s * dA[..., None, None] + jnp.einsum("bh,bhp,bn->bhpn", dtt, xt, bt)
            return s, jnp.einsum("bhpn,bn->bhp", s, ct)

        _, ys = jax.lax.scan(step, s0, tuple(jnp.moveaxis(t, 1, 0) for t in (x, dt, Bm, Cm)))
        y = jnp.moveaxis(ys, 0, 1)
        return jnp.sum(y * wy), y

    args = tuple(map(jnp.asarray, (x, dt, Bm, Cm)))
    (_, jy), jg = jax.value_and_grad(jax_chunked, argnums=(0, 1, 2, 3), has_aux=True)(*args)
    assert np.isfinite(np.asarray(jy)).all()
    assert np.isfinite(np.asarray(jg[0])).all()
    assert (~np.isfinite(np.asarray(jg[1]))).sum() > 0  # the reference's fault
    (_, ry), rg = jax.value_and_grad(jax_scan, argnums=(0, 1, 2, 3), has_aux=True)(*args)
    ins = [_t(a, grad=True) for a in (x, dt, Bm, Cm)]
    y, _ = ssm._ssd(ins[0], ins[1], _t(A), ins[2], ins[3], c, torch.zeros(Bsz, H, P, N))
    g = torch.autograd.grad((y * _t(wy)).sum(), ins)
    _close_scaled(y, jy, FAULT_TOL)
    _close_scaled(y, ry, FAULT_TOL)
    for a, b in zip(g, rg):
        assert torch.isfinite(a).all()
        _close_scaled(a, b, FAULT_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssd_chunk_256_forward_keeps_float32_accuracy(seed):
    """The other half of Queue 3 item 8: JAX takes each intra-chunk decay as
    exp(la_i - la_j), the difference of two cumulative sums that reach |la|
    in the hundreds at a chunk of 256, so near the diagonal it keeps only
    eps·|la| of absolute accuracy. The port sums each segment on its own:
    its output is within F64_TOL of a float64 recurrence, JAX's is not."""
    jc, c = _mamba_cfgs(chunk=256)
    r = np.random.default_rng(seed)
    Bsz, S_, H, P, N = 1, 256, 8, 4, 8
    x = r.standard_normal((Bsz, S_, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(0, 1, (Bsz, S_, H)) - 1)).astype(np.float32)
    A = np.linspace(1, 16, H).astype(np.float32)
    Bm, Cm = (r.standard_normal((Bsz, S_, N)).astype(np.float32) for _ in range(2))
    s, ys = np.zeros((Bsz, H, P, N)), []
    for t in range(S_):  # mamba_decode's update in float64
        d64 = dt[:, t].astype(np.float64)
        s = s * np.exp(-A.astype(np.float64)[None] * d64)[..., None, None] + np.einsum(
            "bh,bhp,bn->bhpn", d64, x[:, t].astype(np.float64), Bm[:, t].astype(np.float64))
        ys.append(np.einsum("bhpn,bn->bhp", s, Cm[:, t].astype(np.float64)))
    ref = np.stack(ys, axis=1)
    y, _ = ssm._ssd(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), c, torch.zeros(Bsz, H, P, N))
    jy, _ = jssm._ssd(*map(jnp.asarray, (x, dt, A, Bm, Cm)), jc, jnp.zeros((Bsz, H, P, N)), False)
    scale = np.abs(ref).max()
    assert np.abs(y.numpy() - ref).max() <= F64_TOL * scale
    assert np.abs(np.asarray(jy) - ref).max() > 2 * F64_TOL * scale  # the reference's loss


# ---------------------------------------------------------------------------
# the models against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_and_the_layer_plan(arch):
    """One dict per layer uid (an empty one for a shared application), the
    shared block once, the parameter counts as JAX's, the JAX paths the
    probes and the train step read."""
    jcfg, cfg, jparams, _ = _setup(arch)
    params = _port(arch)
    assert lm.num_params(params) == jlm.num_params(jparams)
    assert lm.active_params_per_token(params, cfg) == jlm.active_params_per_token(jparams, jcfg)
    kinds = [k.kind for k in lm.layer_kinds(cfg)]
    paths = lm.jax_layer_paths(cfg)
    assert len(params["layers"]) == len(kinds) == len(paths)
    if arch == "rwkv6_3b":
        assert kinds == ["rwkv"] * cfg.n_layers and "shared" not in params
        assert paths == ["segments/0/0"] * cfg.n_layers
    else:
        assert kinds == ["mamba", "mamba", "shared_attn"] * 2 + ["mamba"]
        assert paths == ["segments/0/0", "segments/0/1", "shared"] * 2 + ["segments/1/0"]
        assert set(params["shared"]) == {"norm1", "attn", "norm2", "mlp"}
        np.testing.assert_array_equal(params["shared"]["attn"]["q"]["w"].numpy(),
                                      np.asarray(jparams["shared"]["attn"]["q"]["w"]))
    for uid, (kind, layer) in enumerate(zip(kinds, params["layers"])):
        if kind == "shared_attn":
            assert layer == {}
            continue
        sub = "rwkv" if kind == "rwkv" else "mamba"
        _, si, i = paths[uid].split("/")
        rep = paths[:uid].count(paths[uid])
        jsub = tree_map(lambda a: np.asarray(a)[rep], jparams["segments"][int(si)][int(i)][sub])
        for got, want in zip(tree_leaves(layer[sub]), tree_leaves(jsub), strict=True):
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_jax(arch):
    jcfg, cfg, jparams, batch = _setup(arch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, _ = jlm.forward(jparams, jbatch, JCtx(), jcfg)
    jloss, _ = jlm.lm_loss(jparams, jbatch, JCtx(), jcfg)
    params = _port(arch)
    logits, aux = lm.forward_with_aux(params, _tb(batch), Ctx(), cfg)
    loss, m = lm.lm_loss(params, _tb(batch), Ctx(), cfg)
    _close(logits, jlogits, _tol(arch))
    assert float(loss) == pytest.approx(float(jloss), rel=_tol(arch))
    assert float(aux) == 0.0 and float(m["nll"]) == float(loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_gradients_match_jax(arch):
    """Every leaf's exact gradient; zamba's shared block gets the sum over
    its applications in both packages."""
    _, cfg, _, batch = _setup(arch)
    jloss, jg = _jax_grads(arch)
    loss, g = _grads(cfg, _port(arch), batch)
    assert loss == pytest.approx(jloss, rel=_tol(arch))
    want = tree_leaves(params_from_jax(jg, cfg, device="cpu"))
    assert len(g) == len(want)
    for a, b in zip(g, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        _close(a, b.numpy(), _tol(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["pallas", "onepass", "stale"])
def test_budget_0999_equals_exact(arch, backend):
    """Every block kept with scale 1 (sites narrower than a block per column,
    r = n): the sketched gradients are exact backprop's, the loss the same."""
    _, cfg, _, batch = _setup(arch)
    params = _port(arch)
    loss, g = _grads(cfg, params, batch)
    loss_s, g_s = _grads(cfg, params, batch, _policy(0.999, backend))
    assert loss_s == loss
    for a, b in zip(g_s, g):
        _close(a, b.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Each package's Runtime prefills two 20-token prompts (ragged against
    the smoke chunk of 16) and decodes 4 greedy tokens: the same logits,
    caches (recurrent states and K/V, through ``caches_from_jax``) and
    tokens."""
    jcfg, cfg, jparams, _ = _setup(arch)
    tol = _tol(arch)
    params = _port(arch)
    P, steps = 20, 4
    max_len = P + steps + 2
    toks = np.random.default_rng(11).integers(1, cfg.vocab, size=(2, P)).astype(np.int32)
    jrt, rt = JRuntime(), Runtime(device="cpu")
    jlogits, jcaches = jrt.prefill_step(jcfg, max_len)(jparams, {"tokens": jnp.asarray(toks)})
    logits, caches = rt.prefill_step(cfg, max_len)(params, {"tokens": toks})
    _close(logits, jlogits, tol)

    def same_caches():
        want = caches_from_jax(jax.device_get(jcaches), cfg, device="cpu")
        assert len(want) == len(caches)
        for c, w in zip(caches, want):
            assert set(c) == set(w)
            for k in c:
                _close(c[k], w[k].numpy(), tol)

    same_caches()
    jdecode, decode = jrt.decode_step(jcfg), rt.decode_step(cfg)
    jcur, cur = jgreedy(jlogits[:, -1:]), greedy_sample(logits[:, -1:])
    for i in range(steps):
        assert np.array_equal(cur.numpy(), np.asarray(jcur)), f"step {i}"
        jlg, jcaches = jdecode(jparams, jcaches, jcur, P + i)
        lg, caches = decode(params, caches, cur, P + i)
        _close(lg, jlg, tol)
        jcur, cur = jgreedy(jlg), greedy_sample(lg)
    assert np.array_equal(cur.numpy(), np.asarray(jcur))
    same_caches()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_the_forward(arch):
    """JAX's test_prefill_decode_consistency rule in the port: prefill over
    all but the last token, one decode step, against the full forward's last
    logits (relative to their largest)."""
    _, cfg, _, batch = _setup(arch)
    params = _port(arch)
    toks = torch.tensor(batch["tokens"]).long()
    full = lm.forward(params, {"tokens": toks}, Ctx(), cfg)
    _, caches = lm.prefill(params, {"tokens": toks[:, :-1]}, Ctx(), cfg, S + 6)
    lg, _ = lm.decode_step(params, caches, toks[:, -1:], S - 1, Ctx(), cfg)
    err = (lg[:, 0] - full[:, -1]).abs().max() / full[:, -1].abs().max()
    assert float(err) < 3e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_layers_refuse_segments(arch):
    """JAX's SSM blocks ignore segment ids, so packed prompts would share
    state and pads would enter it: the port raises for a packed or a padded
    row. A row that is one segment without padding (an exact-length engine
    wave) runs, and gives the logits of the same batch without segments
    exactly (the masks of one whole segment are the causal mask)."""
    _, cfg, _, batch = _setup(arch)
    params, tb = _port(arch), _tb(batch)
    packed = torch.tensor([[1] * 10 + [2] * (S - 10)] * B)
    padded = torch.tensor([[1] * (S - 3) + [0] * 3] * B)
    for segs in (packed, padded):
        with pytest.raises(ValueError, match="segment"):
            lm.forward(params, dict(tb, segments=segs), Ctx(), cfg)
    one = torch.tensor([[1] * S, [2] * S])  # each row its own id
    got = lm.forward(params, dict(tb, segments=one), Ctx(), cfg)
    assert torch.equal(got, lm.forward(params, tb, Ctx(), cfg))


# ---------------------------------------------------------------------------
# the shared block, slots and seeds
# ---------------------------------------------------------------------------


def test_zamba_shared_block_actually_shared():
    """Port of JAX's test: the shared block is one weight, and the gradient
    reaches it from every application."""
    _, cfg, _, batch = _setup("zamba2_7b")
    params = lm.init_params(0, cfg, device="cpu")
    assert "shared" in params
    assert [lay for lay, k in zip(params["layers"], lm.layer_kinds(cfg))
            if k.kind == "shared_attn"] == [{}, {}]
    leaves = tree_leaves(params["shared"])
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = lm.lm_loss(params, _tb(batch), Ctx(), cfg)
    g = torch.autograd.grad(loss, leaves)
    assert sum(float(x.abs().sum()) for x in g) > 0
    # the sum over two applications: each one's own contribution is nonzero
    q = params["shared"]["attn"]["q"]["w"]
    taps = []
    real = lm._attn_layer
    monkey = pytest.MonkeyPatch()
    monkey.setattr(lm, "_attn_layer", lambda p, *a: (taps.append(p["attn"]["q"]["w"]),
                                                     real(p, *a))[1])
    try:
        lm.lm_loss(params, _tb(batch), Ctx(), cfg)
    finally:
        monkey.undo()
    assert len(taps) == 2 and all(t is q for t in taps)


def test_no_slots_for_shared_recurrent_or_location_policies():
    """Port of JAX's test_no_slots_for_shared_or_location_policies, with
    JAX's path matcher's other consequence (Queue 3 item 9): the shared
    block (a weight applied more than once per step), the Mamba and RWKV
    sites (parents ``mamba``/``rwkv``, which the matcher does not know) and
    a location policy get no gradient slot, no plan carry and no probe."""
    for arch in ARCHS:
        _, cfg, _, _ = _setup(arch)
        params = lm.init_params(0, cfg, device="cpu")
        for backend, build in (("compact", cgrad.with_grad_slots),
                               ("stale", pstate.with_plan_state),
                               ("pallas", probes.with_probe_slots)):
            for loc in ("all", "first"):
                pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.5, backend=backend,
                                                     block=16), location=loc)
                aug = build(params, pol, n_layers=cfg.n_layers)
                assert tree_map(lambda t: t.shape, aug) == tree_map(lambda t: t.shape, params)


def test_shared_arch_compact_train_step_runs_and_matches():
    """Port of JAX's test: zamba under compact_grads equals the dense-path
    step (no site of the family takes a slot)."""
    _, cfg, _, batch = _setup("zamba2_7b")
    policy = SketchPolicy(base=SketchConfig(method="l1", budget=0.5, backend="compact"))
    params = _port("zamba2_7b")
    out = []
    for compact in (False, True):
        runtime = Runtime(policy=policy, execution=ExecutionConfig(compact_grads=compact),
                          device="cpu")
        opt = sgd(0.1)
        state = runtime.init_state(0, cfg, opt, params=tree_map(torch.clone, params))
        out.append(runtime.train_step(cfg, opt)(state, batch, 2))
    (s_d, m_d), (s_c, m_c) = out
    assert float(m_d["loss"]) == pytest.approx(float(m_c["loss"]), rel=1e-6)
    for a, b in zip(tree_leaves(s_d.params), tree_leaves(s_c.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_site_seeds_follow_jax_role_folds(arch, monkeypatch):
    """One sketched step's generators: the seed of a site is step → layer
    uid → role id, so the two ``ssm_in`` sites of a Mamba layer (in_z,
    in_x), and rwkv's ``g`` and ``cm_r`` (both ``mlp_gate``), share one seed,
    as in JAX; every shared application draws under its own uid."""
    _, cfg, _, batch = _setup(arch)
    seeds = []
    real = rng.generator
    monkeypatch.setattr(rng, "generator", lambda s, d: seeds.append(s) or real(s, d))
    _grads(cfg, _port(arch), batch, _policy(0.5, "pallas", 16), key=13)

    def seed(uid, role):
        return rng.fold_in(rng.fold_in(13, uid), ROLES.index(role))

    want = []
    for uid, kind in enumerate(lm.layer_kinds(cfg)):
        if kind.kind == "rwkv":
            roles = ["attn_q", "attn_k", "attn_v", "mlp_gate", "attn_o", "mlp_in", "mlp_gate",
                     "mlp_out"]
        elif kind.kind == "mamba":
            roles = ["ssm_in", "ssm_in", "ssm_out"]
        else:
            roles = ["attn_q", "attn_k", "attn_v", "attn_o", "mlp_in", "mlp_gate", "mlp_out"]
        want += [seed(uid, r) for r in roles]
    assert seeds == want


# ---------------------------------------------------------------------------
# the decoder check
# ---------------------------------------------------------------------------


def test_check_decoder_takes_both_families_and_refuses_the_rest_by_name():
    for arch in ARCHS:
        lm.check_decoder(registry.get_config(arch))
    for change in (dict(family="diffusion"), dict(frontend="video")):
        cfg = dataclasses.replace(registry.get_config("rwkv6_3b"), **change)
        with pytest.raises(NotImplementedError, match=cfg.name):
            lm.check_decoder(cfg)
    odd = dataclasses.replace(registry.smoke_config("rwkv6_3b"), rope="xpos")
    with pytest.raises(NotImplementedError, match="xpos"):
        lm.check_decoder(odd)
    encdec = dataclasses.replace(registry.smoke_config("zamba2_7b"), enc_layers=2)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        lm.check_decoder(encdec)
