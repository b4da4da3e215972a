"""Mamba2's block split over emulated model shards of its heads, on one CPU
device, against the whole block (``nn/ssm.py``).

Under a mesh each model rank runs :func:`repro_torch.nn.ssm.mamba_heads` on
its heads (``ssm_in``'s column shard, the conv's and the norm gain's
channels, its per-head leaves), the norm over the channels with its sum of
squares summed over model, and its row shard of ``out``. Here one device
runs that per-shard body once per emulated shard and completes the sums
itself: the norm's sum of squares over the shards, the row shards' outputs,
and the shards' dX. ``chip_smoke.py`` phase 25 runs the same emulation at
zamba2-7b's full width on the card.

The block: d_model 112, 28 heads of 8 (d_inner 224), state 16, chunk 16,
batch 2 x 32, float32, split into 2 or 4 shards of the heads (7 heads,
56 channels per shard at 4: with blocks of 16 a shard holds 3.5 blocks, so
kept blocks straddle two shards, as zamba2-7b's 448-channel shards do with
blocks of 128). Two cases:

* exact sites: the shards' summed output and their dX (x's cotangent
  through every site) against the whole block's forward and backward;
* ``pallas`` l1@0.5 block 16 on ``ssm_in``/``ssm_out`` (the plain versions
  of the kernels on the CPU): the whole width's plans drawn from the shards'
  scores put together with the sites' seeds, each column shard's part of
  the ``ssm_in`` backward (``split_backward``) and each row shard's of
  ``out`` (``_kernel`` on its d_in chunk); the summed output and dX against
  the whole block's sketched backward, and each shard's compact rows bit
  for bit the whole-width kernel call's on the shards' G put together.

Tolerance: ``TOL`` 1e-5 of the largest magnitude (rtol and atol): the shards
sum the norm's squares and the out projection's products in another order
than the whole block (and a straddling block's dX product in two parts).
One torch intra-op thread.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.core import estimators
from repro_torch.core.policy import ROLES
from repro_torch.core.sketched_linear import split_backward
from repro_torch.core.sketching import SketchConfig, column_plan_from_scores
from repro_torch.core import SketchPolicy
from repro_torch.kernels import ref as kref
from repro_torch.nn import ssm
from repro_torch.nn.common import Ctx

TOL = 1e-5
CFG = ssm.MambaCfg(d_model=112, d_state=16, expand=2, head_dim=8, d_conv=4, chunk=16)
B, S = 2, 32
SEED, KEY = 0, 7
SKETCH = SketchConfig(method="l1", budget=0.5, backend="pallas", block=16)
SHARDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    gen = torch.Generator().manual_seed(SEED)
    params = ssm.mamba_init(gen, CFG)
    x = torch.randn((B, S, CFG.d_model), generator=gen)
    gout = torch.randn((B, S, CFG.d_model), generator=gen)
    return params, x, gout


def _policy():
    return SketchPolicy(base=SKETCH,
                        exclude_roles=tuple(r for r in ROLES if r not in ("ssm_in", "ssm_out")))


def whole_block(params, x, gout, sketched: bool):
    """The whole block's output and dX (one call of ``mamba_block``)."""
    ctx = Ctx(policy=_policy(), key=KEY) if sketched else Ctx()
    xg = x.clone().requires_grad_()
    out = ssm.mamba_block(params, xg, ctx, CFG)
    out.backward(gout)
    return out.detach(), xg.grad


def _plan(scores, seed):
    plan = column_plan_from_scores(SKETCH, scores, rng.generator(seed, scores.device))
    return plan.indices, plan.scales


def emulated_block(params, x, gout, n_shards: int, sketched: bool):
    """The block as ``n_shards`` model ranks run it, on one device: each
    shard's :func:`ssm.mamba_heads` and norm (the sum of squares summed over
    the shards here), its row shard of ``out``, and the backward site by
    site. Returns (output, dX, the shards' compact rows by site and the
    whole-width kernel call's, or None when exact)."""
    H, P = CFG.n_heads, CFG.head_dim
    n, c = H // n_shards, (H // n_shards) * P
    x2 = x.reshape(-1, CFG.d_model)
    small = {k: F.linear(x, params[k]["w"]).requires_grad_() for k in ("in_B", "in_C", "in_dt")}
    shards = []
    for k in range(n_shards):
        cols = slice(k * c, (k + 1) * c)
        z = F.linear(x, params["in_z"]["w"][cols]).requires_grad_()
        xs = F.linear(x, params["in_x"]["w"][cols]).requires_grad_()
        leaves = ssm.head_leaves(params, k * n, n, P)
        y, _, _ = ssm.mamba_heads(leaves, z, xs, small["in_B"], small["in_C"],
                                  small["in_dt"][..., k * n:(k + 1) * n], CFG, x.dtype)
        shards.append(dict(cols=cols, z=z, xs=xs, y=y, g=leaves["g"]))
    ss = sum(ssm.sum_squares(s["y"]) for s in shards)
    for s in shards:
        s["yn"] = ssm.shard_rmsnorm(s["y"], s["g"], ss, CFG.d_inner)
    out = sum(F.linear(s["yn"].detach(), params["out"]["w"][:, s["cols"]]) for s in shards)
    G_out = gout.reshape(-1, CFG.d_model)
    est = estimators.get_estimator(SKETCH.backend)
    ctx = Ctx(policy=_policy(), key=KEY)
    rows = {}
    # the row shards of out: every shard holds the whole G and scores it
    if sketched:
        idx, sc = _plan(kref.col_scores_ref(G_out), ctx.site_seed("ssm_out"))
    dyn = []
    for s in shards:
        w_k = params["out"]["w"][:, s["cols"]]
        if sketched:
            X_k = s["yn"].detach().reshape(-1, c)
            dx, r_k, _, _ = est._kernel(SKETCH, G_out, idx, sc, w_k, X_k)
            rows.setdefault("out", []).append(r_k)
        else:
            dx = G_out @ w_k
        dyn.append(dx.reshape(B, S, c))
    inputs = [t for s in shards for t in (s["z"], s["xs"])] + list(small.values())
    grads = torch.autograd.grad([s["yn"] for s in shards], inputs, dyn)
    dX = sum(g.reshape(-1, g.shape[-1]) @ params[k]["w"]
             for g, k in zip(grads[2 * n_shards:], small))
    for j, name in enumerate(("in_z", "in_x")):
        Gs = [grads[2 * k + j].reshape(-1, c) for k in range(n_shards)]
        if sketched:
            idx, sc = _plan(torch.cat([kref.col_scores_ref(G) for G in Gs]),
                            ctx.site_seed("ssm_in"))
        for k, (s, G_k) in enumerate(zip(shards, Gs)):
            w_k = params[name]["w"][s["cols"]]
            if sketched:
                part, _ = split_backward(est, SKETCH, G_k, x2, w_k, idx, sc, lo=k * c,
                                         n=CFG.d_inner)
                dX = dX + part.dx
                rows.setdefault(name, []).append(part.rows)
            else:
                dX = dX + G_k @ w_k
        if sketched:
            G = torch.cat(Gs, 1)
            rows[name + "/whole"] = est._kernel(SKETCH, G, idx, sc, params[name]["w"], x2)[1]
    if sketched:
        X = torch.cat([s["yn"].detach().reshape(-1, c) for s in shards], 1)
        rows["out/whole"] = est._kernel(SKETCH, G_out, *_plan(
            kref.col_scores_ref(G_out), ctx.site_seed("ssm_out")), params["out"]["w"], X)[1]
    return out.detach(), dX.reshape(B, S, CFG.d_model), rows if sketched else None


def _close(got, want, what):
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("sketched", [False, True], ids=["exact", "pallas"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_emulated_shards_forward_is_the_whole_block(n_shards, sketched):
    """The shards' out projections summed equal the whole block's output
    within ``TOL`` of its largest magnitude."""
    params, x, gout = _inputs()
    want, _ = whole_block(params, x, gout, sketched)
    got, _, _ = emulated_block(params, x, gout, n_shards, sketched)
    _close(got, want, "output")


@pytest.mark.parametrize("sketched", [False, True], ids=["exact", "pallas"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_emulated_shards_backward_is_the_whole_block(n_shards, sketched):
    """The shards' dX summed (the column shards' parts of ``ssm_in``'s
    backward, the small sites' whole products) equal the whole block's x
    gradient within ``TOL`` of its largest magnitude: the plans drawn from
    the shards' scores put together are the whole block's."""
    params, x, gout = _inputs()
    _, want = whole_block(params, x, gout, sketched)
    _, got, _ = emulated_block(params, x, gout, n_shards, sketched)
    _close(got, want, "dX")


@pytest.mark.parametrize("n_shards", SHARDS)
def test_emulated_shards_compact_rows_are_the_whole_call(n_shards):
    """Under ``pallas`` each column shard's compact rows of ``in_z`` and
    ``in_x`` are the whole-width kernel call's on the shards' G put together,
    bit for bit where the shard holds the columns and zero elsewhere; each
    row shard's rows of ``out`` are that call's d_in chunk bit for bit."""
    params, x, gout = _inputs()
    _, _, rows = emulated_block(params, x, gout, n_shards, True)
    c = CFG.d_inner // n_shards
    bs = SKETCH.block
    for name in ("in_z", "in_x"):
        whole = rows[name + "/whole"]
        total = torch.zeros_like(whole)
        for part in rows[name]:
            assert part.shape == whole.shape
            total += part
            mine = part.abs().sum(1) > 0
            assert torch.equal(part[mine], whole[mine]), name
        assert torch.equal(total, whole), name
        assert whole.shape[0] % bs == 0
    for k, part in enumerate(rows["out"]):
        assert torch.equal(part, rows["out/whole"][:, k * c:(k + 1) * c]), k
