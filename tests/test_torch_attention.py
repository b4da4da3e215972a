"""The port's chunked attention core against JAX's, on the CPU.

``nn/attention.py``'s ``impl="chunked"`` is JAX's double-chunked online
softmax: the same tiles, masks and merge order, each query chunk recomputed
in the backward. Held here against JAX's chunked ``multi_head_attention``
(values, and gradients against ``jax.grad`` of it) on the same numpy inputs
at 1e-5: every case of JAX's ``test_chunked_matches_reference`` (GQA,
window, ragged, bidirectional, cross-attention shapes), a query offset, and
segment ids on the full and the window paths. Then what the algorithm is
for: no tensor the backward keeps is larger than one tile's scores, the
full path's FLOPs equal the einsum's, the window path's are ``(window +
Cq) / Skv`` of them, and the core recomputes under the layer remat bit for
bit. One intra-op thread: the comparisons are at float32 rounding.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.nn import attention as jattn
from repro_torch.nn import attention

torch.set_num_threads(1)

TOL = 1e-5
CHUNK = 16  # q_chunk and kv_chunk of JAX's test

# JAX's test_chunked_matches_reference parametrisation, and a query offset
CASES = [
    (2, 64, 64, 8, 2, 32, True, None, 0),
    (1, 96, 96, 4, 1, 16, True, 24, 0),
    (2, 50, 50, 4, 4, 16, True, None, 0),     # ragged vs chunks
    (1, 64, 64, 6, 3, 16, False, None, 0),    # bidirectional
    (1, 33, 77, 4, 2, 16, False, None, 0),    # cross-attention shapes
    (1, 40, 72, 4, 2, 16, True, 20, 32),      # causal queries at an offset
]


def _inputs(B, Sq, Skv, H, Kv, dh, seed=0):
    r = np.random.default_rng(seed)
    shapes = ((B, Sq, H, dh), (B, Skv, Kv, dh), (B, Skv, Kv, dh), (B, Sq, H, dh))
    return [r.normal(size=s).astype(np.float32) for s in shapes]


def _cfgs(H, Kv, dh, causal, window, impl="chunked"):
    kw = dict(n_heads=H, n_kv=Kv, d_head=dh, causal=causal, window=window, q_chunk=CHUNK,
              kv_chunk=CHUNK, impl=impl)
    return jattn.AttnCfg(**kw), attention.AttnCfg(**kw)


def _jax_value_and_grads(q, k, v, ct, jcfg, **kw):
    def f(q, k, v):
        return jnp.sum(jattn.multi_head_attention(q, k, v, jcfg, **kw) * ct)

    args = tuple(map(jnp.asarray, (q, k, v)))
    out = jattn.multi_head_attention(*args, jcfg, **kw)
    return np.asarray(out), [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _port_value_and_grads(q, k, v, ct, cfg, **kw):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attention.multi_head_attention(tq, tk, tv, cfg, **kw)
    (out * torch.tensor(ct)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    for g, w, name in zip(got[1], want[1], "qkv"):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("B,Sq,Skv,H,Kv,dh,causal,window,q_offset", CASES)
def test_chunked_matches_jax(B, Sq, Skv, H, Kv, dh, causal, window, q_offset):
    """Values and q/k/v gradients against JAX's chunked impl."""
    q, k, v, ct = _inputs(B, Sq, Skv, H, Kv, dh, seed=B * Sq + H)
    jcfg, cfg = _cfgs(H, Kv, dh, causal, window)
    kw = {"q_offset": q_offset} if q_offset else {}
    _close(_port_value_and_grads(q, k, v, ct, cfg, **kw),
           _jax_value_and_grads(q, k, v, ct, jcfg, **kw))


@pytest.mark.parametrize("window", [None, 6])
def test_chunked_segments_match_jax(window):
    """Per-row segment ids (two packed prompts per row, one row padded) on
    the full path and on the window path (32 keys outrun window + Cq), every
    row, values and gradients. The ``pallas`` impl with segments takes the
    same path."""
    segs = np.zeros((2, 32), np.int32)
    segs[0, :12], segs[0, 12:26] = 1, 2
    segs[1, :19], segs[1, 19:] = 1, 2
    q, k, v, ct = _inputs(2, 32, 32, 4, 2, 16, seed=5)
    jcfg, cfg = _cfgs(4, 2, 16, True, window)
    jcfg, cfg = (dataclasses.replace(c, q_chunk=8, kv_chunk=8) for c in (jcfg, cfg))
    want = _jax_value_and_grads(q, k, v, ct, jcfg, segs=jnp.asarray(segs))
    _close(_port_value_and_grads(q, k, v, ct, cfg, segs=torch.tensor(segs)), want)
    flash_cfg = dataclasses.replace(cfg, impl="pallas")
    _close(_port_value_and_grads(q, k, v, ct, flash_cfg, segs=torch.tensor(segs)), want)


def _saved_numels(cfg, q, k, v):
    """The element count of every tensor autograd keeps for the backward of
    one forward, and of every tensor a backward saves in turn."""
    seen = []

    def pack(t):
        seen.append(t.numel())
        return t

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        attention.multi_head_attention(tq, tk, tv, cfg).sum().backward()
    return seen


def test_chunked_backward_keeps_no_score_matrix():
    """No tensor kept for the chunked backward is larger than one tile's
    scores ``[B, H, Cq, ck]`` (each query chunk keeps its inputs; its tiles
    are recomputed), where the einsum impl keeps the whole ``[B, H, Sq,
    Skv]``."""
    B, S, H, Kv, dh, C = 1, 64, 4, 2, 16, 32
    q, k, v, _ = _inputs(B, S, S, H, Kv, dh, seed=3)
    tile, whole = B * H * C * C, B * H * S * S
    kw = dict(n_heads=H, n_kv=Kv, d_head=dh, q_chunk=C, kv_chunk=C)
    chunked = _saved_numels(attention.AttnCfg(**kw), q, k, v)
    einsum = _saved_numels(attention.AttnCfg(**kw, impl="einsum"), q, k, v)
    assert chunked and max(chunked) <= tile
    assert max(einsum) == whole


def _flops(cfg, q, k, v) -> int:
    with FlopCounterMode(display=False) as fc:
        attention.multi_head_attention(*map(torch.tensor, (q, k, v)), cfg)
    return fc.get_total_flops()


def test_full_path_flops_equal_einsum():
    """The full path computes every tile, masked ones included: its FLOPs
    (``FlopCounterMode``) equal the einsum's, 4 B H Sq Skv dh."""
    B, S, H, Kv, dh = 2, 64, 4, 2, 16
    q, k, v, _ = _inputs(B, S, S, H, Kv, dh)
    _, cfg = _cfgs(H, Kv, dh, True, None)
    want = 4 * B * H * S * S * dh
    assert _flops(cfg, q, k, v) == want
    assert _flops(dataclasses.replace(cfg, impl="einsum"), q, k, v) == want


def test_window_path_flops_are_window_plus_chunk_over_keys():
    """A causal window layer whose keys outrun window + Cq slices window +
    Cq keys per query chunk: (window + Cq) / Skv of the einsum's FLOPs."""
    B, S, H, Kv, dh, W = 1, 128, 4, 1, 16, 16
    q, k, v, _ = _inputs(B, S, S, H, Kv, dh)
    _, cfg = _cfgs(H, Kv, dh, True, W)
    einsum = _flops(dataclasses.replace(cfg, impl="einsum"), q, k, v)
    assert _flops(cfg, q, k, v) * S == einsum * (W + CHUNK)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_chunked_under_layer_remat_is_bit_for_bit(remat):
    """The chunk checkpoints nested in the layer remat: a smoke config's
    loss and every gradient under remat ``full`` and ``dots`` equal remat
    ``none`` bit for bit, with several query chunks per layer."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import lm
    from repro_torch.nn.common import Ctx
    from repro_torch.tree import tree_leaves, tree_map

    cfg = smoke_config("gemma3_1b")
    params = lm.init_params(0, cfg, device="cpu")
    r = np.random.default_rng(0)
    toks = torch.tensor(r.integers(0, cfg.vocab, size=(2, 4 * cfg.q_chunk + 5)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    assert cfg.attn_impl == "chunked" and batch["tokens"].shape[1] > 2 * cfg.q_chunk

    def grads(remat):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        loss, _ = lm.lm_loss(p, batch, Ctx(), cfg.replace(remat=remat))
        return [loss] + list(torch.autograd.grad(loss, tree_leaves(p)))

    for a, b in zip(grads(remat), grads("none")):
        assert torch.equal(a, b)
