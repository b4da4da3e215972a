"""repro_torch kernel modules on the CPU: the plain versions against the JAX
oracles (``repro/kernels/ref.py``), and the dispatcher's device rules.

The kernels themselves run only on a card: tests/test_torch_cuda.py holds
them against their plain versions there. Tolerance: float32, rtol=1e-5,
atol=1e-6 unless a test says why not.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import build, col_scores, ops, ref, sketch_matmul

RTOL, ATOL = 1e-5, 1e-6
# matmul outputs: an element that cancels to ~0 keeps the absolute rounding
# of its K-term float32 sum, ~sqrt(K) * 2^-24 * |terms| ≈ 4e-6 at K = 256
MM_ATOL = 1e-5
N, BLOCK = 96, 128


def _t(a):
    return torch.tensor(np.asarray(a))


def _problem(n=512, d=80, rb=2, seed=0):
    r = np.random.default_rng(seed)
    G = r.normal(size=(N, n)).astype(np.float32)
    W = (r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    X = r.normal(size=(N, d)).astype(np.float32)
    idx = np.sort(r.choice(n // BLOCK, size=rb, replace=False)).astype(np.int32)
    scales = r.uniform(1.0, 4.0, size=rb).astype(np.float32)
    return G, idx, scales, W, X


@pytest.mark.parametrize("mode", ["l1", "l2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_col_scores_ref_matches_jax(mode, dtype):
    G = np.random.default_rng(1).normal(size=(200, 300)).astype(np.float32)
    # both frameworks round the same float32 values to bfloat16 the same way
    # (nearest even) and accumulate in float32
    got = ref.col_scores_ref(_t(G).to(getattr(torch, dtype)), mode=mode).numpy()
    want = np.asarray(jref.col_scores_ref(jnp.asarray(G, dtype=dtype), mode=mode))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got.dtype == np.float32
    np.testing.assert_allclose(ref.col_l1_scores_ref(_t(G)).numpy(),
                               np.asarray(jref.col_l1_scores_ref(jnp.asarray(G))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_scores,score_mode", [(False, "l1"), (True, "l1"), (True, "l2")])
@pytest.mark.parametrize("n,d,rb", [(512, 80, 2), (384, 128, 3), (256, 64, 1)])
def test_block_gather_matmul_fused_ref_matches_jax(with_scores, score_mode, n, d, rb):
    G, idx, scales, W, X = _problem(n, d, rb)
    got = ref.block_gather_matmul_fused_ref(_t(G), _t(idx).long(), _t(scales), _t(W), _t(X),
                                            block=BLOCK, with_scores=with_scores,
                                            score_mode=score_mode)
    want = jref.block_gather_matmul_fused_ref(jnp.asarray(G), jnp.asarray(idx),
                                              jnp.asarray(scales), jnp.asarray(W),
                                              jnp.asarray(X), block=BLOCK,
                                              with_scores=with_scores, score_mode=score_mode)
    assert len(got) == len(want) == (4 if with_scores else 3)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=MM_ATOL)


def test_unfused_and_per_column_refs_match_jax():
    G, idx, scales, W, X = _problem()
    args_t = (_t(G), _t(idx).long(), _t(scales))
    args_j = (jnp.asarray(G), jnp.asarray(idx), jnp.asarray(scales))
    np.testing.assert_allclose(
        ref.block_gather_matmul_ref(*args_t, _t(W), block=BLOCK).numpy(),
        np.asarray(jref.block_gather_matmul_ref(*args_j, jnp.asarray(W), block=BLOCK)),
        rtol=RTOL, atol=MM_ATOL)
    np.testing.assert_allclose(
        ref.block_gather_matmul_dw_ref(*args_t, _t(X), block=BLOCK).numpy(),
        np.asarray(jref.block_gather_matmul_dw_ref(*args_j, jnp.asarray(X), block=BLOCK)),
        rtol=RTOL, atol=MM_ATOL)
    cols = np.array([3, 17, 100, 260, 511])
    cs = np.linspace(1.0, 3.0, len(cols)).astype(np.float32)
    np.testing.assert_allclose(
        ref.gather_cols_matmul_ref(_t(G), _t(cols), _t(cs), _t(W)).numpy(),
        np.asarray(jref.gather_cols_matmul_ref(jnp.asarray(G), jnp.asarray(cols),
                                               jnp.asarray(cs), jnp.asarray(W))),
        rtol=RTOL, atol=MM_ATOL)
    np.testing.assert_allclose(
        ref.gather_cols_matmul_dw_ref(_t(G), _t(cols), _t(cs), _t(X)).numpy(),
        np.asarray(jref.gather_cols_matmul_dw_ref(jnp.asarray(G), jnp.asarray(cols),
                                                  jnp.asarray(cs), jnp.asarray(X))),
        rtol=RTOL, atol=MM_ATOL)


def test_fused_ref_agrees_with_unfused_refs():
    """dX and dWc of the fused oracle equal the unfused pair; db is the
    column sum of the scaled kept blocks."""
    G, idx, scales, W, X = _problem(n=384, d=64, rb=2)
    Gt, it, st = _t(G), _t(idx).long(), _t(scales)
    dX, dWc, db = ref.block_gather_matmul_fused_ref(Gt, it, st, _t(W), _t(X), block=BLOCK)
    np.testing.assert_allclose(dX.numpy(), ref.block_gather_matmul_ref(
        Gt, it, st, _t(W), block=BLOCK).numpy(), rtol=RTOL, atol=MM_ATOL)
    np.testing.assert_allclose(dWc.numpy(), ref.block_gather_matmul_dw_ref(
        Gt, it, st, _t(X), block=BLOCK).numpy(), rtol=RTOL, atol=MM_ATOL)
    Gb = G.reshape(N, -1, BLOCK)[:, idx] * scales[None, :, None]
    np.testing.assert_allclose(db.numpy(), Gb.sum(0), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("score_mode", ["l1", "l2"])
@pytest.mark.parametrize("n,d,rb", [(512, 80, 2), (384, 128, 3), (256, 64, 2)])
def test_onepass_refs_match_jax(score_mode, n, d, rb):
    """The streaming oracle and the per-column one-pass and fused-scores
    oracles against JAX's (``repro/kernels/ref.py:151-236``)."""
    G, idx, scales, W, X = _problem(n, d, rb)
    got = ref.block_stream_matmul_onepass_ref(_t(G), _t(idx).long(), _t(scales), _t(W),
                                              _t(X), block=BLOCK, score_mode=score_mode)
    want = jref.block_stream_matmul_onepass_ref(jnp.asarray(G), jnp.asarray(idx),
                                                jnp.asarray(scales), jnp.asarray(W),
                                                jnp.asarray(X), block=BLOCK,
                                                score_mode=score_mode)
    cols = np.array([3, 17, 100, 200, n - 1])
    cs = np.linspace(1.0, 3.0, len(cols)).astype(np.float32)
    for fn in ("gather_cols_onepass_ref", "gather_cols_fused_scores_ref"):
        got += getattr(ref, fn)(_t(G), _t(cols), _t(cs), _t(W), _t(X), score_mode=score_mode)
        want += getattr(jref, fn)(jnp.asarray(G), jnp.asarray(cols), jnp.asarray(cs),
                                  jnp.asarray(W), jnp.asarray(X), score_mode=score_mode)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=MM_ATOL)


@pytest.mark.parametrize("score_mode", ["l1", "l2"])
def test_stream_ref_equals_fused_ref_with_every_column_scored(score_mode):
    """For the same keeps the streaming oracle's dX, dWc and db are the fused
    oracle's, and its scores are the score oracle's over all of G."""
    G, idx, scales, W, X = _problem(n=512, d=64, rb=2)
    args = (_t(G), _t(idx).long(), _t(scales), _t(W), _t(X))
    got = ref.block_stream_matmul_onepass_ref(*args, block=BLOCK, score_mode=score_mode)
    fused = ref.block_gather_matmul_fused_ref(*args, block=BLOCK, with_scores=True,
                                              score_mode=score_mode)
    for a, b in zip(got[:3], fused[:3]):
        assert torch.equal(a, b)
    assert torch.equal(got[3], ref.col_scores_ref(_t(G), mode=score_mode))
    kept = (idx[:, None] * BLOCK + np.arange(BLOCK)[None, :]).reshape(-1)
    np.testing.assert_allclose(got[3].numpy()[kept], fused[3].reshape(-1).numpy(), rtol=RTOL)


def test_dispatcher_uses_plain_versions_on_cpu_without_launching():
    ops.reset_launch_counts()
    G, idx, scales, W, X = _problem()
    s = ops.col_l1_scores(_t(G), mode="l2")
    np.testing.assert_array_equal(s.numpy(), ref.col_scores_ref(_t(G), mode="l2").numpy())
    out = ops.block_gather_matmul_fused(_t(G), _t(idx).long(), _t(scales), _t(W), _t(X),
                                        block=BLOCK, with_scores=True)
    want = ref.block_gather_matmul_fused_ref(_t(G), _t(idx).long(), _t(scales), _t(W),
                                             _t(X), block=BLOCK, with_scores=True)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    args = (_t(G), _t(idx).long(), _t(scales))
    assert torch.equal(ops.block_gather_matmul(*args, _t(W), block=BLOCK),
                       ref.block_gather_matmul_ref(*args, _t(W), block=BLOCK))
    assert torch.equal(ops.block_gather_matmul_dw(*args, _t(X), block=BLOCK),
                       ref.block_gather_matmul_dw_ref(*args, _t(X), block=BLOCK))
    out = ops.block_stream_matmul_fused(*args, _t(W), _t(X), block=BLOCK, score_mode="l2")
    want = ref.block_stream_matmul_onepass_ref(*args, _t(W), _t(X), block=BLOCK,
                                               score_mode="l2")
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    q = _t(G[:64, :256]).reshape(1, 64, 4, 64)
    assert torch.equal(ops.flash_attention(q, q, q), ref.flash_attention_ref(q, q, q))
    assert ops.launch_counts() == {name: 0 for name in (
        "col_l1_scores", "block_gather_matmul", "block_gather_matmul_dw",
        "block_gather_matmul_fused", "block_stream_matmul_fused", "flash_attention")}
    with pytest.raises(ValueError, match="score mode"):
        ops.col_l1_scores(_t(G), mode="l3")


def test_dispatcher_raises_off_cpu_and_cuda():
    meta = torch.empty((8, 128), device="meta")
    with pytest.raises(ValueError, match="CPU or all on a CUDA"):
        ops.col_l1_scores(meta)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch kernels: a CPU tensor is refused, never computed."""
    G, idx, scales, W, X = _problem()
    with pytest.raises(ValueError, match="CUDA"):
        col_scores.col_l1_scores(_t(G))
    with pytest.raises(ValueError, match="CUDA"):
        sketch_matmul.block_gather_matmul_fused(_t(G), _t(idx), _t(scales), _t(W), _t(X),
                                                block=BLOCK)
    with pytest.raises(ValueError, match="block"):
        sketch_matmul.block_gather_matmul_fused(_t(G), _t(idx), _t(scales), _t(W), _t(X),
                                                block=100)
    for call in (lambda: sketch_matmul.block_gather_matmul(_t(G), _t(idx), _t(scales), _t(W)),
                 lambda: sketch_matmul.block_gather_matmul_dw(_t(G), _t(idx), _t(scales),
                                                              _t(X)),
                 lambda: sketch_matmul.block_stream_matmul_fused(_t(G), _t(idx), _t(scales),
                                                                 _t(W), _t(X))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert col_scores.col_l1_scores_plain is ref.col_scores_ref
    assert sketch_matmul.block_gather_matmul_fused_plain is ref.block_gather_matmul_fused_ref
    assert sketch_matmul.block_gather_matmul_plain is ref.block_gather_matmul_ref
    assert sketch_matmul.block_gather_matmul_dw_plain is ref.block_gather_matmul_dw_ref
    assert sketch_matmul.block_stream_matmul_fused_plain is ref.block_stream_matmul_onepass_ref


def test_build_names_every_cuda_source():
    """Every kernel source in csrc/ is built (one nvcc each), and none is
    built twice; no kernel of the port is left to Triton."""
    assert sorted(build.SOURCES) == sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert len(set(build.SOURCES)) == len(build.SOURCES)
    pat = re.compile(r"^\s*(import|from)\s+triton(\.|\s|$)", re.M)
    files = sorted(build.CSRC.parent.glob("*.py"))
    assert any(f.name == "col_scores.py" for f in files)
    assert [str(f) for f in files if pat.search(f.read_text())] == []


@pytest.mark.parametrize("N,n,dtype", [(2048, 768, torch.float32), (2048, 2048, torch.float32),
                                       (2048, 768, torch.bfloat16), (2000, 768, torch.float32),
                                       (1, 7, torch.float32), (100_000, 300, torch.bfloat16)])
def test_col_scores_split_plan_covers_every_row(N, n, dtype):
    """The score kernel's row splits: multiples of a block's step of rows
    (128 float32 or 64 bf16), none empty, all of G covered, at most about
    four blocks per SM of an H100 (132 SMs); at the path's [2048, 768]
    float32, 16 splits of 128 rows."""
    rows, splits = col_scores.split_plan(N, n, dtype, sms=132)
    step = col_scores.split_step(dtype)
    assert step == {torch.float32: 128, torch.bfloat16: 64}[dtype]
    assert rows > 0 and rows % step == 0
    assert (splits - 1) * rows < N <= splits * rows
    strips = -(-n // col_scores.strip_width(dtype))
    assert splits * strips < 4 * 132 + strips  # about four per SM, never far more
    if (N, n, dtype) == (2048, 768, torch.float32):
        assert (rows, splits, strips) == (128, 16, 6)
