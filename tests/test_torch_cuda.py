"""repro_torch kernels against their plain versions on a CUDA card.

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX (from the checkout's root):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Without a card every test skips with the reason "no CUDA device".
Tolerances: float32 outputs 1e-5 of the output's largest magnitude (the
kernel and the plain version sum in different orders); bfloat16 outputs
1e-2 of it (one bfloat16 ulp is 2^-8 of the value). A float32 sum of K
terms gets the larger of 1e-5 and sqrt(K) * 2^-24, the growth of a K-term
sum's error: 1.53e-5 at the §5 models' tallest G, K = 65,536 (``_sum_tol``).
"""
import ctypes
import math
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.kernels import col_scores, ops, sketch_matmul  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _sum_tol(K):
    """float32 tolerance of a K-term sum: sqrt(K) * 2^-24, at least 1e-5
    (1.53e-5 at 65,536)."""
    return max(TOL[torch.float32], math.sqrt(K) * 2.0 ** -24)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, rel):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item() + 1e-30, err


# the path's two shapes; N no multiple of a split (2000); n no multiple of
# the 16-byte vector width (300 in bf16, 1030 and 7 in both), so masked
# scalar loads; the §5 models' shapes: BagNet's tall G (N 65,536 and 16,384,
# 4,096), ViT's 4,160 rows at n 192 (1.5 strips) and 1,024, the MLP's
# [128, 64] and its 10-wide head (scalar loads)
@pytest.mark.parametrize("shape", [(2048, 768), (2048, 2048), (2000, 768), (100, 300), (1, 7),
                                   (300, 1030), (65536, 64), (65536, 128), (16384, 128),
                                   (16384, 256), (4096, 256), (4160, 192), (4160, 1024),
                                   (128, 64), (128, 10),
                                   # olmoe's expert buckets (capacity 320 at N 2,048) and
                                   # gemma3_1b's k/v, o and mlp widths
                                   (320, 1024), (320, 2048), (2048, 256), (2048, 1152),
                                   (2048, 6912),
                                   # rwkv6-3b's 2560 and 8960 widths, zamba2-7b's 7168
                                   # (Mamba in), 3584 and 14336 (shared mlp in/gate)
                                   (2048, 2560), (2048, 8960), (2048, 7168), (2048, 3584),
                                   (2048, 14336)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["l1", "l2"])
def test_cuda_col_l1_scores_matches_plain(cuda, shape, dtype, mode):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    G = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = col_scores.col_l1_scores.launches
    got = col_scores.col_l1_scores(G, mode=mode)
    assert col_scores.col_l1_scores.launches == before + 1
    _close(got, col_scores.col_l1_scores_plain(G, mode=mode), _sum_tol(shape[0]))
    assert torch.equal(got, col_scores.col_l1_scores(G, mode=mode))  # deterministic


# the block kernels' shapes: the training path's three; N no multiple of the
# roles' 64-row stage (2000, 100, 33, 17); every block kept (rb = n / 128: 512,
# 256 and 1024 wide); d that breaks 16-byte rows (130, 1030); at least two
# fused dW blocks per SM of an H100, where the fused launch takes 32-row
# stages (2048 x 2048 x 768 rb 3, and 100 x 1024 x 1030 rb 8)
BLOCK_SHAPES = [(2048, 768, 768, 1), (2048, 2048, 768, 3), (100, 512, 80, 2), (33, 256, 130, 2),
                (2048, 768, 2048, 1), (2000, 768, 768, 1), (17, 256, 130, 2), (2000, 512, 80, 4),
                (100, 256, 64, 2), (100, 1024, 1030, 8)] + [
    # olmoe-1b-7b at l1@0.2: the expert buckets (capacity 320 at N 2,048),
    # expert_in / expert_gate and expert_out
    (320, 1024, 2048, 2), (320, 2048, 1024, 3),
    # gemma3_1b at l1@0.2: k/v (one 256-wide head), q, o, mlp in/gate and out
    (2048, 256, 1152, 1), (2048, 1024, 1152, 2), (2048, 1152, 1024, 2), (2048, 6912, 1152, 11),
    (2048, 1152, 6912, 2),
    # rwkv6-3b at l1@0.2: r/k/v/g/o and cm_r, cm_k and cm_v
    (2048, 2560, 2560, 4), (2048, 8960, 2560, 14), (2048, 2560, 8960, 4),
    # zamba2-7b at l1@0.2: Mamba in_z/in_x and out; the shared block's
    # q/k/v/o, mlp in/gate and out
    (2048, 7168, 3584, 11), (2048, 3584, 7168, 6), (2048, 3584, 3584, 6),
    (2048, 14336, 3584, 22), (2048, 3584, 14336, 6)]
# an MoE expert that no token chose: its bucket's G and X are all zeros
EXPERT_SHAPES = [(320, 1024, 2048, 2), (320, 2048, 1024, 3)]
# the fused kernel's shapes in the §5 models: BagNet's tall G (one 32 x 32
# dW tile walks 65,536 rows) and ViT's mlp_in
PAPER_BLOCK_SHAPES = [(65536, 128, 64, 1), (16384, 128, 128, 1), (16384, 256, 128, 1),
                      (4096, 256, 256, 1), (4160, 1024, 192, 2)]


@pytest.mark.parametrize("N,n,d,rb", BLOCK_SHAPES + PAPER_BLOCK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_scores", [False, True])
def test_cuda_block_gather_matmul_fused_matches_plain(cuda, N, n, d, rb, dtype, with_scores):
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    G = torch.randn((N, n), generator=g, device=cuda).to(dtype)
    W = torch.randn((n, d), generator=g, device=cuda).to(dtype)
    X = torch.randn((N, d), generator=g, device=cuda).to(dtype)
    idx = torch.sort(torch.randperm(n // 128, generator=g, device=cuda)[:rb]).values.int()
    scales = 1.0 + torch.rand(rb, generator=g, device=cuda)
    kw = dict(block=128, with_scores=with_scores, score_mode="l2" if with_scores else "l1")
    got = sketch_matmul.block_gather_matmul_fused(G, idx, scales, W, X, **kw)
    want = sketch_matmul.block_gather_matmul_fused_plain(G, idx, scales, W, X, **kw)
    torch.cuda.synchronize()
    # dX sums the kept columns, dWc, db and the scores the N rows
    f32_tol = (_sum_tol(rb * 128), _sum_tol(N), _sum_tol(N), _sum_tol(N))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, TOL[dtype] if i < 2 and dtype == torch.bfloat16 else f32_tol[i])


def _problem(cuda, N, n, d, rb, dtype, seed):
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    G = torch.randn((N, n), generator=g, device=cuda).to(dtype)
    W = torch.randn((n, d), generator=g, device=cuda).to(dtype)
    X = torch.randn((N, d), generator=g, device=cuda).to(dtype)
    idx = torch.sort(torch.randperm(n // 128, generator=g, device=cuda)[:rb]).values.int()
    scales = 1.0 + torch.rand(rb, generator=g, device=cuda)
    return G, idx, scales, W, X


@pytest.mark.parametrize("N,n,d,rb", BLOCK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["l1", "l2"])
def test_cuda_block_stream_matmul_fused_matches_plain_and_fused(cuda, N, n, d, rb, dtype,
                                                                 mode):
    """Against the plain version; dX, dWc and db bit-identical to the fused
    kernel's for the same keeps, the kept columns' scores too; every
    column's score deterministic."""
    G, idx, scales, W, X = _problem(cuda, N, n, d, rb, dtype, 2)
    before = sketch_matmul.block_stream_matmul_fused.launches
    got = sketch_matmul.block_stream_matmul_fused(G, idx, scales, W, X, block=128,
                                                  score_mode=mode)
    assert sketch_matmul.block_stream_matmul_fused.launches == before + 1
    want = sketch_matmul.block_stream_matmul_fused_plain(G, idx, scales, W, X, block=128,
                                                         score_mode=mode)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, TOL[dtype] if i < 2 else 1e-5)
    fused = sketch_matmul.block_gather_matmul_fused(G, idx, scales, W, X, block=128,
                                                    with_scores=True, score_mode=mode)
    for a, b in zip(got[:3], fused[:3]):
        assert torch.equal(a, b)
    kept = (idx.long()[:, None] * 128 + torch.arange(128, device=cuda)[None, :]).reshape(-1)
    assert torch.equal(got[3][kept], fused[3].reshape(-1))
    again = sketch_matmul.block_stream_matmul_fused(G, idx, scales, W, X, block=128,
                                                    score_mode=mode)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("N,n,d,rb", BLOCK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_unfused_pair_matches_plain_and_fused(cuda, N, n, d, rb, dtype):
    G, idx, scales, W, X = _problem(cuda, N, n, d, rb, dtype, 3)
    dX = sketch_matmul.block_gather_matmul(G, idx, scales, W, block=128)
    dWc = sketch_matmul.block_gather_matmul_dw(G, idx, scales, X, block=128)
    _close(dX, sketch_matmul.block_gather_matmul_plain(G, idx, scales, W, block=128),
           TOL[dtype])
    _close(dWc, sketch_matmul.block_gather_matmul_dw_plain(G, idx, scales, X, block=128),
           TOL[dtype])
    fused = sketch_matmul.block_gather_matmul_fused(G, idx, scales, W, X, block=128)
    assert torch.equal(dX, fused[0]) and torch.equal(dWc, fused[1])


@pytest.mark.parametrize("N,n,d,rb", EXPERT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_on_an_all_zero_bucket(cuda, N, n, d, rb, dtype):
    """An expert bucket no token filled: G and X are zeros. Every kernel of
    the MoE path gives its plain version's zeros (scores, dX, dWc, db and
    the stream kernel's fresh scores), nothing non-finite."""
    _, idx, scales, W, _ = _problem(cuda, N, n, d, rb, dtype, 4)
    G = torch.zeros((N, n), device=cuda, dtype=dtype)
    X = torch.zeros((N, d), device=cuda, dtype=dtype)
    outs = [(col_scores.col_l1_scores(G), col_scores.col_l1_scores_plain(G))]
    for fn, plain, kw in (
            (sketch_matmul.block_gather_matmul_fused,
             sketch_matmul.block_gather_matmul_fused_plain, dict(with_scores=True)),
            (sketch_matmul.block_gather_matmul_fused,
             sketch_matmul.block_gather_matmul_fused_plain, {}),
            (sketch_matmul.block_stream_matmul_fused,
             sketch_matmul.block_stream_matmul_fused_plain, {})):
        outs.extend(zip(fn(G, idx, scales, W, X, block=128, **kw),
                        plain(G, idx, scales, W, X, block=128, **kw)))
    torch.cuda.synchronize()
    for got, want in outs:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want) and not bool(got.any())


def test_cuda_dispatcher_launches_and_counts(cuda):
    G = torch.randn((64, 256), device=cuda)
    W = torch.randn((256, 32), device=cuda)
    X = torch.randn((64, 32), device=cuda)
    idx, scales = torch.tensor([1], device=cuda), torch.ones(1, device=cuda)
    ops.reset_launch_counts()
    ops.col_l1_scores(G)
    ops.block_gather_matmul(G, idx, scales, W, block=128)
    ops.block_gather_matmul_dw(G, idx, scales, X, block=128)
    ops.block_gather_matmul_fused(G, idx, scales, W, X, block=128)
    ops.block_stream_matmul_fused(G, idx, scales, W, X, block=128)
    q = torch.randn((1, 64, 2, 64), device=cuda)
    ops.flash_attention(q, q, q)
    assert ops.launch_counts() == {name: 1 for name in (
        "col_l1_scores", "block_gather_matmul", "block_gather_matmul_dw",
        "block_gather_matmul_fused", "block_stream_matmul_fused", "flash_attention")}
    with pytest.raises(ValueError):
        ops.block_gather_matmul_fused(G, torch.tensor([0]), torch.ones(1), W, X, block=128)


# (B, Sq, Skv, H, Kv, dh, causal, window): tests/test_kernels.py's flash
# shapes (GQA, window, Skv > Sq right-aligned, non-causal, ragged 100), a
# windowed GQA set at dh 128, and the serving path's prefill shapes
FLASH_SHAPES = [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 96, 96, 4, 4, 64, True, 32),
    (2, 64, 192, 4, 1, 128, True, None),
    (1, 128, 128, 2, 2, 64, False, None),
    (1, 100, 100, 2, 2, 64, True, None),
    (1, 96, 96, 4, 2, 128, True, 40),
    (8, 1024, 1024, 12, 12, 64, True, None),
    (4, 1000, 1000, 12, 12, 64, True, None),
    # Sq and Skv no multiple of the query tile (128 rows at dh 64, 64 at
    # dh 128) or of the 64-key tile; a window crossing tile borders; GQA
    # 12/4 right-aligned; dh 128; non-causal with Skv > Sq
    (1, 1, 1, 2, 2, 64, True, None),
    (2, 1, 65, 2, 2, 64, True, None),
    (1, 65, 65, 2, 1, 64, True, None),
    (1, 65, 1023, 4, 2, 128, True, 100),
    (1, 1000, 1023, 12, 4, 64, True, None),
    (1, 1023, 1023, 2, 2, 64, True, 130),
    (1, 1023, 1023, 2, 2, 128, True, None),
    (1, 65, 1000, 2, 2, 64, False, None),
]


def _qkv(cuda, B, Sq, Skv, H, Kv, dh, dtype, seed=4):
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=cuda).to(dtype)
                 for shape in ((B, Sq, H, dh), (B, Skv, Kv, dh), (B, Skv, Kv, dh)))


@pytest.mark.parametrize("B,Sq,Skv,H,Kv,dh,causal,window", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(cuda, B, Sq, Skv, H, Kv, dh, causal, window, dtype):
    """Against the plain version; the same inputs twice give the same bits;
    one launch counted."""
    q, k, v = _qkv(cuda, B, Sq, Skv, H, Kv, dh, dtype)
    before = flash.flash_attention.launches
    got = flash.flash_attention(q, k, v, causal=causal, window=window)
    assert flash.flash_attention.launches == before + 1
    want = flash.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    _close(got, want, TOL[dtype])
    assert torch.equal(got, flash.flash_attention(q, k, v, causal=causal, window=window))


# (B, Sq, Skv, H, Kv, dh, causal, window): head widths other than 64 and 128,
# run in the next instantiated width (64, 128 or 256) with zero-filled
# columns: dh 20 (16-byte rows in float32, not in bf16: plain loads), 24,
# 96, 256 (gemma3_1b; its smoke config has 24), 7 (no 4-aligned output
# rows: scalar stores), causal, windowed and not causal, GQA; the last is
# gemma3_1b's prefill at 4096 tokens (H 4, Kv 1, window 512)
FLASH_WIDTH_SHAPES = [
    (1, 70, 70, 2, 2, 20, True, None),
    (2, 100, 100, 2, 1, 20, True, 30),
    (1, 65, 130, 2, 2, 20, False, None),
    (1, 100, 100, 4, 2, 24, True, None),
    (1, 130, 130, 4, 4, 96, True, 40),
    (1, 65, 200, 2, 2, 96, False, None),
    (1, 128, 128, 4, 1, 256, True, None),
    (1, 200, 200, 4, 1, 256, True, 64),
    (1, 65, 200, 2, 2, 256, False, None),
    (1, 50, 50, 2, 2, 7, True, None),
    (1, 4096, 4096, 4, 1, 256, True, 512),
    # zamba2-7b's shared attention block at its prefill of 4 x 512 (dh 112)
    (4, 512, 512, 32, 32, 112, True, None),
]


@pytest.mark.parametrize("B,Sq,Skv,H,Kv,dh,causal,window", FLASH_WIDTH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_at_other_head_widths(cuda, B, Sq, Skv, H, Kv, dh, causal, window,
                                                   dtype):
    """Against the plain version at the true scale dh^-1/2; the padded
    columns are never written; the same bits on a second call."""
    q, k, v = _qkv(cuda, B, Sq, Skv, H, Kv, dh, dtype, seed=dh)
    got = flash.flash_attention(q, k, v, causal=causal, window=window)
    want = flash.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.shape == (B, Sq, H, dh) and got.dtype == dtype
    _close(got, want, TOL[dtype])
    assert torch.equal(got, flash.flash_attention(q, k, v, causal=causal, window=window))


def test_cuda_flash_attention_reads_strided_inputs(cuda):
    """q, k and v as views into one packed [B, S, 3, H, dh] projection, as
    the kernel reads them through their strides, with no copy."""
    qkv = torch.randn((2, 130, 3, 4, 64), device=cuda)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = flash.flash_attention(q, k, v, causal=True, window=50)
    want = flash.flash_attention_plain(q, k, v, causal=True, window=50)
    _close(got, want, TOL[torch.float32])


def test_cuda_flash_attention_refuses_what_it_does_not_take(cuda):
    q = torch.randn((1, 64, 2, 64), device=cuda, requires_grad=True)
    k = torch.randn((1, 32, 2, 64), device=cuda)
    out = flash.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()
    with pytest.raises(ValueError, match="Sq <= Skv"):
        flash.flash_attention(q.detach(), k, k)
    with pytest.raises(ValueError):  # a CUDA q with a CPU k
        ops.flash_attention(q.detach(), k.cpu(), k.cpu())
    with pytest.raises(ValueError):
        flash.flash_attention(q.detach(), k.cpu(), k.cpu())
    with pytest.raises(ValueError, match="dh from 1 to 256"):
        x = torch.randn((1, 64, 2, 264), device=cuda)
        flash.flash_attention(x, x, x)
    with pytest.raises(ValueError):
        x = torch.randn((1, 64, 2, 64), device=cuda, dtype=torch.float16)
        flash.flash_attention(x, x, x)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_reads_rows_that_are_not_16_byte_aligned(cuda, dh, dtype):
    """q, k and v as views into a [B, S, 3 H dh + 1] projection: the row
    stride breaks the 16-byte alignment of the asynchronous copies, so the
    kernel fills its K/V ring with plain loads."""
    B, S, H = 2, 200, 4
    x = torch.randn((B, S, 3 * H * dh + 1), device=cuda).to(dtype)
    q, k, v = (x[..., i * H * dh:(i + 1) * H * dh].unflatten(-1, (H, dh)) for i in range(3))
    assert (k.stride(1) * k.element_size()) % 16 != 0
    got = flash.flash_attention(q, k, v, causal=True, window=70)
    want = flash.flash_attention_plain(q, k, v, causal=True, window=70)
    torch.cuda.synchronize()
    _close(got, want, TOL[dtype])
    assert torch.equal(got, flash.flash_attention(q, k, v, causal=True, window=70))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_block_stream_matmul_fused_reads_g_that_is_not_16_byte_aligned(cuda, dtype):
    """G one element into a flat buffer: the asynchronous copies need 16-byte
    rows, so the kernel fills its G tiles with plain loads; the outputs stay
    bit for bit the fused kernel's."""
    G0, idx, scales, W, X = _problem(cuda, 100, 256, 64, 2, dtype, 5)
    flat = torch.empty(G0.numel() + 1, dtype=dtype, device=cuda)
    flat[1:].copy_(G0.reshape(-1))
    G = flat[1:].view(G0.shape)
    assert G.data_ptr() % 16 != 0
    args = (G, idx, scales, W, X)
    got = sketch_matmul.block_stream_matmul_fused(*args, block=128)
    fused = sketch_matmul.block_gather_matmul_fused(*args, block=128, with_scores=True)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], fused[:3]):
        assert torch.equal(a, b)
    _close(got[3], sketch_matmul.block_stream_matmul_fused_plain(*args, block=128)[3], 1e-5)


def _misaligned(t):
    """t's values one element into a flat buffer: a pointer that breaks 16-byte
    alignment."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:].copy_(t.reshape(-1))
    out = flat[1:].view(t.shape)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("N,n,d,rb", [(100, 256, 64, 2), (100, 1024, 264, 8)])
@pytest.mark.parametrize("operand", ["G", "W", "X"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_block_gather_matmul_fused_reads_operands_that_are_not_16_byte_aligned(
        cuda, N, n, d, rb, operand, dtype):
    """G, W or X one element into a flat buffer: the kernel fills that
    operand's tiles with plain loads instead of cp.async; every output keeps
    the bits of the aligned call, and the streaming kernel's. The second
    shape has enough dW blocks for the fused launch's 32-row stages."""
    G, idx, scales, W, X = _problem(cuda, N, n, d, rb, dtype, 6)
    args = {"G": G, "W": W, "X": X}
    aligned = sketch_matmul.block_gather_matmul_fused(G, idx, scales, W, X, block=128,
                                                      with_scores=True)
    args[operand] = _misaligned(args[operand])
    got = sketch_matmul.block_gather_matmul_fused(args["G"], idx, scales, args["W"], args["X"],
                                                  block=128, with_scores=True)
    stream = sketch_matmul.block_stream_matmul_fused(args["G"], idx, scales, args["W"],
                                                     args["X"], block=128)
    torch.cuda.synchronize()
    for a, b in zip(got, aligned):
        assert torch.equal(a, b)
    for a, b in zip(got[:3], stream[:3]):
        assert torch.equal(a, b)
    want = sketch_matmul.block_gather_matmul_fused_plain(G, idx, scales, W, X, block=128,
                                                         with_scores=True)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, TOL[dtype] if i < 2 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_col_l1_scores_reads_g_that_is_not_16_byte_aligned(cuda, dtype):
    """G one element into a flat buffer: masked scalar loads, the same rows
    in the same order, so the aligned call's bits."""
    g = torch.Generator(device=cuda)
    g.manual_seed(7)
    G = torch.randn((300, 768), generator=g, device=cuda).to(dtype)
    got = col_scores.col_l1_scores(_misaligned(G))
    assert torch.equal(got, col_scores.col_l1_scores(G))
    _close(got, col_scores.col_l1_scores_plain(G), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_col_l1_scores_replays_in_a_cuda_graph(cuda, dtype):
    """Captured in a CUDA graph and replayed twice, the kernel gives the eager
    call's bits each time: its last block of each strip resets the ticket
    counter, with no fill launch between calls."""
    g = torch.Generator(device=cuda)
    g.manual_seed(8)
    G = torch.randn((2048, 768), generator=g, device=cuda).to(dtype)
    eager = col_scores.col_l1_scores(G)
    graph = torch.cuda.CUDAGraph()
    before = col_scores.col_l1_scores.launches
    with torch.cuda.graph(graph):
        out = col_scores.col_l1_scores(G)
        out2 = col_scores.col_l1_scores(G, mode="l2")
    assert col_scores.col_l1_scores.launches == before + 2
    for _ in range(2):
        out.zero_()
        out2.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert torch.equal(out2, col_scores.col_l1_scores(G, mode="l2"))
    assert torch.equal(col_scores.col_l1_scores(G), eager)


# wider than the 1,024 strips of one counter slot: qwen2_vl_2b's vocab in
# float32 (1,187 strips) and gemma3_1b's (2,048 float32 strips, 1,024 bf16)
@pytest.mark.parametrize("n,dtype", [(151_936, torch.float32), (262_144, torch.float32),
                                     (262_144, torch.bfloat16)])
def test_cuda_col_l1_scores_at_vocabulary_widths(cuda, n, dtype):
    """One launch at any width; against the plain version; captured in a
    CUDA graph and replayed, the eager call's bits."""
    g = torch.Generator(device=cuda)
    g.manual_seed(9)
    G = torch.randn((2048, n), generator=g, device=cuda).to(dtype)
    before = col_scores.col_l1_scores.launches
    eager = col_scores.col_l1_scores(G)
    assert col_scores.col_l1_scores.launches == before + 1
    _close(eager, col_scores.col_l1_scores_plain(G), 1e-5)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = col_scores.col_l1_scores(G)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert torch.equal(col_scores.col_l1_scores(G), eager)


def _new_stream(cuda):
    """A CUDA stream of its own (PyTorch's stream pool recycles 32 per
    priority), made through the CUDA runtime that PyTorch binds."""
    handle = ctypes.c_ulonglong(0)
    with torch.cuda.device(cuda):
        assert torch.cuda.cudart().cudaStreamCreate(ctypes.addressof(handle)) == 0
    return torch.cuda.ExternalStream(handle.value, device=cuda)


def test_cuda_col_l1_scores_on_more_than_64_streams(cuda):
    """80 streams launch at once, each with counters of its own (allocated at
    its first launch), and a graph captured on an 81st stream, whose
    counters are allocated during the capture, replays: every result is the
    default stream's bits."""
    g = torch.Generator(device=cuda)
    g.manual_seed(10)
    Gs = [torch.randn((2048, 768), generator=g, device=cuda) for _ in range(4)]
    want = [col_scores.col_l1_scores(G) for G in Gs]
    torch.cuda.synchronize()
    streams = [_new_stream(cuda) for _ in range(81)]
    try:
        outs = []
        for i, st in enumerate(streams[:80]):
            st.wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(st):
                outs.append(col_scores.col_l1_scores(Gs[i % 4]))
        torch.cuda.synchronize()
        assert len(col_scores._slots) > 80
        for i, out in enumerate(outs):
            assert torch.equal(out, want[i % 4])
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=streams[80]):
            out = col_scores.col_l1_scores(Gs[1])
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want[1])
    finally:
        torch.cuda.synchronize()
        for st in streams:
            torch.cuda.cudart().cudaStreamDestroy(st.cuda_stream)


@pytest.mark.parametrize("backend", ["pallas", "stale"])
def test_cuda_compact_step_equals_dense_step(cuda, backend):
    """One step of a 2-layer LM whose sites are whole 128-column blocks, from
    the same parameters, batch and seed, with compact gradients on and off
    (non-lazy AdamW): the same kernel launches, every sketched site's w
    gradient compact, and the parameters within float32 tolerance (rtol 2e-5,
    atol 2e-6, as the JAX package's own test of the same equivalence)."""
    from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.compact_grad import CompactGrad
    from repro_torch.optim import Optimizer, adamw
    from repro_torch.tree import tree_leaves

    cfg = ArchConfig(name="lm-cuda-compact", family="dense", n_layers=2, d_model=256,
                     n_heads=4, n_kv=4, d_ff=512, vocab=512, q_chunk=64, kv_chunk=64)
    policy = SketchPolicy(base=SketchConfig(method="l1", budget=0.5, backend=backend,
                                            block=128))
    toks = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks, "labels": toks}
    out = {}
    for compact in (False, True):
        seen, base = [], adamw(1e-3, weight_decay=0.1, clip=1.0)

        def update(grads, st, params, step, seen=seen, base=base):
            seen.append(grads)  # the gradients the optimizer is given
            return base.update(grads, st, params, step)

        opt = Optimizer(base.init, update)
        rt = Runtime(policy=policy, execution=ExecutionConfig(compact_grads=compact),
                     device=cuda)
        state = rt.init_state(0, cfg, opt)
        ops.reset_launch_counts()
        state, m = rt.train_step(cfg, opt)(state, batch, 1)
        torch.cuda.synchronize()
        n_compact = sum(isinstance(g, CompactGrad) for g in tree_leaves(seen[0]))
        assert n_compact == (7 * cfg.n_layers if compact else 0)
        out[compact] = (float(m["loss"]), ops.launch_counts(),
                        [p.detach() for p in tree_leaves(state.params)])
    (loss_d, counts_d, p_d), (loss_c, counts_c, p_c) = out[False], out[True]
    assert counts_c == counts_d and counts_c["block_gather_matmul_fused"] == 7 * cfg.n_layers
    assert loss_c == pytest.approx(loss_d, rel=1e-6)
    assert len(p_c) == len(p_d)
    for a, b in zip(p_c, p_d):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("model", ["mlp", "vit", "bagnet"])
def test_cuda_paper_models_train_with_their_launches(cuda, model):
    """Two steps of each §5 model at App. B.2's widths under the block-128
    l1@0.2 pallas policy launch the score and fused kernels exactly at their
    sketched sites (MLP 3 / 0 per step through Runtime.train, ViT 54 / 9 and
    BagNet 12 / 9 driven by hand), with finite losses; an exact-context
    evaluation launches nothing."""
    import functools

    from repro_torch import rng
    from repro_torch.api import Runtime, SketchConfig, SketchPolicy
    from repro_torch.models import mlp, vision
    from repro_torch.optim import adamw, constant, cosine_warmup, sgd
    from repro_torch.train.trainer import TrainerConfig
    from repro_torch.tree import tree_leaves, tree_map

    base = SketchConfig(method="l1", budget=0.2, backend="pallas", block=128)
    per_step = {"mlp": (3, 0), "vit": (54, 9), "bagnet": (12, 9)}[model]
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    if model == "mlp":
        runtime = Runtime(policy=SketchPolicy(base=base, exclude_roles=()), device=cuda)
        batches = [{"x": torch.randn((128, 784), generator=g, device=cuda),
                    "y": torch.randint(0, 10, (128,), generator=g, device=cuda)}
                   for _ in range(2)]
        ops.reset_launch_counts()
        state, hist = runtime.train(mlp.mlp_arch(), sgd(constant(0.2), clip=1.0), batches,
                                    TrainerConfig(steps=2, log_every=1),
                                    on_metrics=lambda m: None)
        losses = [h["loss"] for h in hist]
        params, loss_fn = state.params, mlp.mlp_loss
    else:
        runtime = Runtime(policy=SketchPolicy(base=base), device=cuda)
        if model == "vit":
            params = vision.vit_init(0, device=cuda)
            loss_fn = functools.partial(vision.cls_loss,
                                        functools.partial(vision.vit_apply, heads=12))
            opt = adamw(cosine_warmup(3e-4, 20, 400), weight_decay=0.05, clip=1.0)
        else:
            params = vision.bagnet_init(0, device=cuda)
            loss_fn = functools.partial(vision.cls_loss, vision.bagnet_apply)
            opt = sgd(cosine_warmup(0.03, 10, 400), momentum=0.9, clip=1.0)
        batches = [{"x": torch.randn((64, 32, 32, 3), generator=g, device=cuda),
                    "y": torch.randint(0, 10, (64,), generator=g, device=cuda)}
                   for _ in range(2)]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        state, losses = opt.init(params), []
        ops.reset_launch_counts()
        for i, b in enumerate(batches):
            loss, _ = loss_fn(params, b, runtime.ctx(rng.fold_in(0, i + 1)))
            it = iter(torch.autograd.grad(loss, leaves))
            _, state = opt.update(tree_map(lambda _: next(it), params), state, params, i)
            losses.append(float(loss))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["col_l1_scores"], counts["block_gather_matmul_fused"]) == (
        2 * per_step[0], 2 * per_step[1])
    assert sum(counts.values()) == 2 * sum(per_step)
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    ops.reset_launch_counts()
    with torch.no_grad():
        loss_fn(params, batches[0], runtime.ctx(rng.fold_in(0, 9), budget=None))
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values())


# the trainer loop's card tests: 2-layer LMs whose sites are whole 128-column
# blocks (d_model 256: q/k/v/o 256 wide, mlp 512), at two widths
LOOP_CFGS = {"d256": dict(d_model=256, n_heads=4, n_kv=4, d_ff=512),
             "d384": dict(d_model=384, n_heads=6, n_kv=2, d_ff=1024)}


def _loop_cfg(name):
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name=f"lm-cuda-{name}", family="dense", n_layers=2, vocab=512,
                      q_chunk=64, kv_chunk=64, **LOOP_CFGS[name])


def _loop_batch(cfg, B=4, S=64, seed=0):
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("shape", sorted(LOOP_CFGS))
@pytest.mark.parametrize("backend", ["pallas", "onepass", "stale"])
def test_cuda_probes_do_not_change_training(cuda, backend, shape):
    """Two steps with and without telemetry probes from the same parameters,
    batches and seeds (AdamW): every parameter, carry and moment equal bit
    for bit, the same launches (the probe reads the rows the kernels already
    returned), and a finite probe summary."""
    from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
    from repro_torch.api import TelemetryConfig
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves

    cfg = _loop_cfg(shape)
    policy = SketchPolicy(base=SketchConfig(method="l1", budget=0.5, backend=backend,
                                            block=128))
    out = {}
    for probes in (False, True):
        rt = Runtime(policy=policy, device=cuda, execution=ExecutionConfig(
            telemetry=TelemetryConfig() if probes else None))
        opt = adamw(1e-3, weight_decay=0.1, clip=1.0)
        state = rt.init_state(0, cfg, opt)
        step = rt.train_step(cfg, opt)
        ops.reset_launch_counts()
        for i in range(2):
            state, m = step(state, _loop_batch(cfg, seed=i), 1 + i)
        torch.cuda.synchronize()
        out[probes] = (state, m, ops.launch_counts())
    (s0, m0, c0), (s1, m1, c1) = out[False], out[True]
    kernel = {"pallas": "block_gather_matmul_fused", "onepass": "block_stream_matmul_fused",
              "stale": "block_gather_matmul_fused"}[backend]
    assert c0 == c1 and c1[kernel] == 2 * 7 * cfg.n_layers
    assert torch.equal(m0["loss"], m1["loss"])
    leaves0 = tree_leaves(s0.params) + tree_leaves(s0.opt_state)
    leaves1 = tree_leaves(s1.params) + tree_leaves(s1.opt_state)
    assert len(leaves0) == len(leaves1)
    for a, b in zip(leaves0, leaves1):
        assert torch.equal(a, b)
    assert math.isfinite(float(m1["probe_snr"])) and float(m1["probe_var"]) > 0
    assert len(m1["probe_sites"]) == 7


def test_cuda_accumulation_is_the_mean_of_its_microbatches(cuda):
    """A ``stale`` step at accum=2 launches the fused kernel twice per site;
    its gradients equal the mean of its two microbatches run alone under
    their seeds from the same state (rtol 1e-5, atol 1e-6), and its carry the
    mean of their refreshed scores (1e-6 of the largest score)."""
    from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
    from repro_torch.core import plan_state
    from repro_torch.optim import Optimizer
    from repro_torch.train.train_step import TrainState, micro_seed
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _loop_cfg("d256")
    policy = SketchPolicy(base=SketchConfig(method="l1", budget=0.5, backend="stale",
                                            block=128))
    # leaves the parameters as they are; its state is the gradients it saw
    opt = Optimizer(lambda p: {}, lambda grads, state, params, step: (params, grads))
    rt1 = Runtime(policy=policy, device=cuda)
    rt2 = Runtime(policy=policy, device=cuda, execution=ExecutionConfig(accum=2))
    state0 = rt1.init_state(0, cfg, opt)
    state0, _ = rt1.train_step(cfg, opt)(state0, _loop_batch(cfg, seed=3), 9)

    def clone():
        return TrainState(params=tree_map(lambda t: t.detach().clone(), state0.params),
                          opt_state={}, step=state0.step)

    batch, key = _loop_batch(cfg, B=8), 11
    ops.reset_launch_counts()
    s_acc, _ = rt2.train_step(cfg, opt)(clone(), batch, key)
    torch.cuda.synchronize()
    assert ops.launch_counts()["block_gather_matmul_fused"] == 2 * 7 * cfg.n_layers
    grads, carries = [], []
    for m in range(2):
        mb = {k: v[4 * m:4 * m + 4] for k, v in batch.items()}
        s_m, _ = rt1.train_step(cfg, opt)(clone(), mb, micro_seed(key, m))
        grads.append(tree_leaves(s_m.opt_state))
        carries.append(plan_state.collect_plan_state(s_m.params)[1])
    for a, g0, g1 in zip(tree_leaves(s_acc.opt_state), *grads):
        torch.testing.assert_close(a, g0 / 2 + g1 / 2, rtol=1e-5, atol=1e-6)
    got = plan_state.collect_plan_state(s_acc.params)[1]
    assert len(got) == 7 * cfg.n_layers
    for path, v in got.items():
        want = carries[0][path] / 2 + carries[1][path] / 2
        assert (v - want).abs().max() <= 1e-6 * want.abs().max()


def test_cuda_async_checkpoint_before_an_inplace_step(cuda, tmp_path):
    """An async checkpoint of a CUDA train state taken before an in-place
    AdamW step restores the values from before the step (the snapshot is an
    owned pinned-host copy, synchronised before the writer starts), onto the
    card."""
    from repro_torch.api import Runtime, SketchConfig, SketchPolicy
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ck
    from repro_torch.tree import tree_leaves

    cfg = _loop_cfg("d256")
    rt = Runtime(policy=SketchPolicy(base=SketchConfig(method="l1", budget=0.5,
                                                       backend="stale", block=128)),
                 device=cuda)
    opt = adamw(1e-2, weight_decay=0.1)
    step = rt.train_step(cfg, opt)
    state = rt.init_state(0, cfg, opt)
    state, _ = step(state, _loop_batch(cfg, seed=1), 1)
    before = [t.detach().clone() for t in tree_leaves(state.params) + tree_leaves(state.opt_state)]
    mgr = ck.CheckpointManager(str(tmp_path), every=1)
    mgr.maybe_save(1, state)
    state, _ = step(state, _loop_batch(cfg, seed=2), 2)  # in place, while the writer runs
    mgr.wait()
    after = tree_leaves(state.params) + tree_leaves(state.opt_state)
    assert not all(torch.equal(a, b) for a, b in zip(after, before))
    assert ck.verify(str(tmp_path), 1)
    restored, got = ck.restore(str(tmp_path), state, device=cuda)
    assert got == 1 and restored.step == 1
    leaves = tree_leaves(restored.params) + tree_leaves(restored.opt_state)
    assert len(leaves) == len(before)
    for a, b in zip(leaves, before):
        assert a.device.type == "cuda" and torch.equal(a, b)


# the serving engines (tests/test_torch_engine.py's config, which runs them
# against JAX's on the CPU)
SERVE_CFG = dict(name="serve-test", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                 d_ff=128, vocab=256, q_chunk=32, kv_chunk=32, attn_impl="pallas")


def _serve_requests(seed=0, lens=(11, 5, 23, 3, 17, 9, 30, 7), news=(6, 3, 9, 2, 12, 4, 5, 8)):
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(1, 256, size=n).astype(np.int32), max_new=m)
            for n, m in zip(lens, news)]


def test_cuda_engines_give_the_cpu_engines_tokens(cuda):
    """The paged, contiguous and run-to-completion engines on the card give
    the CPU engine's greedy tokens and counters from the same weights, and
    launch no kernel (every prefill batch carries segments; decode runs the
    plain attention)."""
    from repro_torch.api import Runtime, ServeConfig
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.legacy import RunToCompletionEngine
    from repro_torch.tree import tree_map

    cfg = ArchConfig(**SERVE_CFG)
    cpu_params = lm.init_params(0, cfg, device="cpu")
    params = tree_map(lambda t: t.to(cuda), cpu_params)
    want = None
    for page_size in (16, None):
        sv = ServeConfig(n_slots=4, max_len=64, page_size=page_size)
        cpu_eng = Engine(cpu_params, cfg, serve=sv, runtime=Runtime(device="cpu"))
        expect = cpu_eng.run(_serve_requests())
        ops.reset_launch_counts()
        eng = Engine(params, cfg, serve=sv, runtime=Runtime(device=cuda))
        got = eng.run(_serve_requests())
        assert all(n == 0 for n in ops.launch_counts().values()), ops.launch_counts()
        assert [r.out.tolist() for r in got] == [r.out.tolist() for r in expect]
        for k in ("decode_steps", "tokens_out", "wasted_decode_steps", "prefill_calls"):
            assert eng.counters[k] == cpu_eng.counters[k], k
        want = want or [r.out.tolist() for r in expect]
    legacy = _serve_requests()
    ops.reset_launch_counts()
    RunToCompletionEngine(params, cfg, batch=4, max_len=64, runtime=Runtime(device=cuda)).run(
        legacy)
    assert all(n == 0 for n in ops.launch_counts().values()), ops.launch_counts()
    assert [r.out.tolist() for r in legacy] == want


def test_cuda_dead_slots_trash_writes_spare_live_pages(cuda):
    """On the card, freed slots' decode writes (all to trash page 0, several
    at the same row) change no live slot's page: only each live slot's
    (page, offset) and the trash page differ after a scatter."""
    import numpy as np

    from repro_torch.api import ServeConfig
    from repro_torch.configs.base import ArchConfig
    from repro_torch.serve import kv_cache

    cfg = ArchConfig(**SERVE_CFG)
    sv = ServeConfig(n_slots=6, max_len=64, page_size=16)
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    pools = kv_cache.init_pools(cfg, sv, device=cuda)
    for layer in pools:
        for v in layer.values():
            v.copy_(torch.randn(v.shape, generator=g, device=cuda))
    pm = np.zeros((sv.n_slots, sv.pages_per_slot), np.int32)
    pm[1] = [3, 7, 9, 0]
    pm[4] = [2, 5, 0, 0]
    pos = torch.tensor([0, 40, 0, 0, 17, 0], device=cuda)  # slots 0, 2, 3, 5 are free
    page_map = torch.as_tensor(pm, device=cuda)
    contig = kv_cache.gather_slots(pools, page_map, sv)
    for layer in contig:
        for v in layer.values():
            v.copy_(torch.randn(v.shape, generator=g, device=cuda))
    before = [{k: v.clone() for k, v in layer.items()} for layer in pools]
    kv_cache.scatter_token(pools, contig, page_map, pos, sv)
    torch.cuda.synchronize()
    for a, b, c in zip(pools, before, contig):
        for k in a:
            changed = {tuple(x) for x in (a[k] != b[k]).flatten(2).any(-1).nonzero().tolist()}
            assert changed <= {(9, 40 % 16), (5, 17 % 16), (0, 0)}, changed
            assert torch.equal(a[k][9, 8], c[k][1, 40]) and torch.equal(a[k][5, 1], c[k][4, 17])


def test_cuda_engine_decode_step_copies_to_the_host_once(cuda):
    """One engine decode step on the card makes exactly one device-to-host
    copy (the [n_slots] sampled tokens), seen by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Runtime, ServeConfig
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import lm
    from repro_torch.obs import clock

    cfg = ArchConfig(**SERVE_CFG)
    params = lm.init_params(0, cfg, device=cuda)
    for page_size in (16, None):
        eng = Runtime(device=cuda).serve(
            params, cfg, serve=ServeConfig(n_slots=4, max_len=64, page_size=page_size))
        eng.scheduler.submit(_serve_requests(news=(20,) * 8), clock.now())
        eng._refill()
        eng._decode_one_step()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng._decode_one_step()
        d2h = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.key.startswith("Memcpy DtoH"))
        assert d2h == 1, (page_size, d2h)


def test_cuda_sample_independent_on_nan_keeps_nothing_and_raises_nothing(cuda):
    """``uniform < p`` on the card: a NaN probability keeps nothing and is no
    device-side assert (``torch.bernoulli``'s); probability 1 always keeps,
    0 never."""
    from repro_torch.core import solver

    p = torch.tensor([0.5, float("nan"), 1.0, 0.0] * 64, device=cuda)
    g = torch.Generator(device=cuda)
    for seed in range(20):
        g.manual_seed(seed)
        z = solver.sample_independent(g, p)
        torch.cuda.synchronize()
        assert z.dtype == torch.float32
        assert not bool(z[1::4].any()) and bool(z[2::4].all()) and not bool(z[3::4].any())


MOE_CFG = dict(name="moe-cuda", family="moe", n_layers=2, d_model=256, n_heads=2, n_kv=2,
               d_ff=256, vocab=512, n_experts=4, top_k=2)


@pytest.mark.parametrize("backend", ["pallas", "onepass", "stale"])
def test_cuda_moe_step_launches_per_expert_site(cuda, backend):
    """One sketched step of a 2-layer MoE LM (4 experts, top-2, 128-wide
    blocks): every sketched site launches its backend's kernels once, 4
    attention + 3 x 4 expert sites per layer, the experts no token chose
    included; at budget 0.999 every gradient equals exact backprop's (rtol
    2e-4: float32 reorderings through 2 layers, as chip_smoke's GRAD_RTOL)."""
    from repro_torch.api import Runtime, SketchConfig, SketchPolicy
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import lm
    from repro_torch.nn.common import Ctx
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_leaves

    cfg = ArchConfig(**MOE_CFG)
    kernels = {"pallas": ("col_l1_scores", "block_gather_matmul_fused"),
               "onepass": ("block_stream_matmul_fused",),
               "stale": ("block_gather_matmul_fused",)}[backend]
    per_step = cfg.n_layers * (4 + 3 * cfg.n_experts)
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks.to(cuda), "labels": toks.to(cuda)}
    params = lm.init_params(0, cfg, device=cuda)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def grads(policy):
        ctx = Ctx(policy=policy, key=3 if policy else None, n_layers=cfg.n_layers)
        loss, _ = lm.lm_loss(params, batch, ctx, cfg, 3 if policy else None)
        return torch.autograd.grad(loss, leaves)

    def policy(budget):
        return SketchPolicy(base=SketchConfig(method="l1", budget=budget, backend=backend,
                                              block=128))

    exact = grads(None)
    ops.reset_launch_counts()
    full = grads(policy(0.999))
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == dict.fromkeys(kernels,
                                                                                 per_step)
    for a, b in zip(full, exact):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4 * float(b.abs().max()) + 1e-30)
    rt = Runtime(policy=policy(0.5), device=cuda)
    opt = sgd(0.1)
    state = rt.init_state(0, cfg, opt)
    ops.reset_launch_counts()
    state, m = rt.train_step(cfg, opt)(state, batch, 1)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == dict.fromkeys(kernels,
                                                                                 per_step)
    assert all(math.isfinite(float(m[k])) for k in ("loss", "aux", "grad_norm"))


def test_cuda_mamba_block_gradients_are_finite_at_chunk_256(cuda):
    """A Mamba block at the full configs' chunk of 256 over 512 tokens with
    ``mamba_init``'s dt_bias: every gradient finite (JAX's SSD chunk gives
    NaN dt gradients here, ROADMAP Queue 3 item 8), and the chunked output
    within 3e-5 of its largest magnitude of a token-by-token
    ``mamba_decode`` run (float32; the cumulative log decay reaches ~-540
    within a chunk)."""
    from repro_torch import rng
    from repro_torch.nn import ssm
    from repro_torch.nn.common import Ctx
    from repro_torch.tree import tree_leaves

    cfg = ssm.MambaCfg(d_model=256, chunk=256)
    params = ssm.mamba_init(rng.generator(0, cuda), cfg, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    x = torch.randn((2, 512, 256), generator=g, device=cuda, requires_grad=True)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    y = ssm.mamba_block(params, x, Ctx(), cfg)
    grads = torch.autograd.grad((y * y).sum(), [x] + leaves)
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    with torch.no_grad():
        state = ssm.mamba_state_init(2, cfg, torch.float32, cuda)
        steps = []
        for t in range(512):
            o, state = ssm.mamba_decode(params, x[:, t:t + 1], Ctx(), cfg, state)
            steps.append(o)
    _close(y.detach(), torch.cat(steps, dim=1), 3e-5)


# seamless-m4t-large-v2's prefill: the encoder's self-attention (768 source
# frames, no causal mask) and the decoder's cross-attention (512 target
# queries over the 768 frames, no causal mask), 16 heads of 64; and the
# cross shape the other way round (more queries than keys)
@pytest.mark.parametrize("B,Sq,Skv", [(4, 768, 768), (4, 512, 768), (2, 768, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_non_causal_at_the_encoder_and_cross_shapes(cuda, B, Sq, Skv,
                                                                         dtype):
    """Against the plain version without the causal mask, Sq and Skv as the
    audio family's prefill gives them; one launch counted; the same bits on
    a second call."""
    q, k, v = _qkv(cuda, B, Sq, Skv, 16, 16, 64, dtype, seed=Sq + Skv)
    before = flash.flash_attention.launches
    got = flash.flash_attention(q, k, v, causal=False)
    assert flash.flash_attention.launches == before + 1
    want = flash.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.shape == (B, Sq, 16, 64)
    _close(got, want, TOL[dtype])
    assert torch.equal(got, flash.flash_attention(q, k, v, causal=False))


@pytest.mark.parametrize("backend", ["pallas", "onepass", "stale"])
def test_cuda_vlm_step_launches_per_site(cuda, backend):
    """One sketched step of qwen2-vl-2b's smoke config widened to 128-wide
    blocks (2 layers, d 256, GQA 4:2 of 64, d_ff 512; M-RoPE, float embeds
    and grid positions [3, B, S]): every sketched site (7 per layer)
    launches its backend's kernels once; at
    budget 0.999 every gradient equals exact backprop's (rtol 2e-4, as
    chip_smoke's GRAD_RTOL); an accum-2 step, whose split takes the
    positions on axis 1, launches twice as many."""
    from repro_torch.api import ExecutionConfig, Runtime, SketchConfig, SketchPolicy
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import lm
    from repro_torch.nn.common import Ctx
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_leaves

    cfg = smoke_config("qwen2_vl_2b").replace(d_model=256, n_heads=4, n_kv=2, d_ff=512)
    kernels = {"pallas": ("col_l1_scores", "block_gather_matmul_fused"),
               "onepass": ("block_stream_matmul_fused",),
               "stale": ("block_gather_matmul_fused",)}[backend]
    per_step = cfg.n_layers * 7
    gen = torch.Generator().manual_seed(0)
    B, S, grid = 4, 64, 4
    pos = torch.cat([torch.stack([torch.zeros(grid * grid, dtype=torch.long),
                                  torch.arange(grid * grid) // grid,
                                  torch.arange(grid * grid) % grid]),
                     (grid + torch.arange(S - grid * grid)).expand(3, -1)], dim=1)
    batch = {"embeds": (torch.randn(B, S, cfg.d_model, generator=gen) * 0.02).to(cuda),
             "positions": pos[:, None].expand(3, B, S).to(cuda),
             "labels": torch.randint(0, cfg.vocab, (B, S), generator=gen).to(cuda)}
    params = lm.init_params(0, cfg, device=cuda)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def grads(policy):
        ctx = Ctx(policy=policy, key=3 if policy else None, n_layers=cfg.n_layers)
        loss, _ = lm.lm_loss(params, batch, ctx, cfg, 3 if policy else None)
        return torch.autograd.grad(loss, leaves[1:])  # the embedding table is unused

    def policy(budget):
        return SketchPolicy(base=SketchConfig(method="l1", budget=budget, backend=backend,
                                              block=128))

    exact = grads(None)
    ops.reset_launch_counts()
    full = grads(policy(0.999))
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == dict.fromkeys(kernels,
                                                                                 per_step)
    for a, b in zip(full, exact):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4 * float(b.abs().max()) + 1e-30)
    for accum in (1, 2):
        rt = Runtime(policy=policy(0.5), execution=ExecutionConfig(accum=accum), device=cuda)
        opt = sgd(0.1)
        state = rt.init_state(0, cfg, opt)
        ops.reset_launch_counts()
        state, m = rt.train_step(cfg, opt)(state, batch, 1)
        torch.cuda.synchronize()
        assert {k: v for k, v in ops.launch_counts().items() if v} == dict.fromkeys(
            kernels, accum * per_step)
        assert all(math.isfinite(float(m[k])) for k in ("loss", "grad_norm"))


# the serving engines over every decoder family's smoke config
# (tests/test_torch_engine_families.py runs them against JAX's on the CPU)
FAMILY_ARCHS = ("olmoe_1b_7b", "mixtral_8x22b", "gemma3_1b", "rwkv6_3b", "zamba2_7b",
                "qwen2_vl_2b")


def _sequential_tokens(params, cfg, specs, device, max_len=64):
    """The port's sequential decoding of each (prompt, max_new): prefill at
    the exact prompt length, then greedy decode steps at batch 1."""
    from repro_torch.api import Runtime
    from repro_torch.serve import greedy_sample

    rt = Runtime(device=device)
    prefill, decode = rt.prefill_step(cfg, max_len), rt.decode_step(cfg)
    out = []
    for p, m in specs:
        logits, caches = prefill(params, {"tokens": p[None]})
        cur, toks = greedy_sample(logits[:, -1:]), []
        for t in range(m):
            toks.append(cur)
            if t + 1 < m:
                logits, caches = decode(params, caches, cur, len(p) + t)
                cur = greedy_sample(logits)
        out.append(torch.cat(toks, dim=1)[0].tolist())
    return out


def _serve_all(params, cfg, specs, device, max_len=64):
    """Greedy tokens of the paged, contiguous and run-to-completion engines
    (2 slots), with the launch counts set to 0 before each run: every one
    must stay 0."""
    from repro_torch.api import Runtime, ServeConfig
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.legacy import RunToCompletionEngine

    rt = Runtime(device=device)
    runs = {}
    for label, eng in (
            ("paged", Engine(params, cfg, serve=ServeConfig(n_slots=2, max_len=max_len),
                             runtime=rt)),
            ("contiguous", Engine(params, cfg, serve=ServeConfig(n_slots=2, max_len=max_len,
                                                                 page_size=None), runtime=rt)),
            ("run-to-completion", RunToCompletionEngine(params, cfg, batch=2, max_len=max_len,
                                                        runtime=rt))):
        reqs = [Request(prompt=p.copy(), max_new=m) for p, m in specs]
        ops.reset_launch_counts()
        eng.run(reqs)
        torch.cuda.synchronize()
        assert all(n == 0 for n in ops.launch_counts().values()), (label, ops.launch_counts())
        runs[label] = [r.out.tolist() for r in reqs]
    return runs


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cuda_family_engines_equal_sequential_decoding(cuda, arch):
    """On the card, each family's smoke config (``attn_impl="pallas"``)
    through the paged (where its layout allows), contiguous and
    run-to-completion engines: every request's greedy tokens equal the
    port's sequential decoding (plain attention), and no kernel is launched
    (every prefill carries segments; decode runs the plain attention)."""
    import numpy as np

    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import lm

    cfg = smoke_config(arch).replace(attn_impl="pallas")
    params = lm.init_params(0, cfg, device=cuda)
    rng = np.random.default_rng(0)
    specs = [(rng.integers(1, cfg.vocab, size=n).astype(np.int32), m)
             for n, m in zip((11, 5, 23, 3, 17), (6, 3, 9, 2, 12))]
    want = _sequential_tokens(params, cfg.replace(attn_impl="chunked"), specs, cuda)
    for label, got in _serve_all(params, cfg, specs, cuda).items():
        assert got == want, label


def test_cuda_gemma3_ring_prefill_from_padded_rows(cuda):
    """gemma3's 16-slot rings on the card, at prompts whose bucket padding
    exceeds the window (40 tokens in a bucket of 64: 24 pads) or wraps it
    (23 in 32), and a 3-token prompt right-padded to its batch's 40: the
    ring filled from a padded row equals the exact-length prefill's within
    1e-5 of its largest magnitude, and every engine equals sequential
    decoding."""
    import numpy as np

    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import lm
    from repro_torch.nn.common import Ctx

    cfg = smoke_config("gemma3_1b")
    params = lm.init_params(1, cfg, device=cuda)
    rng = np.random.default_rng(1)
    specs = [(rng.integers(1, cfg.vocab, size=n).astype(np.int32), m)
             for n, m in zip((40, 3, 23, 9), (8, 5, 10, 4))]
    p = torch.as_tensor(specs[0][0], device=cuda).long()[None]
    toks = torch.zeros((1, 64), dtype=torch.long, device=cuda)
    segs = torch.zeros_like(toks)
    toks[0, :40], segs[0, :40] = p[0], 1
    with torch.no_grad():
        _, exact = lm.prefill(params, {"tokens": p}, Ctx(), cfg, 64)
        _, padded = lm.prefill(params, {"tokens": toks, "segments": segs}, Ctx(), cfg, 64)
    rings = [i for i, k in enumerate(lm.layer_kinds(cfg)) if k.window]
    assert rings
    for i in rings:
        for name in ("k", "v"):
            assert padded[i][name].shape[1] == cfg.window
            _close(padded[i][name], exact[i][name], 1e-5)
    want = _sequential_tokens(params, cfg, specs, cuda)
    for label, got in _serve_all(params, cfg, specs, cuda).items():
        assert got == want, label


# -- the distributed runtime on a one-rank NCCL mesh -----------------------------


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL process group (file:// store) and the (1, 1) mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cuda")
    finally:
        dist.destroy_process_group()


def _dist_arch():
    from repro_torch.configs.base import ArchConfig

    # block-128 sites at a small width: q/k/v/o 256, d_ff 512 (2 and 4 blocks)
    return ArchConfig(name="t", family="dense", n_layers=2, d_model=256, n_heads=4, n_kv=4,
                      d_ff=512, vocab=512, q_chunk=64, kv_chunk=64)


def _dist_step(cuda, execution, policy):
    import numpy as np

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = _dist_arch()
    opt = adamw(1e-3)
    params = lm.init_params(3, cfg, device=cuda)
    st = init_state(0, cfg, opt, params=params, device=cuda, execution=execution)
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (4, 128))
    batch = {"tokens": toks, "labels": toks}
    if execution is not None and execution.mesh is not None:
        batch = shard_batch(batch, mesh=execution.mesh)
    ops.reset_launch_counts()
    st, m = make_train_step(cfg, opt, policy, execution=execution, device=cuda)(st, batch, 5)
    torch.cuda.synchronize()
    return st, m, ops.launch_counts()


def _slice_policy():
    from repro_torch.api import SketchConfig, SketchPolicy

    return SketchPolicy(base=SketchConfig(method="l1", budget=0.2, backend="pallas", block=128))


def test_cuda_one_rank_mesh_step_equals_single_device(nccl_mesh, cuda):
    """tp_sketch off on the (1, 1) NCCL mesh: the step is bit for bit the
    single-device step (loss, grad norm, every parameter and moment), with
    the same launches (one score and one fused per sketched site)."""
    from repro_torch.api import ExecutionConfig
    from repro_torch.tree import tree_leaves

    s1, m1, c1 = _dist_step(cuda, None, _slice_policy())
    s2, m2, c2 = _dist_step(cuda, ExecutionConfig(mesh=nccl_mesh), _slice_policy())
    n_sites = 7 * _dist_arch().n_layers
    assert c1 == c2 and c2["col_l1_scores"] == n_sites
    assert c2["block_gather_matmul_fused"] == n_sites
    assert torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["grad_norm"], m2["grad_norm"])
    for a, b in zip(tree_leaves((s1.params, s1.opt_state)), tree_leaves((s2.params,
                                                                        s2.opt_state))):
        assert torch.equal(a, b)


def test_cuda_tp_plans_launch_scores_only(nccl_mesh, cuda):
    """tp_sketch on: every sketched site takes a TP plan, which runs the
    score kernel once and no fused kernel (the body gathers and multiplies,
    as JAX's); the loss is the exact step's (rel 1e-5)."""
    from repro_torch.api import ExecutionConfig

    _, m_exact, _ = _dist_step(cuda, None, None)
    _, m, c = _dist_step(cuda, ExecutionConfig(mesh=nccl_mesh, tp_sketch=True), _slice_policy())
    n_sites = 7 * _dist_arch().n_layers
    assert c["col_l1_scores"] == n_sites
    assert all(v == 0 for k, v in c.items() if k != "col_l1_scores"), c
    rel = abs(float(m["loss"]) - float(m_exact["loss"])) / abs(float(m_exact["loss"]))
    assert rel < 1e-5 and math.isfinite(float(m["grad_norm"]))


def _mesh_serve(cuda, cfg, params, runtime, prompts, steps=4):
    """Prefill and ``steps`` greedy decode steps through ``runtime``:
    (logits of every call, tokens fed, launches of the prefill, of decode)."""
    from repro_torch.serve import greedy_sample

    B, S = prompts.shape
    ops.reset_launch_counts()
    logits, caches = runtime.prefill_step(cfg, S + steps)(params, {"tokens": prompts})
    torch.cuda.synchronize()
    pre = ops.launch_counts()
    ops.reset_launch_counts()
    outs, fed = [logits], []
    cur = greedy_sample(logits[:, -1:])
    for i in range(steps):
        fed.append(cur)
        logits, caches = runtime.decode_step(cfg)(params, caches, cur, S + i)
        outs.append(logits)
        cur = greedy_sample(logits)
    torch.cuda.synchronize()
    return outs, fed, pre, ops.launch_counts()


def test_cuda_one_rank_mesh_serving_equals_single_device(nccl_mesh, cuda):
    """chip_smoke phase 20 (a) at a small width: ``attn_impl="pallas"``
    prefill and decode under the (1, 1) NCCL mesh launch one flash kernel
    per layer in the prefill and none in decode, and give the single
    device's logits and tokens bit for bit."""
    import numpy as np

    from repro_torch.api import ExecutionConfig, Runtime
    from repro_torch.launch.sharding import shard_params
    from repro_torch.models import lm

    cfg = _dist_arch().replace(attn_impl="pallas")
    params = lm.init_params(3, cfg, device=cuda)
    prompts = np.random.RandomState(1).randint(0, cfg.vocab, (4, 96))
    single = _mesh_serve(cuda, cfg, params, Runtime(device=cuda), prompts)
    meshed = _mesh_serve(cuda, cfg, shard_params(params, nccl_mesh),
                         Runtime(device=cuda, execution=ExecutionConfig(mesh=nccl_mesh)), prompts)
    assert meshed[2]["flash_attention"] == cfg.n_layers == single[2]["flash_attention"]
    assert sum(meshed[2].values()) == cfg.n_layers and not any(meshed[3].values())
    for a, b in zip(meshed[0] + meshed[1], single[0] + single[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["gemma3_1b", "zamba2_7b"])
def test_cuda_one_rank_mesh_engine_equals_single_device(nccl_mesh, cuda, arch):
    """chip_smoke phase 20 (c) at smoke size: the contiguous engine under the
    (1, 1) NCCL mesh (gemma3's rings, zamba2's recurrent states) emits the
    single-device engine's tokens and launches no kernel."""
    import numpy as np

    from repro_torch.api import ExecutionConfig, Runtime, ServeConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request

    cfg = smoke_config(arch).replace(attn_impl="pallas")
    params = lm.init_params(3, cfg, device=cuda)
    rng = np.random.default_rng(2)
    specs = [(rng.integers(1, cfg.vocab, size=n).astype(np.int32), m)
             for n, m in ((11, 5), (23, 3), (7, 8), (17, 6))]
    sv = ServeConfig(n_slots=2, max_len=64, page_size=None)
    got = []
    for rt in (Runtime(device=cuda),
               Runtime(device=cuda, execution=ExecutionConfig(mesh=nccl_mesh))):
        reqs = [Request(prompt=p.copy(), max_new=m) for p, m in specs]
        ops.reset_launch_counts()
        rt.serve(params, cfg, serve=sv).run(reqs)
        assert not any(ops.launch_counts().values())
        got.append([r.out.tolist() for r in reqs])
    assert got[0] == got[1]


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "zamba2_7b"])
def test_cuda_one_rank_mesh_family_step_equals_single_device(nccl_mesh, cuda, arch):
    """chip_smoke phase 19 (a) at smoke size: the MoE layer's expert-parallel
    body (every expert on the one model rank) and the Mamba2 blocks with the
    shared attention block, tp_sketch off, l1@0.2 block-64 ``pallas``: the
    one-rank mesh step is bit for bit the single-device step (loss, grad
    norm, every parameter and moment) with the same launches, one score and
    one fused per sketched site (olmoe 2 x (4 + 3 x 8), zamba2 7 x 3 + 2 x 7)."""
    import numpy as np

    from repro_torch.api import ExecutionConfig, SketchConfig, SketchPolicy
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.tree import tree_leaves

    widen, n_want = ANALYSIS_SMOKE[arch]
    cfg = smoke_config(arch).replace(**widen)
    pol = SketchPolicy(base=SketchConfig(method="l1", budget=0.2, backend="pallas", block=64))
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (4, 64))
    out = []
    for ex in (None, ExecutionConfig(mesh=nccl_mesh)):
        opt = adamw(1e-3)
        st = init_state(0, cfg, opt, params=lm.init_params(3, cfg, device=cuda), device=cuda,
                        execution=ex)
        batch = {"tokens": toks, "labels": toks}
        if ex is not None:
            batch = shard_batch(batch, mesh=nccl_mesh)
        ops.reset_launch_counts()
        st, m = make_train_step(cfg, opt, pol, execution=ex, device=cuda)(st, batch, 5)
        torch.cuda.synchronize()
        out.append((st, m, ops.launch_counts()))
    (s1, m1, c1), (s2, m2, c2) = out
    assert c1 == c2 and c2["col_l1_scores"] == n_want == c2["block_gather_matmul_fused"], c2
    assert torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["grad_norm"], m2["grad_norm"])
    for a, b in zip(tree_leaves((s1.params, s1.opt_state)), tree_leaves((s2.params,
                                                                        s2.opt_state))):
        assert torch.equal(a, b)


# smoke configs widened where a sketched site is narrower than one 64-wide
# block, so that every sketched site is block-granular and launches both
# pallas kernels; zamba2's shared block runs twice (7 layers, every 3)
ANALYSIS_SMOKE = {"llama3_405b": (dict(n_kv=8), 2 * 7),
                  "olmoe_1b_7b": (dict(d_ff=64), 2 * (4 + 3 * 8)),
                  "zamba2_7b": ({}, 7 * 3 + 7 * 2)}


@pytest.mark.parametrize("arch", sorted(ANALYSIS_SMOKE))
def test_cuda_analyzer_counts_the_sites_that_launch(cuda, arch):
    """chip_smoke phase 18 (c) at smoke size: ``analyze_runtime`` on the card
    under an l1@0.2 block-64 ``pallas`` policy passes the baseline gate, and
    one forward and backward launches the score and fused kernels exactly
    once per sketched site application the analyzer counts in its graph."""
    from repro_torch.analysis import analyze_runtime, check_baseline
    from repro_torch.api import Runtime, SketchConfig, SketchPolicy
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    widen, n_want = ANALYSIS_SMOKE[arch]
    cfg = smoke_config(arch).replace(**widen)
    rt = Runtime(policy=SketchPolicy(base=SketchConfig(method="l1", budget=0.2,
                                                       backend="pallas", block=64)),
                 device=cuda)
    params = lm.init_params(0, cfg, device=cuda)
    rep = analyze_runtime(rt, cfg, device=cuda, params=params)
    assert check_baseline(rep).ok
    assert rep.applications == n_want
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    toks = torch.arange(64, device=cuda).reshape(1, 64) % cfg.vocab
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    ops.reset_launch_counts()
    loss = lm.lm_loss(params, batch, rt.ctx(key=1, n_layers=cfg.n_layers), cfg, 1)[0]
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"col_l1_scores": n_want, "block_gather_matmul_fused": n_want}
    assert all(torch.isfinite(g).all() for g in grads)
