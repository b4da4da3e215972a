"""repro_torch kernels against their plain versions on a CUDA card.

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX (from the checkout's root):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Without a card every test skips with the reason "no CUDA device".
Tolerances: float32 outputs 1e-5 of the output's largest magnitude (the
kernel and the plain version sum in different orders); bfloat16 outputs
1e-2 of it (one bfloat16 ulp is 2^-8 of the value).
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.kernels import col_scores, ops, sketch_matmul  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


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


@pytest.mark.parametrize("shape", [(2048, 768), (100, 300), (1, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["l1", "l2"])
def test_cuda_col_l1_scores_matches_plain(cuda, shape, dtype, mode):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    G = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = col_scores.col_l1_scores.launches
    got = col_scores.col_l1_scores(G, mode=mode)
    assert col_scores.col_l1_scores.launches == before + 1
    _close(got, col_scores.col_l1_scores_plain(G, mode=mode), 1e-5)
    assert torch.equal(got, col_scores.col_l1_scores(G, mode=mode))  # deterministic


@pytest.mark.parametrize("N,n,d,rb", [(2048, 768, 768, 1), (100, 512, 80, 2), (33, 256, 130, 2)])
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
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, TOL[dtype] if i < 2 else 1e-5)


def test_cuda_dispatcher_launches_and_counts(cuda):
    G = torch.randn((64, 256), device=cuda)
    W = torch.randn((256, 32), device=cuda)
    X = torch.randn((64, 32), device=cuda)
    ops.reset_launch_counts()
    ops.col_l1_scores(G)
    ops.block_gather_matmul_fused(G, torch.tensor([1], device=cuda), torch.ones(1, device=cuda),
                                  W, X, block=128)
    assert ops.launch_counts() == {"col_l1_scores": 1, "block_gather_matmul_fused": 1}
    with pytest.raises(ValueError):
        ops.block_gather_matmul_fused(G, torch.tensor([0]), torch.ones(1), W, X, block=128)
