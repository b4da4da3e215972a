"""Plain PyTorch versions of the kernels (the allclose oracles).

Port of ``repro/kernels/ref.py`` for what this package's path needs. A CPU
tensor runs these through ``kernels/ops.py``; on the card they exist only to
hold the hand-written kernels against (tests and ``chip_smoke.py``).
"""
from __future__ import annotations

import torch

__all__ = ["COL_SCORE_MODES", "col_scores_ref", "col_l1_scores_ref",
           "block_gather_matmul_ref", "block_gather_matmul_dw_ref",
           "block_gather_matmul_fused_ref", "gather_cols_matmul_ref",
           "gather_cols_matmul_dw_ref"]

# The one table mapping a score mode to its elementwise column reduction.
COL_SCORE_MODES = {"l1": torch.abs, "l2": torch.square}


def _gathered_blocks(G, block_idx, scales, block):
    """(scaled f32 kept blocks [N, rb, block], per-column indices [rb*block])."""
    N, n = G.shape
    Gb = G.reshape(N, n // block, block)
    Gc = Gb[:, block_idx].to(torch.float32) * scales.to(torch.float32)[None, :, None]
    cols = (block_idx[:, None] * block
            + torch.arange(block, device=G.device)[None, :]).reshape(-1)
    return Gc, cols


def block_gather_matmul_ref(G, block_idx, scales, W, *, block: int):
    """dX = Σ_k scale_k · G[:, blk_k] @ W[blk_k, :]. G [N, n]; W [n, d]."""
    Gc, cols = _gathered_blocks(G, block_idx, scales, block)
    Wc = W[cols].to(torch.float32)
    return (Gc.reshape(G.shape[0], -1) @ Wc).to(G.dtype)


def block_gather_matmul_dw_ref(G, block_idx, scales, X, *, block: int):
    """dWc[k] = scale_k · G[:, blk_k]ᵀ @ X  -> [rb, block, d_in]."""
    Gc, _ = _gathered_blocks(G, block_idx, scales, block)
    return torch.einsum("nrb,nd->rbd", Gc, X.to(torch.float32)).to(G.dtype)


def block_gather_matmul_fused_ref(G, block_idx, scales, W, X, *, block: int,
                                  with_scores: bool = False,
                                  score_mode: str = "l1"):
    """Fused backward oracle: (dX, dWc, db_c) from one gather of G.

    dX [N, d] (G.dtype), dWc [rb, block, d] (G.dtype), db_c [rb, block] f32;
    with ``with_scores`` also the kept blocks' raw (pre-scale) column
    reduction [rb, block] f32 (Σ|G| for "l1", ΣG² for "l2").
    """
    rb = block_idx.shape[0]
    N = G.shape[0]
    cols = (block_idx[:, None] * block
            + torch.arange(block, device=G.device)[None, :]).reshape(-1)
    Gc0 = G[:, cols].to(torch.float32)
    Gc = Gc0 * scales.to(torch.float32).repeat_interleave(block)[None, :]
    dX = (Gc @ W[cols].to(torch.float32)).to(G.dtype)
    dWc = (Gc.T @ X.to(torch.float32).reshape(N, -1)).to(G.dtype)
    out = (dX, dWc.reshape(rb, block, -1), Gc.sum(0).reshape(rb, block))
    if with_scores:
        return out + (COL_SCORE_MODES[score_mode](Gc0).sum(0).reshape(rb, block),)
    return out


def gather_cols_matmul_ref(G, idx, scales, W):
    """Per-column compact backward dX."""
    Gc = G[:, idx] * scales[None, :].to(G.dtype)
    return (Gc.to(torch.float32) @ W[idx].to(torch.float32)).to(G.dtype)


def gather_cols_matmul_dw_ref(G, idx, scales, X):
    """Per-column compact dW rows ``[r, d_in]``."""
    Gc = G[:, idx] * scales[None, :].to(G.dtype)
    return (Gc.to(torch.float32).T @ X.to(torch.float32)).to(G.dtype)


def col_scores_ref(G, *, mode: str = "l1"):
    """fp32 column reduction: Σ_i |G[i, j]| ("l1") or Σ_i G[i, j]² ("l2")."""
    return COL_SCORE_MODES[mode](G.to(torch.float32)).sum(0)


def col_l1_scores_ref(G):
    """ℓ1 column scores in fp32: s_j = Σ_i |G[i, j]|."""
    return col_scores_ref(G, mode="l1")
