"""Plain PyTorch versions of the kernels (the allclose oracles).

Port of ``repro/kernels/ref.py`` for what this package's path needs. A CPU
tensor runs these through ``kernels/ops.py``; on the card they exist only to
hold the hand-written kernels against (tests and ``chip_smoke.py``).
"""
from __future__ import annotations

import torch

__all__ = ["COL_SCORE_MODES", "col_sum", "col_scores_ref", "col_l1_scores_ref",
           "block_gather_matmul_ref", "block_gather_matmul_dw_ref",
           "block_gather_matmul_fused_ref", "block_stream_matmul_onepass_ref",
           "gather_cols_matmul_ref", "gather_cols_matmul_dw_ref",
           "gather_cols_onepass_ref", "gather_cols_fused_scores_ref",
           "check_flash_causal", "flash_attention_ref"]

# The one table mapping a score mode to its elementwise column reduction.
COL_SCORE_MODES = {"l1": torch.abs, "l2": torch.square}


def col_sum(t: torch.Tensor) -> torch.Tensor:
    """``t.sum(0)`` of a ``[N, k]`` tensor whose every column's bits depend on
    that column alone: ATen's reduction over rows vectorizes across columns,
    so there a column's order of additions depends on where it falls in the
    width, and a shard of the kept columns (``core.sketched_linear.
    split_backward``) would sum its columns in another order than the whole
    width does. Each column is summed as a contiguous row instead."""
    return t.t().contiguous().sum(1)


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
    out = (dX, dWc.reshape(rb, block, -1), col_sum(Gc).reshape(rb, block))
    if with_scores:
        return out + (col_sum(COL_SCORE_MODES[score_mode](Gc0)).reshape(rb, block),)
    return out


def block_stream_matmul_onepass_ref(G, block_idx, scales, W, X, *, block: int,
                                    score_mode: str = "l1"):
    """Streaming one-pass backward oracle: (dX, dWc, db_c, scores). The first
    three are the fused oracle's; scores [n] f32 is the raw column reduction
    (Σ|G| for "l1", ΣG² for "l2") of every column of G, kept or dropped.

    The JAX oracle gathers all of G once through a permutation behind an
    optimization barrier, so that XLA has one reader of G; that is an XLA
    device with no meaning here, and the outputs are the same."""
    dX, dWc, db = block_gather_matmul_fused_ref(G, block_idx, scales, W, X, block=block)
    return dX, dWc, db, col_scores_ref(G, mode=score_mode)


def gather_cols_fused_scores_ref(G, idx, scales, W, X, *, score_mode: str = "l1"):
    """Per-column compact backward with the kept columns' raw scores: (dX
    [N, d], dW rows [r, d_in], db rows [r] f32, kept scores [r] f32)."""
    Gc0 = G[:, idx].to(torch.float32)
    kept = col_sum(COL_SCORE_MODES[score_mode](Gc0))
    Gc = Gc0 * scales[None, :].to(torch.float32)
    dX = (Gc @ W[idx].to(torch.float32)).to(G.dtype)
    rows = (Gc.T @ X.to(torch.float32)).to(G.dtype)
    return dX, rows, col_sum(Gc), kept


def gather_cols_onepass_ref(G, idx, scales, W, X, *, score_mode: str = "l1"):
    """Per-column one-pass backward: (dX, dW rows, db rows, scores [n] f32),
    the scores those of every column of G."""
    dX, rows, db, _ = gather_cols_fused_scores_ref(G, idx, scales, W, X,
                                                   score_mode=score_mode)
    return dX, rows, db, col_scores_ref(G, mode=score_mode)


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


def check_flash_causal(Sq: int, Skv: int, causal: bool) -> None:
    """Raise for a causal call with more queries than keys.

    The JAX package gives two answers there: its TPU kernel returns zero rows
    for the queries that see no key, its oracle the mean of V. No path of
    either package reaches the case, so the port takes neither."""
    if causal and Sq > Skv:
        raise ValueError(f"causal flash attention needs Sq <= Skv, got Sq {Sq} > Skv {Skv}")


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q: [B, Sq, H, dh]; k/v: [B, Skv, Kv, dh] (GQA: query head h reads kv
    head h // (H // Kv)) -> [B, Sq, H, dh] in q's dtype. float32 scores
    scaled by dh**-0.5 and softmax; the causal mask is right-aligned (query
    i sits at Skv - Sq + i) and the window applies only when causal."""
    B, Sq, H, dh = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    check_flash_causal(Sq, Skv, causal)
    qg = q.reshape(B, Sq, Kv, H // Kv, dh).to(torch.float32)
    s = torch.einsum("bqkgh,bckh->bkgqc", qg, k.to(torch.float32)) * dh ** -0.5
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = qpos >= kpos
        if window is not None:
            mask &= (qpos - kpos) < window
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, dh).to(q.dtype)
