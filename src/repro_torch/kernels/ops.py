"""Kernel dispatcher: CPU tensors use the plain version; CUDA tensors launch
the hand-written kernel or raise.

Port of ``repro/kernels/ops.py``. There is no fallback: a CUDA tensor never
silently takes the plain path, and a tensor on any other device raises. The
JAX dispatcher's VMEM budget (``fused_vmem_bytes`` and the one-gather XLA
fallback it selects) has no counterpart: the Hopper kernel keeps no
accumulator resident across blocks, so it has no size above which it stops
fitting. Each kernel counts its own launches (:func:`launch_counts`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import col_scores, ref as kref, sketch_matmul

__all__ = ["block_gather_matmul_fused", "col_l1_scores", "gather_cols_matmul",
           "gather_cols_matmul_dw", "launch_counts", "reset_launch_counts",
           "KERNELS"]

# name -> the wrapper that launches the kernel (and counts its launches)
KERNELS = {
    "col_l1_scores": col_scores.col_l1_scores,
    "block_gather_matmul_fused": sketch_matmul.block_gather_matmul_fused,
}


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on a CUDA device, got {devs}")


def col_l1_scores(G, *, mode: str = "l1"):
    """fp32 column scores: Σ|G| (``"l1"``) or ΣG² (``"l2"``) per column."""
    if mode not in kref.COL_SCORE_MODES:
        raise ValueError(f"unknown score mode {mode!r}; "
                         f"expected one of {sorted(kref.COL_SCORE_MODES)}")
    if _on_cpu(G):
        return kref.col_scores_ref(G, mode=mode)
    return col_scores.col_l1_scores(G.contiguous(), mode=mode)


def block_gather_matmul_fused(G, block_idx, scales, W, X, *, block: int = 128,
                              with_scores: bool = False, score_mode: str = "l1"):
    """Fused backward (dX, compact dW, compact db[, kept raw scores]); see
    ``sketch_matmul.block_gather_matmul_fused``."""
    if _on_cpu(G, block_idx, scales, W, X):
        return kref.block_gather_matmul_fused_ref(
            G, block_idx, scales, W, X, block=block,
            with_scores=with_scores, score_mode=score_mode)
    return sketch_matmul.block_gather_matmul_fused(
        G.contiguous(), block_idx.to(torch.int32).contiguous(),
        scales.to(torch.float32).contiguous(), W.contiguous(), X.contiguous(),
        block=block, with_scores=with_scores, score_mode=score_mode)


def gather_cols_matmul(G, idx, scales, W):
    """Per-column compact dX. Arbitrary column gathers have no kernel in
    either package (the JAX one leaves them to XLA): plain PyTorch on every
    device."""
    return kref.gather_cols_matmul_ref(G, idx, scales, W)


def gather_cols_matmul_dw(G, idx, scales, X):
    return kref.gather_cols_matmul_dw_ref(G, idx, scales, X)
