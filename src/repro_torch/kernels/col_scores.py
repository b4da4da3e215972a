"""Triton kernel: fp32 column score reduction (ℓ1 / ℓ2²) over G on Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/col_scores.py::col_l1_scores``.
It reads G ([N, n], f32 or bf16) once and writes an [n] f32 vector: two
operations per element against four (or two) bytes read, so it is bound by
device-memory bytes on an H100 (3.35 TB/s). The design splits N across
programs so that enough of them are in flight to stream G at full rate; each
program reduces a strip of rows for one block of columns into a partial row,
and a second small kernel sums the partial rows in a fixed order. No float
atomics: the same G always gives bit-identical scores, hence the same plan.
bf16 input is widened to fp32 before it is accumulated.

``triton`` is imported inside the launching function, so this module imports
on machines without it; the CPU path uses the plain version.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.ref import COL_SCORE_MODES
from repro_torch.kernels.ref import col_scores_ref as col_l1_scores_plain

__all__ = ["col_l1_scores", "col_l1_scores_plain"]

_BLOCK_C = 128  # columns per program
_BLOCK_N = 32  # rows per inner step
_ROWS_PER_SPLIT = 128  # rows per program (a multiple of _BLOCK_N)


@functools.lru_cache(maxsize=None)
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def partial_kernel(g_ptr, part_ptr, N, n, rows_per_split,
                       L2: tl.constexpr, BLOCK_N: tl.constexpr,
                       BLOCK_C: tl.constexpr):
        pid_c = tl.program_id(0)
        pid_s = tl.program_id(1)
        cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < n
        row0 = pid_s * rows_per_split
        acc = tl.zeros([BLOCK_C], dtype=tl.float32)
        for r in range(0, rows_per_split, BLOCK_N):
            rows = row0 + r + tl.arange(0, BLOCK_N)
            m = (rows[:, None] < N) & cmask[None, :]
            g = tl.load(g_ptr + rows[:, None].to(tl.int64) * n + cols[None, :],
                        mask=m, other=0.0).to(tl.float32)
            if L2:
                v = g * g
            else:
                v = tl.abs(g)
            acc += tl.sum(v, axis=0)
        tl.store(part_ptr + pid_s * n + cols, acc, mask=cmask)

    @triton.jit
    def finish_kernel(part_ptr, out_ptr, n, n_split, BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < n
        acc = tl.zeros([BLOCK_C], dtype=tl.float32)
        for s in range(0, n_split):  # fixed order: deterministic
            acc += tl.load(part_ptr + s * n + cols, mask=cmask, other=0.0)
        tl.store(out_ptr + cols, acc, mask=cmask)

    return triton, partial_kernel, finish_kernel


def col_l1_scores(G: torch.Tensor, *, mode: str = "l1") -> torch.Tensor:
    """Launch the score kernel on a CUDA tensor: G [N, n] -> [n] f32.

    Raises on anything the kernel does not take (a CPU tensor, another dtype,
    a non-contiguous or non-2-D G). Adds one to ``col_l1_scores.launches``.
    """
    if mode not in COL_SCORE_MODES:
        raise ValueError(f"unknown score mode {mode!r}; expected one of {sorted(COL_SCORE_MODES)}")
    if G.device.type != "cuda":
        raise ValueError(f"col_l1_scores kernel needs a CUDA tensor, got {G.device}")
    if G.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"col_l1_scores kernel takes float32 or bfloat16, got {G.dtype}")
    if G.dim() != 2 or not G.is_contiguous():
        raise ValueError("col_l1_scores kernel needs a contiguous 2-D G")
    N, n = G.shape
    if N == 0 or n == 0:
        raise ValueError(f"col_l1_scores kernel needs a non-empty G, got {tuple(G.shape)}")
    triton, partial_kernel, finish_kernel = _kernels()
    n_split = triton.cdiv(N, _ROWS_PER_SPLIT)
    part = torch.empty((n_split, n), dtype=torch.float32, device=G.device)
    out = torch.empty((n,), dtype=torch.float32, device=G.device)
    n_cblk = triton.cdiv(n, _BLOCK_C)
    partial_kernel[(n_cblk, n_split)](G, part, N, n, _ROWS_PER_SPLIT,
                                      L2=(mode == "l2"), BLOCK_N=_BLOCK_N,
                                      BLOCK_C=_BLOCK_C, num_warps=4)
    finish_kernel[(n_cblk,)](part, out, n, n_split, BLOCK_C=_BLOCK_C, num_warps=4)
    col_l1_scores.launches += 1
    return out


col_l1_scores.launches = 0
