"""CUDA kernels for the block-sketched backward on Hopper.

Replace the Pallas TPU kernels of ``repro/kernels/sketch_matmul.py``:

* ``block_gather_matmul_fused``: from G's kept column blocks, dX, the compact
  dW and the compact db (and the kept blocks' raw column scores on request)
  in one launch;
* ``block_gather_matmul`` and ``block_gather_matmul_dw``: the unfused dX and
  the unfused compact dW, each one block role of the fused launch alone;
* ``block_stream_matmul_fused``: the fused outputs plus the raw column scores
  of EVERY column of G, kept or dropped, in one launch (the ``onepass``
  estimator's backward).

The sources are ``csrc/block_gather_matmul_fused.cu`` (the first three, by a
role mask) and ``csrc/block_stream_matmul_fused.cu``, built by
``kernels/build.py`` for ``sm_90a`` and bound with ``ctypes``. Both run the one
copy of the pipelined dW and dX block roles in ``csrc/block_roles.cuh``
(32 x 32 dW tiles first in the grid, 64 x 32 dX tiles, a ``cp.async`` ring),
so all four compute dX, dWc, db and the kept scores with the same code in the
same order and agree bit for bit for the same keeps; the fused launch may pick
shorter stages in a deeper ring, which changes no bits. At the path's
shapes they are bound by float32 operations (67 TFLOP/s outside the tensor
cores on an H100 SXM). The sources say how the block roles replace the TPU
kernels' resident accumulators, and how many times each reads G.

Each wrapper takes CUDA tensors only; the CPU path (``kernels/ops.py``) uses
the plain versions, which this module names ``*_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    block_gather_matmul_dw_ref as block_gather_matmul_dw_plain,
    block_gather_matmul_fused_ref as block_gather_matmul_fused_plain,
    block_gather_matmul_ref as block_gather_matmul_plain,
    block_stream_matmul_onepass_ref as block_stream_matmul_fused_plain)

__all__ = ["block_gather_matmul_fused", "block_gather_matmul_fused_plain",
           "block_gather_matmul", "block_gather_matmul_plain",
           "block_gather_matmul_dw", "block_gather_matmul_dw_plain",
           "block_stream_matmul_fused", "block_stream_matmul_fused_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"l1": 0, "l2": 1}
_ROLE_DX, _ROLE_DW = 1, 2


def _fn(source: str, symbol: str, lead_ints: int):
    """The C launcher ``symbol``: ``lead_ints`` ints, nine pointers, six ints
    and the stream."""
    fn = getattr(build.load_library(source), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * lead_ints + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return fn


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_plan(G, block_idx, scales, block, score_mode="l1"):
    """Shared checks; returns (N, n, rb)."""
    if G.dtype not in _DTYPES:
        raise ValueError(f"G must be float32 or bfloat16, got {G.dtype}")
    if score_mode not in _MODES:
        raise ValueError(f"unknown score mode {score_mode!r}")
    if G.dim() != 2 or block_idx.dim() != 1:
        raise ValueError("G must be 2-D and block_idx 1-D")
    N, n = G.shape
    rb = block_idx.shape[0]
    if block <= 0 or block % 64 != 0 or n % block != 0:
        raise ValueError(f"block must be a positive multiple of 64 dividing n={n}, got {block}")
    if N == 0 or rb == 0:
        raise ValueError("the block-sketched kernels need N and rb > 0")
    _check("G", G, G.dtype, (N, n))
    _check("block_idx", block_idx, torch.int32, (rb,))
    _check("scales", scales, torch.float32, (rb,))
    return N, n, rb


def _operand(name, t, G, rows):
    if t.dim() != 2 or t.shape[1] == 0:
        raise ValueError(f"{name} must be 2-D with d > 0")
    _check(name, t, G.dtype, (rows, t.shape[1]))
    return t.shape[1]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_bgm(name, role_mask, G, block_idx, scales, W, X, dX, dWc, db, sc, *, block,
                score_mode):
    N, n, rb = G.shape[0], G.shape[1], block_idx.shape[0]
    d = (W if W is not None else X).shape[1]
    stream = torch.cuda.current_stream(G.device).cuda_stream
    with torch.cuda.device(G.device):
        err = _fn("block_gather_matmul_fused", "bgm_launch", 2)(
            role_mask, _DTYPES[G.dtype], G.data_ptr(), block_idx.data_ptr(),
            scales.data_ptr(), _ptr(W), _ptr(X), _ptr(dX), _ptr(dWc), _ptr(db), _ptr(sc),
            N, n, d, rb, block, _MODES[score_mode], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def block_gather_matmul_fused(G, block_idx, scales, W, X, *, block: int = 128,
                              with_scores: bool = False, score_mode: str = "l1"):
    """Launch the fused backward on CUDA tensors.

    G [N, n], W [n, d], X [N, d] (float32 or bfloat16, all one dtype);
    block_idx [rb] int32 kept block ids in [0, n // block); scales [rb]
    float32. Returns (dX [N, d], dWc [rb, block, d], db_c [rb, block] f32)
    plus the kept raw scores [rb, block] f32 with ``with_scores``. Raises on
    anything the kernel does not take. Adds one to
    ``block_gather_matmul_fused.launches``.
    """
    N, n, rb = _check_plan(G, block_idx, scales, block, score_mode)
    d = _operand("X", X, G, N)
    _check("W", W, G.dtype, (n, d))
    dX = torch.empty((N, d), dtype=G.dtype, device=G.device)
    dWc = torch.empty((rb, block, d), dtype=G.dtype, device=G.device)
    db = torch.empty((rb, block), dtype=torch.float32, device=G.device)
    sc = (torch.empty((rb, block), dtype=torch.float32, device=G.device)
          if with_scores else None)
    _launch_bgm("block_gather_matmul_fused", _ROLE_DX | _ROLE_DW, G, block_idx, scales, W,
                X, dX, dWc, db, sc, block=block, score_mode=score_mode)
    block_gather_matmul_fused.launches += 1
    return (dX, dWc, db, sc) if with_scores else (dX, dWc, db)


def block_gather_matmul(G, block_idx, scales, W, *, block: int = 128):
    """Launch the unfused dX on CUDA tensors: dX [N, d] = Σ_k s_k G[:, blk_k]
    W[blk_k, :], bit-identical to the fused kernel's dX. Adds one to
    ``block_gather_matmul.launches``."""
    N, n, _ = _check_plan(G, block_idx, scales, block)
    d = _operand("W", W, G, n)
    dX = torch.empty((N, d), dtype=G.dtype, device=G.device)
    _launch_bgm("block_gather_matmul", _ROLE_DX, G, block_idx, scales, W, None, dX, None,
                None, None, block=block, score_mode="l1")
    block_gather_matmul.launches += 1
    return dX


def block_gather_matmul_dw(G, block_idx, scales, X, *, block: int = 128):
    """Launch the unfused compact dW on CUDA tensors: dWc [rb, block, d] with
    dWc[k] = s_k G[:, blk_k]ᵀ X, bit-identical to the fused kernel's dWc. Adds
    one to ``block_gather_matmul_dw.launches``."""
    N, _, rb = _check_plan(G, block_idx, scales, block)
    d = _operand("X", X, G, N)
    dWc = torch.empty((rb, block, d), dtype=G.dtype, device=G.device)
    _launch_bgm("block_gather_matmul_dw", _ROLE_DW, G, block_idx, scales, None, X, None, dWc,
                None, None, block=block, score_mode="l1")
    block_gather_matmul_dw.launches += 1
    return dWc


def block_stream_matmul_fused(G, block_idx, scales, W, X, *, block: int = 128,
                              score_mode: str = "l1"):
    """Launch the streaming one-pass backward on CUDA tensors.

    The inputs are those of :func:`block_gather_matmul_fused`, with distinct
    kept block ids. Returns (dX [N, d], dWc [rb, block, d], db_c [rb, block]
    f32, scores [n] f32): the first three bit-identical to the fused kernel's
    for the same keeps, the last the raw column reduction (Σ|G| for "l1",
    ΣG² for "l2") of every column of G. Adds one to
    ``block_stream_matmul_fused.launches``.
    """
    N, n, rb = _check_plan(G, block_idx, scales, block, score_mode)
    if rb > n // block:
        raise ValueError(f"{rb} kept blocks of {n // block}")
    d = _operand("X", X, G, N)
    _check("W", W, G.dtype, (n, d))
    dX = torch.empty((N, d), dtype=G.dtype, device=G.device)
    dWc = torch.empty((rb, block, d), dtype=G.dtype, device=G.device)
    db = torch.empty((rb, block), dtype=torch.float32, device=G.device)
    scores = torch.empty((n,), dtype=torch.float32, device=G.device)
    stream = torch.cuda.current_stream(G.device).cuda_stream
    with torch.cuda.device(G.device):
        err = _fn("block_stream_matmul_fused", "bsm_stream_launch", 1)(
            _DTYPES[G.dtype], G.data_ptr(), block_idx.data_ptr(), scales.data_ptr(),
            W.data_ptr(), X.data_ptr(), dX.data_ptr(), dWc.data_ptr(), db.data_ptr(),
            scores.data_ptr(), N, n, d, rb, block, _MODES[score_mode], stream)
    if err != 0:
        raise RuntimeError(f"block_stream_matmul_fused launch failed: CUDA error {err}")
    block_stream_matmul_fused.launches += 1
    return dX, dWc, db, scores


block_gather_matmul_fused.launches = 0
block_gather_matmul.launches = 0
block_gather_matmul_dw.launches = 0
block_stream_matmul_fused.launches = 0
