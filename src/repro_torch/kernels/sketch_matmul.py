"""CUDA kernel for the fused block-sketched backward on Hopper.

Replaces the Pallas TPU kernel
``repro/kernels/sketch_matmul.py::block_gather_matmul_fused``: from G's kept
column blocks it computes dX, the compact dW and the compact db (and the kept
blocks' raw column scores on request) in one launch. The source is
``csrc/block_gather_matmul_fused.cu`` (sm_90a), built by ``kernels/build.py``
and bound with ``ctypes``. At the path's shapes it is bound by float32
operations (67 TFLOP/s outside the tensor cores on an H100 SXM); the source
says how its two block roles replace the TPU kernel's resident accumulator,
and that they read G's kept blocks twice where the TPU kernel reads them once.

The CPU path uses the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    block_gather_matmul_fused_ref as block_gather_matmul_fused_plain)

__all__ = ["block_gather_matmul_fused", "block_gather_matmul_fused_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"l1": 0, "l2": 1}


def _lib():
    lib = build.load_library("block_gather_matmul_fused")
    fn = lib.bgm_fused_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
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
    if G.dtype not in _DTYPES:
        raise ValueError(f"G must be float32 or bfloat16, got {G.dtype}")
    if score_mode not in _MODES:
        raise ValueError(f"unknown score mode {score_mode!r}")
    if G.dim() != 2 or W.dim() != 2 or block_idx.dim() != 1:
        raise ValueError("G and W must be 2-D and block_idx 1-D")
    N, n = G.shape
    d = W.shape[1]
    rb = block_idx.shape[0]
    if block <= 0 or block % 64 != 0 or n % block != 0:
        raise ValueError(f"block must be a positive multiple of 64 dividing n={n}, got {block}")
    if N == 0 or d == 0 or rb == 0:
        raise ValueError("block_gather_matmul_fused needs N, d and rb > 0")
    _check("G", G, G.dtype, (N, n))
    _check("W", W, G.dtype, (n, d))
    _check("X", X, G.dtype, (N, d))
    _check("block_idx", block_idx, torch.int32, (rb,))
    _check("scales", scales, torch.float32, (rb,))
    dX = torch.empty((N, d), dtype=G.dtype, device=G.device)
    dWc = torch.empty((rb, block, d), dtype=G.dtype, device=G.device)
    db = torch.empty((rb, block), dtype=torch.float32, device=G.device)
    sc = (torch.empty((rb, block), dtype=torch.float32, device=G.device)
          if with_scores else None)
    stream = torch.cuda.current_stream(G.device).cuda_stream
    with torch.cuda.device(G.device):
        err = _lib()(_DTYPES[G.dtype], G.data_ptr(), block_idx.data_ptr(),
                     scales.data_ptr(), W.data_ptr(), X.data_ptr(), dX.data_ptr(),
                     dWc.data_ptr(), db.data_ptr(),
                     sc.data_ptr() if sc is not None else None,
                     N, n, d, rb, block, _MODES[score_mode], stream)
    if err != 0:
        raise RuntimeError(f"block_gather_matmul_fused launch failed: CUDA error {err}")
    block_gather_matmul_fused.launches += 1
    return (dX, dWc, db, sc) if with_scores else (dX, dWc, db)


block_gather_matmul_fused.launches = 0
