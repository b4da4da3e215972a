"""CUDA kernel: fp32 column score reduction (ℓ1 / ℓ2²) over G on Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/col_scores.py::col_l1_scores``.
It reads G ([N, n], f32 or bf16) once and writes an [n] f32 vector: two
operations per element against four (or two) bytes read, so it is bound by
device-memory bytes on an H100 (3.35 TB/s). The source,
``csrc/col_scores.cu``, is one launch: blocks reduce a strip of columns over
a split of the rows into float32 partial rows, and the last block of each
strip (an integer ticket counter) sums them in split order, at any width n and
on any number of streams. No float atomics:
the same G always gives bit-identical scores, hence the same plan. bf16 input
is widened to fp32 before it is accumulated.

The library is built by ``kernels/build.py`` at first launch; the CPU path
uses the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import COL_SCORE_MODES
from repro_torch.kernels.ref import col_scores_ref as col_l1_scores_plain

__all__ = ["col_l1_scores", "col_l1_scores_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"l1": 0, "l2": 1}
_BLOCKS_PER_SM = 4  # at most about this many blocks per SM
_slots: dict = {}  # (device index, stream) -> counter slot (csrc/col_scores.cu)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def strip_width(dtype: torch.dtype) -> int:
    """Columns per block: one 16-byte load per thread of a warp."""
    return 32 * (16 // dtype.itemsize)


def split_step(dtype: torch.dtype) -> int:
    """Rows of one step of a block (8 warps, each with 16 float32 or 8 bf16
    rows' loads in flight): a split is a multiple of it."""
    return 8 * 64 * dtype.itemsize // 16


def split_plan(N: int, n: int, dtype: torch.dtype, sms: int) -> tuple:
    """(rows per split, splits): as many splits as give about
    ``_BLOCKS_PER_SM`` blocks per SM over the column strips, but no more
    than one per step of rows; each split a multiple of
    :func:`split_step` rows, none of them empty."""
    step = split_step(dtype)
    strips = _cdiv(n, strip_width(dtype))
    want = min(_cdiv(N, step), _cdiv(_BLOCKS_PER_SM * sms, strips))
    rows = _cdiv(_cdiv(N, want), step) * step
    return rows, _cdiv(N, rows)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _slot(device: torch.device, stream: int) -> int:
    """This (device, stream)'s counter slot: no two streams share one, and
    there is no cap on their number."""
    key = (device.index, stream)
    if key not in _slots:
        _slots[key] = len(_slots)
    return _slots[key]


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load_library("col_scores").cs_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    return fn


def col_l1_scores(G: torch.Tensor, *, mode: str = "l1") -> torch.Tensor:
    """Launch the score kernel on a CUDA tensor: G [N, n] -> [n] f32.

    Raises on anything the kernel does not take (a CPU tensor, another dtype,
    a non-contiguous or non-2-D G). Adds one to ``col_l1_scores.launches``.
    """
    if mode not in COL_SCORE_MODES:
        raise ValueError(f"unknown score mode {mode!r}; expected one of {sorted(COL_SCORE_MODES)}")
    if G.device.type != "cuda":
        raise ValueError(f"col_l1_scores kernel needs a CUDA tensor, got {G.device}")
    if G.dtype not in _DTYPES:
        raise ValueError(f"col_l1_scores kernel takes float32 or bfloat16, got {G.dtype}")
    if G.dim() != 2 or not G.is_contiguous():
        raise ValueError("col_l1_scores kernel needs a contiguous 2-D G")
    N, n = G.shape
    if N == 0 or n == 0:
        raise ValueError(f"col_l1_scores kernel needs a non-empty G, got {tuple(G.shape)}")
    rows, splits = split_plan(N, n, G.dtype, _sms(G.device.index))
    part = torch.empty((splits, n), dtype=torch.float32, device=G.device)
    out = torch.empty((n,), dtype=torch.float32, device=G.device)
    stream = torch.cuda.current_stream(G.device).cuda_stream
    with torch.cuda.device(G.device):
        err = _launcher()(_DTYPES[G.dtype], G.data_ptr(), part.data_ptr(), out.data_ptr(), N, n,
                          rows, splits, _slot(G.device, stream), _MODES[mode], stream)
    if err != 0:
        raise RuntimeError(f"col_l1_scores launch failed: CUDA error {err}")
    col_l1_scores.launches += 1
    return out


col_l1_scores.launches = 0
