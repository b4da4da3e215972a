"""CUDA kernel: flash-attention forward on Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``: causal or sliding-window GQA attention, online softmax in
float32, q ``[B, Sq, H, dh]`` and k/v ``[B, Skv, Kv, dh]`` in float32 or
bfloat16, output in q's type, any head width dh up to 256 (instantiated at
64, 128 and 256; a width between runs in the next one with zero-filled
columns, at the true scale ``dh ** -0.5``). The source is
``csrc/flash_attention.cu`` (sm_90a), built by ``kernels/build.py`` and bound
with ``ctypes``; it says what bounds the kernel and how its work is split.

The kernel is forward-only, like the TPU kernel: JAX trains through the
chunked attention path, and so does the port. :func:`flash_attention` runs
it inside an autograd Function whose backward raises. The wrapper takes CUDA
tensors only; the CPU path (``kernels/ops.py``) uses the plain version,
:func:`flash_attention_plain`, which stays differentiable.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import check_flash_causal
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DH = 256  # the widest instantiation; narrower widths run padded to 64, 128 or 256


def _fn():
    fn = build.load_library("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check(q, k, v, causal, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel needs CUDA tensors, {name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D [B, S, heads, dh], got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last (dh) axis must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    B, Sq, H, dh = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, Kv, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be [B, Skv, Kv, dh] = [{B}, Skv, Kv, {dh}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if not 1 <= dh <= _MAX_DH:
        raise ValueError(f"flash_attention kernel takes head widths dh from 1 to {_MAX_DH}, "
                         f"got {dh}")
    if min(B, Sq, Skv, H, Kv) == 0 or H % Kv != 0:
        raise ValueError(f"need non-empty q, k, v and Kv dividing H, got H {H}, Kv {Kv}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    check_flash_causal(Sq, Skv, causal)


def _launch(q, k, v, causal, window):
    B, Sq, H, dh = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _fn()(_DTYPES[q.dtype], dh, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    B, Sq, Skv, H, Kv, *strides, int(causal),
                    int(window) if (causal and window is not None) else 0,
                    dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return o


class _FlashAttentionFn(torch.autograd.Function):
    """The kernel as an autograd node: forward launches, backward raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_o):
        raise NotImplementedError(
            "the flash_attention kernel is forward-only, like the TPU kernel it replaces: "
            "train with attn_impl='chunked' or 'einsum'")


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Launch the kernel on CUDA tensors: q [B, Sq, H, dh], k/v [B, Skv, Kv, dh]
    (float32 or bfloat16, one dtype, dh from 1 to 256, the dh axis contiguous; any batch,
    sequence and head strides) -> a contiguous [B, Sq, H, dh] in q's dtype.
    ``window`` applies only when ``causal``. Raises on anything the kernel does
    not take, a causal call with Sq > Skv among them. Adds one to
    ``flash_attention.launches``."""
    _check(q, k, v, causal, window)
    return _FlashAttentionFn.apply(q, k, v, causal, window)


flash_attention.launches = 0
