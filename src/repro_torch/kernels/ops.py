"""Kernel dispatcher: CPU tensors use the plain version; CUDA tensors launch
the hand-written kernel or raise.

Port of ``repro/kernels/ops.py``. There is no fallback: a CUDA tensor never
silently takes the plain path, and a tensor on any other device raises. The
JAX dispatcher's VMEM budget (``fused_vmem_bytes`` and the one-gather XLA
fallback it selects) has no counterpart: the Hopper kernel keeps no
accumulator resident across blocks, so it has no size above which it stops
fitting. Each kernel counts its own launches (:func:`launch_counts`).

A fake tensor (``torch._subclasses.fake_tensor.FakeTensor``: a shape, a
dtype and a device, no storage; the dry run's, ``launch/dryrun.py``) takes a
third branch, whatever device it claims: the wrapper returns fake outputs of
the kernel's shapes and dtypes, and adds one to the kernel's count of fake
launches and the launch's modelled operations and bytes (the formulas behind
``PERF.md``'s Bound column: each input read once, each output written once)
to :func:`fake_costs`. :func:`launch_counts` counts only real launches. Nothing is computed and nothing reaches the kernel's
launch, so the branch is no fallback: it answers "what would this call
launch", on tensors that hold nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import col_scores, ref as kref, sketch_matmul
from repro_torch.kernels import flash_attention as flash

__all__ = ["block_gather_matmul", "block_gather_matmul_dw", "block_gather_matmul_fused",
           "block_stream_matmul_fused", "col_l1_scores", "flash_attention",
           "gather_cols_matmul", "gather_cols_matmul_dw", "launch_counts",
           "reset_launch_counts", "fake_costs", "reset_fake_costs", "KERNELS"]

# name -> the wrapper that launches the kernel (and counts its launches)
KERNELS = {
    "col_l1_scores": col_scores.col_l1_scores,
    "block_gather_matmul": sketch_matmul.block_gather_matmul,
    "block_gather_matmul_dw": sketch_matmul.block_gather_matmul_dw,
    "block_gather_matmul_fused": sketch_matmul.block_gather_matmul_fused,
    "block_stream_matmul_fused": sketch_matmul.block_stream_matmul_fused,
    "flash_attention": flash.flash_attention,
}


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


_FAKE_COSTS = {"flops": 0, "bytes": 0, "launches": dict.fromkeys(KERNELS, 0)}


def fake_costs() -> dict:
    """Modelled operations (``flops``), bytes and launches per kernel
    (``launches``) of the calls taken on fake tensors since the last
    :func:`reset_fake_costs`."""
    return {"flops": _FAKE_COSTS["flops"], "bytes": _FAKE_COSTS["bytes"],
            "launches": dict(_FAKE_COSTS["launches"])}


def reset_fake_costs() -> None:
    _FAKE_COSTS["flops"] = _FAKE_COSTS["bytes"] = 0
    _FAKE_COSTS["launches"] = dict.fromkeys(KERNELS, 0)


def _is_fake(*ts) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) for t in ts)


def _fake_launch(name: str, outs, flops: int, n_bytes: int):
    """The fake branch: count the fake launch and its modelled cost; ``outs``
    (fake tensors made from the fake inputs) are what the kernel returns."""
    _FAKE_COSTS["launches"][name] += 1
    _FAKE_COSTS["flops"] += int(flops)
    _FAKE_COSTS["bytes"] += int(n_bytes)
    return outs


def _empty(like, shape, dtype=None):
    return like.new_empty(shape, dtype=dtype or like.dtype)


def _fake_bgm(name, G, block_idx, W, X, block, with_scores=False, stream=False):
    """The block kernels' outputs and costs (rows 2-5 of PERF.md's table)."""
    N, n = G.shape
    rb = block_idx.shape[0]
    kept = rb * block
    isz = G.element_size()
    f32 = torch.float32
    d = (X if X is not None else W).shape[-1]
    if name == "block_gather_matmul":
        return _fake_launch(name, _empty(G, (N, d)), 2 * N * kept * d,
                            isz * (N * kept + kept * d + N * d) + 8 * rb)
    if name == "block_gather_matmul_dw":
        return _fake_launch(name, _empty(G, (rb, block, d)), 2 * N * kept * d,
                            isz * (N * kept + N * d + kept * d) + 8 * rb)
    outs = (_empty(G, (N, d)), _empty(G, (rb, block, d)), _empty(G, (rb, block), f32))
    if stream:
        return _fake_launch(name, outs + (_empty(G, (n,), f32),),
                            4 * N * kept * d + 2 * N * n,
                            isz * (N * n + 2 * kept * d + 2 * N * d) + 8 * rb + 4 * kept
                            + 4 * n)
    k = 2 if with_scores else 1
    if with_scores:
        outs = outs + (_empty(G, (rb, block), f32),)
    return _fake_launch(name, outs, 4 * N * kept * d + 2 * N * kept * k,
                        isz * (N * kept + 2 * kept * d + 2 * N * d) + 8 * rb + 4 * kept * k)


def attended_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """(query, key) pairs one head of one prompt attends: query ``i`` sits at
    ``Skv - Sq + i`` and sees the keys up to it (the last ``window`` of
    them), or every key without ``causal``."""
    if not causal:
        return Sq * Skv
    lo, hi = Skv - Sq + 1, Skv  # keys up to each query, first and last
    if window is None or window >= hi:
        return (lo + hi) * Sq // 2
    top = min(hi, window)
    below = (lo + top) * (top - lo + 1) // 2 if top >= lo else 0
    return below + window * (hi - max(lo, window + 1) + 1)


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
    if _is_fake(G):
        N, n = G.shape
        return _fake_launch("col_l1_scores", _empty(G, (n,), torch.float32), 2 * N * n,
                            N * n * G.element_size() + 4 * n)
    if _on_cpu(G):
        return kref.col_scores_ref(G, mode=mode)
    return col_scores.col_l1_scores(G.contiguous(), mode=mode)


def _plan(block_idx, scales):
    """The kept block ids and scales as the kernels take them (on the device:
    no host sync)."""
    return block_idx.to(torch.int32).contiguous(), scales.to(torch.float32).contiguous()


def block_gather_matmul(G, block_idx, scales, W, *, block: int = 128):
    """Unfused dX = Σ_k s_k G[:, blk_k] W[blk_k, :]."""
    if _is_fake(G, block_idx, scales, W):
        return _fake_bgm("block_gather_matmul", G, block_idx, W, None, block)
    if _on_cpu(G, block_idx, scales, W):
        return kref.block_gather_matmul_ref(G, block_idx, scales, W, block=block)
    return sketch_matmul.block_gather_matmul(G.contiguous(), *_plan(block_idx, scales),
                                             W.contiguous(), block=block)


def block_gather_matmul_dw(G, block_idx, scales, X, *, block: int = 128):
    """Unfused compact dWc[k] = s_k G[:, blk_k]ᵀ X, ``[rb, block, d_in]``."""
    if _is_fake(G, block_idx, scales, X):
        return _fake_bgm("block_gather_matmul_dw", G, block_idx, None, X, block)
    if _on_cpu(G, block_idx, scales, X):
        return kref.block_gather_matmul_dw_ref(G, block_idx, scales, X, block=block)
    return sketch_matmul.block_gather_matmul_dw(G.contiguous(), *_plan(block_idx, scales),
                                                X.contiguous(), block=block)


def block_gather_matmul_fused(G, block_idx, scales, W, X, *, block: int = 128,
                              with_scores: bool = False, score_mode: str = "l1"):
    """Fused backward (dX, compact dW, compact db[, kept raw scores]); see
    ``sketch_matmul.block_gather_matmul_fused``."""
    if _is_fake(G, block_idx, scales, W, X):
        return _fake_bgm("block_gather_matmul_fused", G, block_idx, W, X, block,
                         with_scores=with_scores)
    if _on_cpu(G, block_idx, scales, W, X):
        return kref.block_gather_matmul_fused_ref(
            G, block_idx, scales, W, X, block=block,
            with_scores=with_scores, score_mode=score_mode)
    return sketch_matmul.block_gather_matmul_fused(
        G.contiguous(), *_plan(block_idx, scales), W.contiguous(), X.contiguous(),
        block=block, with_scores=with_scores, score_mode=score_mode)


def block_stream_matmul_fused(G, block_idx, scales, W, X, *, block: int = 128,
                              score_mode: str = "l1"):
    """Streaming one-pass backward over all of G: (dX, compact dW, compact db,
    fresh raw scores [n]); see ``sketch_matmul.block_stream_matmul_fused``.
    The plan (kept block ids and 1/p scales, sampled from carried scores)
    goes to the kernel as it is: the TPU kernel's per-block gates and slot
    map exist for its BlockSpec index maps and have no counterpart here."""
    if _is_fake(G, block_idx, scales, W, X):
        return _fake_bgm("block_stream_matmul_fused", G, block_idx, W, X, block, stream=True)
    if _on_cpu(G, block_idx, scales, W, X):
        return kref.block_stream_matmul_onepass_ref(G, block_idx, scales, W, X, block=block,
                                                    score_mode=score_mode)
    return sketch_matmul.block_stream_matmul_fused(
        G.contiguous(), *_plan(block_idx, scales), W.contiguous(), X.contiguous(),
        block=block, score_mode=score_mode)


def gather_cols_matmul(G, idx, scales, W):
    """Per-column compact dX. Arbitrary column gathers have no kernel in
    either package (the JAX one leaves them to XLA): plain PyTorch on every
    device."""
    return kref.gather_cols_matmul_ref(G, idx, scales, W)


def gather_cols_matmul_dw(G, idx, scales, X):
    return kref.gather_cols_matmul_dw_ref(G, idx, scales, X)


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Attention forward, q [B, Sq, H, dh], k/v [B, Skv, Kv, dh] -> [B, Sq, H, dh]
    (see ``kernels/flash_attention.py``). The plain version on the CPU is
    differentiable; the kernel is forward-only."""
    if _is_fake(q, k, v):
        B, Sq, H, dh = q.shape
        kref.check_flash_causal(Sq, k.shape[1], causal)
        return _fake_launch("flash_attention", torch.empty_like(q),
                            4 * dh * B * H * attended_pairs(Sq, k.shape[1], causal, window),
                            q.element_size() * (2 * q.numel() + k.numel() + v.numel()))
    if _on_cpu(q, k, v):
        return kref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash.flash_attention(q, k, v, causal=causal, window=window)
