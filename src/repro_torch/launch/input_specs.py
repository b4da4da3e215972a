"""Fake-tensor stand-ins for every (arch x shape-cell) input.

Port of ``repro/launch/input_specs.py``. JAX's dry run lowers against
``ShapeDtypeStruct``s; the port's runs its step on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``): each has a shape, a
dtype and a device, and no storage, so nothing here allocates. Every
function takes the ``mode`` the tensors belong to (a fresh one by default)
and the ``device`` they claim (``"cuda"``, the card's; the dry run passes
the CPU where the build has no CUDA).

The shapes and dtypes are JAX's, int32 token ids and labels included (the
port's ``train_step.batch_to_device`` casts ids to int64 on the device, as
it does a host batch's, and the dry run counts that copy). The stub
frontends are JAX's: the VLM feeds ``embeds`` [B, S, d] and M-RoPE
``positions`` [3, B, S], the encoder-decoder ``src_embeds`` [B, S, d]. The
parameter and cache trees
are the port's layout (one dict per layer, ``models/lm.py``), whose leaves
map one to one onto JAX's stacked ones through ``interop``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import lm
from repro_torch.tree import tree_map

__all__ = ["fake_mode", "train_inputs", "decode_inputs", "params_struct", "cache_struct"]


def fake_mode():
    """A fresh fake-tensor mode (real tensors may enter it: they are
    converted on use)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _sds(mode, shape, dtype, device):
    with mode:
        return torch.empty(shape, dtype=dtype, device=device)


def train_inputs(cfg: ArchConfig, cell: ShapeCell, *, mode=None, device="cuda") -> dict:
    """Batch tensors for train/prefill cells ({tokens|embeds, labels, ...})."""
    mode = mode or fake_mode()
    B, S = cell.global_batch, cell.seq_len
    dt = getattr(torch, cfg.dtype)
    batch = {"labels": _sds(mode, (B, S), torch.int32, device)}
    if cfg.frontend == "vision":
        batch["embeds"] = _sds(mode, (B, S, cfg.d_model), dt, device)
        batch["positions"] = _sds(mode, (3, B, S), torch.int32, device)
    else:
        batch["tokens"] = _sds(mode, (B, S), torch.int32, device)
    if cfg.is_encdec:
        batch["src_embeds"] = _sds(mode, (B, S, cfg.d_model), dt, device)
    return batch


def decode_inputs(cfg: ArchConfig, cell: ShapeCell, *, mode=None, device="cuda") -> dict:
    """One-token decode tensors: the new token, its position (a host int, as
    the port's ``decode_step`` takes it) and the KV/SSM caches at seq_len."""
    mode = mode or fake_mode()
    B, S = cell.global_batch, cell.seq_len
    tok = (_sds(mode, (B, 1, cfg.d_model), getattr(torch, cfg.dtype), device)
           if cfg.frontend == "vision" else _sds(mode, (B, 1), torch.int32, device))
    return {"tokens": tok, "pos": S - 1, "caches": cache_struct(cfg, B, S, mode=mode,
                                                                device=device)}


def _fake_like(tree, mode, device):
    return tree_map(lambda t: _sds(mode, tuple(t.shape), t.dtype, device)
                    if isinstance(t, torch.Tensor) else t, tree)


def params_struct(cfg: ArchConfig, *, mode=None, device="cuda"):
    """The whole parameter tree of ``cfg`` as fake tensors."""
    return _fake_like(lm.param_shapes(cfg), mode or fake_mode(), device)


def cache_struct(cfg: ArchConfig, batch: int, max_len: int, *, mode=None, device="cuda"):
    """The whole decode caches of ``batch`` rows at ``max_len`` as fake
    tensors (an encoder-decoder's memory at ``max_len`` too, as in JAX)."""
    meta = torch.device("meta")
    shapes = [lm.layer_cache(cfg, kind, batch, max_len,
                             enc_len=max_len if cfg.is_encdec else 0, device=meta)
              for kind in lm.layer_kinds(cfg)]
    return _fake_like(shapes, mode or fake_mode(), device)
