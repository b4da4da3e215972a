"""Serving steps: prefill and single-token decode (port of
``repro/serve/serve_step.py``).

``make_prefill`` and ``make_decode_step`` build the functions that
``Runtime.prefill_step`` and ``Runtime.decode_step`` hand out. They run
without autograd on the runtime's device: inputs (token ids or a stub
frontend's embeds, segment ids, positions, an encoder's ``src_embeds``;
numpy arrays or tensors) are moved there first. The decode step
writes into the caches it is given (see ``nn/attention.py``). The engines
(``serve/engine.py``, ``serve/legacy.py``) are built on them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.execution import ExecutionConfig
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm

__all__ = ["greedy_sample", "make_decode_step", "make_prefill"]


def greedy_sample(logits):
    """The argmax token of each row's last axis, int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill(cfg: ArchConfig, max_len: int, *,
                 execution: Optional[ExecutionConfig] = None, device="cuda"):
    """``prefill_fn(params, batch) -> (logits [B, S, V], caches)``; caches hold
    ``max_len`` positions (or the window)."""
    # imported here: train_step imports the api package, which imports this one
    from repro_torch.train.train_step import batch_to_device

    ex = execution if execution is not None else ExecutionConfig()
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_fn(params, batch):
        lm.check_recurrent_segments(cfg, batch.get("segments"))  # on the host, before the copy
        return lm.prefill(params, batch_to_device(batch, dev), ex.make_ctx(), cfg, max_len)

    return prefill_fn


def make_decode_step(cfg: ArchConfig, *, execution: Optional[ExecutionConfig] = None,
                     device="cuda"):
    """``decode_fn(params, caches, tokens [B, 1], pos) -> (logits [B, 1, V],
    caches)``; ``pos`` is an int or one position per row. ``tokens`` may be
    float embeds [B, 1, d] (the VLM's stub frontend), which pass as they
    are."""
    ex = execution if execution is not None else ExecutionConfig()
    dev = resolve_device(device)

    @torch.no_grad()
    def decode_fn(params, caches, tokens, pos):
        tokens = torch.as_tensor(tokens)
        tokens = (tokens if tokens.is_floating_point() else tokens.long()).to(dev)
        if not isinstance(pos, int):
            pos = torch.as_tensor(pos).long().to(dev)
        return lm.decode_step(params, caches, tokens, pos, ex.make_ctx(), cfg)

    return decode_fn
