"""Serving steps: prefill and single-token decode (port of
``repro/serve/serve_step.py``).

``make_prefill`` and ``make_decode_step`` build the functions that
``Runtime.prefill_step`` and ``Runtime.decode_step`` hand out. They run
without autograd on the runtime's device: inputs (token ids or a stub
frontend's embeds, segment ids, positions, an encoder's ``src_embeds``;
numpy arrays or tensors) are moved there first. The decode step
writes into the caches it is given (see ``nn/attention.py``). The engines
(``serve/engine.py``, ``serve/legacy.py``) are built on them.

Under a mesh (``ExecutionConfig(mesh=...)``) every rank calls the same step
with the same global inputs and this rank's parameter shards
(``launch.sharding.shard_params``); the step keeps this rank's rows (over
the data axes where the batch divides them, ``data.pipeline.shard_batch``'s
cut; every row otherwise) and returns their logits over the whole vocabulary,
and caches in ``launch.sharding.cache_specs``' layout. :func:`whole_rows`
all-gathers what the rows give (the sampled tokens) over the data axes, so
every rank sees every row.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.execution import ExecutionConfig
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm

__all__ = ["greedy_sample", "make_decode_step", "make_prefill", "own_rows", "whole_rows"]


def greedy_sample(logits):
    """The argmax token of each row's last axis, int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def own_rows(x, mesh, n_rows: int, dim: int = 0):
    """This rank's rows (``dim``) of ``x``, a tensor or array every rank holds
    whole: its chunk over the data axes where ``n_rows`` divides them, else
    all of them (no collective)."""
    from repro_torch.launch.mesh import chunk_of
    from repro_torch.launch.sharding import rows_axes

    axes = rows_axes(n_rows, mesh)
    if not axes:
        return x
    return chunk_of(torch.as_tensor(x), axes, mesh, dim)


def whole_rows(t, mesh, n_rows: int):
    """Every row of ``t`` (dim 0), the rows ``own_rows`` gave this rank:
    all-gathered over the data axes where they split the rows."""
    from repro_torch.launch.mesh import all_gather
    from repro_torch.launch.sharding import rows_axes

    axes = rows_axes(n_rows, mesh)
    return all_gather(t, axes, mesh, axis=0) if axes else t


def make_prefill(cfg: ArchConfig, max_len: int, *,
                 execution: Optional[ExecutionConfig] = None, device="cuda"):
    """``prefill_fn(params, batch) -> (logits [B, S, V], caches)``; caches hold
    ``max_len`` positions (or the window). Under a mesh: the global batch
    in, this rank's rows of logits and shards of the caches out."""
    # imported here: train_step imports the api package, which imports this one
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.sharding import spec_of
    from repro_torch.train.train_step import batch_to_device

    ex = execution if execution is not None else ExecutionConfig()
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_fn(params, batch):
        lm.check_recurrent_segments(cfg, batch.get("segments"))  # on the host, before the copy
        if ex.mesh is None:
            return lm.prefill(params, batch_to_device(batch, dev), ex.make_ctx(), cfg, max_len)
        _check_sharded(params)
        rows = shard_batch(batch, mesh=ex.mesh)  # marked: the copy below drops the marks
        inp = rows["tokens"] if "tokens" in rows else rows["embeds"]
        ctx = ex.make_ctx(rows_sharded=spec_of(inp) is not None)
        return lm.prefill(params, batch_to_device(rows, dev), ctx, cfg, max_len)

    return prefill_fn


def make_decode_step(cfg: ArchConfig, *, execution: Optional[ExecutionConfig] = None,
                     device="cuda"):
    """``decode_fn(params, caches, tokens [B, 1], pos) -> (logits [B, 1, V],
    caches)``; ``pos`` is an int or one position per row. ``tokens`` may be
    float embeds [B, 1, d] (the VLM's stub frontend), which pass as they
    are. Under a mesh: the global tokens and positions in, this rank's rows
    of logits out; ``caches`` are this rank's shards (the prefill's)."""
    ex = execution if execution is not None else ExecutionConfig()
    dev = resolve_device(device)

    @torch.no_grad()
    def decode_fn(params, caches, tokens, pos):
        tokens = torch.as_tensor(tokens)
        tokens = (tokens if tokens.is_floating_point() else tokens.long()).to(dev)
        if not isinstance(pos, int):
            pos = torch.as_tensor(pos).long().to(dev)
        if ex.mesh is None:
            return lm.decode_step(params, caches, tokens, pos, ex.make_ctx(), cfg)
        from repro_torch.launch.sharding import rows_axes

        n = tokens.shape[0]
        tokens = own_rows(tokens, ex.mesh, n)
        if not isinstance(pos, int) and pos.dim() == 1:
            pos = own_rows(pos, ex.mesh, n)
        ctx = ex.make_ctx(rows_sharded=bool(rows_axes(n, ex.mesh)))
        return lm.decode_step(params, caches, tokens, pos, ctx, cfg)

    return decode_fn


def _check_sharded(params) -> None:
    """Raise unless ``params`` holds this rank's shards (marked leaves)."""
    from repro_torch.launch.sharding import spec_of
    from repro_torch.tree import tree_leaves

    if not any(spec_of(t) is not None for t in tree_leaves(params)):
        raise ValueError("under a mesh the serving steps take this rank's parameter shards: "
                         "launch.sharding.shard_params(params, mesh)")
