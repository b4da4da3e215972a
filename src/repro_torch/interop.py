"""Parameter and cache trees from the JAX package, for parity checks.

``params_from_jax`` turns the tree of ``repro.models.lm.init_params`` (as
numpy arrays) into this package's parameters. The JAX tree stacks each
segment's layers on a leading ``[n_rep]`` axis; the port keeps one dict per
layer, so the function unstacks it. Both packages then compute the same
function. Any tree of the same structure works (a gradient tree too), and so
does the tree of a JAX ``init_state`` with a plan-carry policy: each site's
``"sslot"`` carry leaf ``[n_layers, n]`` is unstacked with the weights into
one ``[n]`` leaf per layer. ``caches_from_jax`` does the same for the
decode caches of ``lm.init_cache`` / ``lm.prefill``, ``pools_from_jax`` for
the serving engine's page pools (``serve/kv_cache.init_pools``), and
``compact_grad_from_jax`` turns a JAX ``CompactGrad`` (float32 indices) into
the port's (int64 indices). For the paper's §5 models: an ``mlp_arch``
config's tree is a list of ``{"w", "b"}`` dicts and comes across as it is;
``vit_params_from_jax`` and ``bagnet_params_from_jax`` take the trees of
``vit_init`` and ``bagnet_init``, whose layout the port keeps except for
BagNet's 3×3 convolutions: HWIO ``[k, k, cin, cout]`` in JAX, OIHW ``[cout,
cin, k, k]`` (PyTorch's ``conv2d`` layout) in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.compact_grad import CompactGrad
from repro_torch.device import resolve_device
from repro_torch.models.lm import check_decoder, check_supported
from repro_torch.tree import tree_map

__all__ = ["bagnet_params_from_jax", "caches_from_jax", "compact_grad_from_jax",
           "params_from_jax", "pools_from_jax", "vit_params_from_jax"]


def params_from_jax(tree, cfg: ArchConfig, *, device="cuda"):
    """The port's parameter dict for the JAX ``lm.init_params`` tree ``tree``
    (leaves convertible with ``np.asarray``), on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), device=dev)

    if cfg.family == "mlp":
        if len(tree) != cfg.n_layers:
            raise ValueError(f"tree has {len(tree)} layers, config {cfg.n_layers}")
        return [tree_map(t, layer) for layer in tree]
    segments = tree["segments"]
    if len(segments) != 1 or len(segments[0]) != 1:
        raise ValueError("expected one segment with one sub-block (the dense family)")
    stacked = segments[0][0]
    n_rep = np.asarray(stacked["norm1"]["g"]).shape[0]
    if n_rep != cfg.n_layers:
        raise ValueError(f"tree has {n_rep} layers, config {cfg.n_layers}")
    out = {"embed": t(tree["embed"]),
           "final_norm": tree_map(t, tree["final_norm"]),
           "layers": [tree_map(lambda a, i=i: t(np.asarray(a)[i]), stacked)
                      for i in range(n_rep)]}
    if "lm_head" in tree:
        out["lm_head"] = tree_map(t, tree["lm_head"])
    return out


def caches_from_jax(caches, cfg: ArchConfig, *, device="cuda"):
    """The port's per-layer cache list for the JAX ``lm.init_cache`` /
    ``lm.prefill`` cache tree ``caches``: segments -> sub-blocks ->
    ``{"kv": {"k", "v"}}`` stacked on ``[n_layers]``; on ``device``."""
    check_decoder(cfg)
    dev = resolve_device(device)
    if len(caches) != 1 or len(caches[0]) != 1:
        raise ValueError("expected one segment with one sub-block (the dense family)")
    kv = caches[0][0]["kv"]
    k, v = np.asarray(kv["k"]), np.asarray(kv["v"])
    if k.shape[0] != cfg.n_layers:
        raise ValueError(f"tree has {k.shape[0]} layers, config {cfg.n_layers}")
    return [{"k": torch.tensor(k[i], device=dev), "v": torch.tensor(v[i], device=dev)}
            for i in range(cfg.n_layers)]


def pools_from_jax(pools, cfg: ArchConfig, *, device="cuda"):
    """The port's per-layer page pools for the JAX ``kv_cache.init_pools``
    tree ``pools`` (the cache tree's structure, each K/V leaf ``[n_layers,
    pool_pages, page_size, n_kv, d_head]``): one ``{"k", "v"}`` of
    ``[pool_pages, page_size, n_kv, d_head]`` per layer, on ``device``."""
    return caches_from_jax(pools, cfg, device=device)


def compact_grad_from_jax(cg, *, device="cuda") -> CompactGrad:
    """The port's :class:`~repro_torch.core.compact_grad.CompactGrad` for a JAX
    ``CompactGrad`` of one 2-D weight (any object with ``rows``, ``idx`` and
    ``dense``, leaves convertible with ``np.asarray``): float32 rows, the
    float32 indices as int64 (they hold whole numbers exactly), the dense
    part when there is one; on ``device``."""
    dev = resolve_device(device)
    rows, idx = np.asarray(cg.rows), np.asarray(cg.idx)
    if rows.ndim != 2 or idx.shape != rows.shape[:1]:
        raise ValueError(f"expected rows [r, d_in] and idx [r], got {rows.shape} and {idx.shape}")
    if not np.array_equal(idx, np.round(idx)):
        raise ValueError("indices must be whole numbers")
    dense = None if cg.dense is None else torch.tensor(np.asarray(cg.dense), device=dev)
    return CompactGrad(rows=torch.tensor(rows, dtype=torch.float32, device=dev),
                       idx=torch.tensor(idx.astype(np.int64), device=dev), dense=dense)


def vit_params_from_jax(tree, *, device="cuda"):
    """The port's ViT parameters for the JAX ``vision.vit_init`` tree (the
    same layout), on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev), tree)


def bagnet_params_from_jax(tree, *, device="cuda"):
    """The port's BagNet parameters for the JAX ``vision.bagnet_init`` tree, on
    ``device``: the 3×3 convolutions (the stem and every block's ``c2``) go
    from HWIO to OIHW; the 1×1 sites and the head keep their ``[d_out,
    d_in]`` weights."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), device=dev)

    def conv(p):
        w = np.asarray(p["w"])
        if w.ndim != 4:
            raise ValueError(f"expected an HWIO conv weight, got shape {w.shape}")
        return {"w": t(np.ascontiguousarray(w.transpose(3, 2, 0, 1))), "b": t(p["b"])}

    return {"stem": conv(tree["stem"]),
            "blocks": [[{"c1": tree_map(t, b["c1"]), "c2": conv(b["c2"]),
                         "c3": tree_map(t, b["c3"])} for b in stage]
                       for stage in tree["blocks"]],
            "head": tree_map(t, tree["head"])}
