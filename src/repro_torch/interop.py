"""Parameter and cache trees from the JAX package, for parity checks.

``params_from_jax`` turns the tree of ``repro.models.lm.init_params`` (as
numpy arrays) into this package's parameters. The JAX tree holds one list of
sub-blocks per segment (``lm.plan_segments``: gemma3's period of 5 local and
1 global layers, then its remainder), each stacked on a leading ``[n_rep]``
axis; the port keeps one dict per layer in uid order, so the function
unstacks them (an MoE layer's ``moe`` leaves keep their expert axis; a
Mamba or RWKV layer's ``mu``, ``conv``, ``A_log`` and the rest keep their
own shapes). A zamba ``shared_attn`` sub-block is ``None`` in JAX's
segments and an empty dict in the port's layers; its one weight,
``"shared"``, comes across as it is. An encoder-decoder's
``encoder/segments`` are unstacked the same way into
``encoder/layers`` (its ``final_norm`` beside them), and a decoder layer's
``cross`` and ``norm_c`` leaves come with the rest of its sub-block. Both
packages then compute the same function. Any tree of the same structure
works (a gradient tree too), and so does the tree of a JAX ``init_state``
with a plan-carry policy: each site's ``"sslot"`` carry leaf ``[n_rep, n]``
is unstacked with the weights into one ``[n]`` leaf per layer.
``caches_from_jax`` does the same for the
decode caches of ``lm.init_cache`` / ``lm.prefill`` (attention's K/V, an
encoder-decoder's ``cross`` K/V, and the recurrent states),
``pools_from_jax`` for
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
from repro_torch.models.lm import check_decoder, check_supported, plan_segments
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
    out = {"embed": t(tree["embed"]),
           "final_norm": tree_map(t, tree["final_norm"]),
           "layers": _unstack(tree["segments"], cfg, t)}
    for name in ("shared", "lm_head"):
        if name in tree:
            out[name] = tree_map(t, tree[name])
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {"layers": _unstack(enc["segments"], cfg, t, encoder=True),
                          "final_norm": tree_map(t, enc["final_norm"])}
    return out


def _first_leaf(subs):
    node = next(sub for sub in subs if sub is not None)
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return np.asarray(node)


def _unstack(segments, cfg: ArchConfig, t, encoder: bool = False):
    """One dict per layer, in uid order, from JAX's per-segment stacks (an
    empty dict for a ``None`` sub-block: a shared one); the encoder's with
    ``encoder``."""
    plan = plan_segments(cfg, encoder=encoder)
    if len(segments) != len(plan) or any(len(s) != len(period)
                                         for s, (period, _) in zip(segments, plan)):
        raise ValueError(f"tree's segments do not follow the plan of {cfg.name}")
    layers = []
    for si, (subs, (period, n_rep)) in enumerate(zip(segments, plan)):
        n = _first_leaf(subs).shape[0]
        if n != n_rep:
            raise ValueError(f"segment {si} of the tree stacks {n * len(period)} layers, the "
                             f"plan of {cfg.name} {n_rep * len(period)}")
        for rep in range(n_rep):
            layers.extend({} if sub is None else tree_map(lambda a, rep=rep: t(np.asarray(a)[rep]),
                                                          sub) for sub in subs)
    return layers


def caches_from_jax(caches, cfg: ArchConfig, *, device="cuda"):
    """The port's per-layer cache list for the JAX ``lm.init_cache`` /
    ``lm.prefill`` cache tree ``caches``: segments -> sub-blocks ->
    ``{"kv": {"k", "v"}}`` for attention (with ``"cross": {"k", "v"}`` in an
    encoder-decoder's decoder, which the port keeps beside ``k`` and ``v``),
    or a recurrent layer's state (``{"ssm", "conv"}``, ``{"wkv",
    "shift_tm", "shift_cm"}``), each stacked on its segment's periods; on
    ``device``."""
    check_decoder(cfg)
    dev = resolve_device(device)

    def layer(sub):
        if "kv" not in sub:
            return sub
        return dict(sub["kv"], cross=sub["cross"]) if "cross" in sub else sub["kv"]

    per_sub = [[layer(sub) for sub in seg] for seg in caches]
    return _unstack(per_sub, cfg, lambda a: torch.tensor(np.asarray(a), device=dev))


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
