"""Parameter trees from the JAX package, for parity checks.

``params_from_jax`` turns the tree of ``repro.models.lm.init_params`` (as
numpy arrays) into this package's parameters. The JAX tree stacks each
segment's layers on a leading ``[n_rep]`` axis; the port keeps one dict per
layer, so the function unstacks it. Both packages then compute the same
function. Any tree of the same structure works (a gradient tree too).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import check_supported
from repro_torch.tree import tree_map

__all__ = ["params_from_jax"]


def params_from_jax(tree, cfg: ArchConfig, *, device="cuda"):
    """The port's parameter dict for the JAX ``lm.init_params`` tree ``tree``
    (leaves convertible with ``np.asarray``), on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), device=dev)

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
