"""Registry of the named architectures and their reduced smoke variants
(port of ``repro/configs/registry.py``).

Every entry is the published config of its architecture; ``smoke_config``
shrinks depth, width and vocabulary for CPU tests while keeping the family's
structure (MoE routing, the local:global pattern, the shared-attention
period, the encoder-decoder split). Every config is here, also those of the
families the port does not run yet: ``models.lm.check_decoder`` names what a
model refuses.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPE_CELLS, ArchConfig

__all__ = ["ARCH_IDS", "get_config", "smoke_config", "cells_for", "skipped_cells_for"]

ARCH_IDS = (
    "olmoe_1b_7b",
    "mixtral_8x22b",
    "qwen2_vl_2b",
    "seamless_m4t_large_v2",
    "nemotron_4_340b",
    "gemma3_1b",
    "yi_6b",
    "llama3_405b",
    "zamba2_7b",
    "rwkv6_3b",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_config(name: str) -> ArchConfig:
    name = _ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def smoke_config(name: str) -> ArchConfig:
    name = _ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE


def cells_for(cfg: ArchConfig):
    """Shape cells that apply to this arch (long_500k needs sub-quadratic attn)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return [SHAPE_CELLS[c] for c in cells]


def skipped_cells_for(cfg: ArchConfig):
    return [] if cfg.sub_quadratic else [SHAPE_CELLS["long_500k"]]
