"""Seed derivation with the JAX package's key structure.

JAX folds the per-step key with the layer uid and then with the role id
(``repro/nn/common.py``), so two sketched sites never share randomness. The
port keeps that structure on 64-bit integer seeds: :func:`fold_in` mixes a
seed with one integer (splitmix64), and :func:`generator` turns the final
seed into the explicit ``torch.Generator`` one sketched site consumes. The
bits differ from JAX's threefry; only the structure is the same.

Under a mesh a site's random tensors follow the fold rule
(:func:`fold_generator`; docs/port.md, "Layouts and randomness"): a tensor
replicated over an axis is drawn once, from a seed that does not fold that
axis's rank; a tensor sharded over an axis is drawn in independent blocks,
each rank's seed folding its index along that axis. For i.i.d. draws that
gives exactly the law of the single device's whole draw.
"""
from __future__ import annotations

import torch

__all__ = ["fold_in", "generator", "fold_generator"]

_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 64-bit seed from ``seed`` and the integer ``data``."""
    return _mix((_mix(seed & _MASK) + 0x9E3779B97F4A7C15 * (int(data) + 1)) & _MASK)


def generator(seed: int, device) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed & _MASK)
    return g


def fold_generator(gen: torch.Generator, tag: int, folds) -> torch.Generator:
    """The generator of one random tensor of a site under a mesh, by the
    fold rule: ``gen`` itself (the site's single-device stream) where
    ``folds`` is empty, the tensor being replicated over every axis of
    several ranks; otherwise a fresh generator whose seed folds ``gen``'s
    seed with ``tag`` (which of the site's tensors) and then with each of
    this rank's indices in ``folds``, one per axis that shards the tensor."""
    if not folds:
        return gen
    seed = fold_in(gen.initial_seed(), tag)
    for i in folds:
        seed = fold_in(seed, i)
    return generator(seed, gen.device)
