"""Fixture: the port's own modules and prose about jax and repro — no
finding. The JAX package `repro` is named here in a docstring only."""
import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import site


def use(x):
    # jax.numpy would be spelled torch here; a comment is prose
    return np, torch, rng, site, x
