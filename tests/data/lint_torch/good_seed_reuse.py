"""Fixture: explicit generators, fold_in, rebinding and exclusive branches —
no finding (prose about torch.manual_seed is not a call)."""
import numpy as np
import torch

from repro_torch import rng


def sample(seed, x, flag):
    g = rng.generator(seed, x.device)
    a = torch.rand(3, generator=g)
    x.normal_(generator=g)
    if flag:
        b = rng.generator(rng.fold_in(seed, 1), x.device)
    else:
        b = rng.generator(rng.fold_in(seed, 2), x.device)
    seed = rng.fold_in(seed, 3)
    c = rng.generator(seed, x.device)
    rs = np.random.default_rng(0)
    return a, b, c, rs.standard_normal(3)


def per_layer(step_seed, n):
    out = []
    for i in range(n):
        seed = rng.fold_in(step_seed, i)
        out.append(rng.generator(seed, "cpu"))
    return out
