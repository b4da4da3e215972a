"""Fixture: global draws and one seed made into two generators (seed-reuse)."""
import torch

from repro_torch import rng


def sample(seed, x):
    a = torch.rand(3)
    b = torch.randn_like(x)
    torch.manual_seed(0)
    x.uniform_()
    g1 = rng.generator(seed, x.device)
    g2 = rng.generator(seed, x.device)
    c = torch.multinomial(x, 2)
    torch.nn.init.normal_(x)
    return a, b, g1, g2, c
