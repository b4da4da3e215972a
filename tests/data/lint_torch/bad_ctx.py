"""Fixture: direct Ctx construction outside api/nn (ctx-outside-api-nn)."""
from repro_torch.nn.common import Ctx
from repro_torch.nn import common


def make(key):
    a = Ctx(key=key)
    b = common.Ctx(key=key)
    return a, b
