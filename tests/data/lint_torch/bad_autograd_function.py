"""Fixture: a second autograd spine (autograd-function-outside-site)."""
import torch
from torch.autograd import Function as Fn


class Rogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2


class Aliased(Fn):
    @staticmethod
    def forward(ctx, x):
        return x
