"""Fixture: a torch.autograd.Function named in prose, a Module, a local
class that happens to be called Function, and torch.autograd.grad — none is
a finding."""
import torch


class Function:
    pass


class Local(Function):
    pass


class Layer(torch.nn.Module):
    def forward(self, x):
        return x


def grads(loss, leaves):
    return torch.autograd.grad(loss, leaves)
