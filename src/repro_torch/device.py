"""Device resolution: the card by default, the CPU only on request."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``"cuda"`` (the default) requires a CUDA device and raises
    ``RuntimeError`` when there is none — there is no silent CPU path.
    ``"cpu"`` is honoured only because the caller asked for it (the tests do).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
