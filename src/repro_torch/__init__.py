"""PyTorch and CUDA port of the sketched-backprop system.

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch on an NVIDIA Hopper card. Every entry point takes an
explicit ``device`` (default ``"cuda"``): without a card it raises, and it runs
on the CPU only when the caller passes ``device="cpu"``. The backward kernels
that the JAX package wrote in Pallas for the TPU are written here by hand for
Hopper (``repro_torch.kernels``). See ``docs/port.md``.
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    # lazy (PEP 562), so that the stdlib-only lint (``repro_torch.analysis``)
    # imports no torch
    if name == "resolve_device":
        from repro_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
