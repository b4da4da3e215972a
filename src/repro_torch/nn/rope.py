"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE. Port of
``repro/nn/rope.py``.

M-RoPE (arXiv:2409.12191) splits the d/2 frequency slots of each head into
three sections rotated by the (temporal, height, width) position streams;
when the three streams are equal (text tokens) it is standard RoPE.
"""
from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope", "apply_mrope", "mrope_sections", "MROPE_SECTIONS"]


def rope_freqs(d_head: int, theta: float, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the halves of ``x`` [B, S, H, d] by the angles ``ang`` [B, S, d/2]."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, d_head]; positions: [B, S] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [d/2]
    return _rotate(x, positions.to(torch.float32)[..., None] * freqs)


# The ratio of the d/2 frequency slots given to the (t, h, w) streams: JAX's
# t-heavy 2:1:1, not the published Qwen2-VL's 16/24/24. JAX's attention calls
# ``apply_mrope`` without ``sections``, and the port keeps its split (ROADMAP
# Queue 3 item 10); this is the one place to change it.
MROPE_SECTIONS = (2, 1, 1)


def mrope_sections(d_head: int) -> list:
    """The number of frequency slots each stream (t, h, w) rotates: ``d_head
    / 2`` split in the ratio :data:`MROPE_SECTIONS`, the last stream taking
    the remainder (JAX's rule; 32/16/16 at d_head 128)."""
    half = d_head // 2
    total = sum(MROPE_SECTIONS)
    sizes = [half * s // total for s in MROPE_SECTIONS]
    sizes[-1] = half - sizes[0] - sizes[1]
    return sizes


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float) -> torch.Tensor:
    """M-RoPE. x: [B, S, H, d_head]; positions3: [3, B, S] (t, h, w)."""
    sizes = mrope_sections(x.shape[-1])
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [d/2]
    pos = positions3.to(torch.float32)
    # [B, S, d/2]: slot j takes the position of its stream
    per_slot = torch.cat([pos[i][..., None].expand(*pos.shape[1:], n)
                          for i, n in enumerate(sizes)], dim=-1)
    return _rotate(x, per_slot * freqs)
