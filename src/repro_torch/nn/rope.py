"""Rotary position embeddings (standard RoPE). Port of ``repro/nn/rope.py``;
M-RoPE is not ported yet."""
from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope"]


def rope_freqs(d_head: int, theta: float, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, d_head]; positions: [B, S] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [d/2]
    ang = positions.to(torch.float32)[..., None] * freqs  # [B, S, d/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
