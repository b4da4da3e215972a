"""Architecture config schema and shape cells (``ArchConfig``, ``ShapeCell``,
``SHAPE_CELLS``, copied from ``repro/configs/base.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ArchConfig", "ShapeCell", "SHAPE_CELLS"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm | mlp
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    mlp_type: str = "swiglu"  # swiglu | geglu | relu_sq | gelu
    rope: str = "default"  # default | mrope | none
    rope_theta: float = 1e4
    rope_theta_global: Optional[float] = None  # gemma3 dual-theta
    window: Optional[int] = None  # sliding window width
    local_global: int = 0  # k local layers per 1 global (gemma3: 5)
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scaling
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    block_kind: str = "attn"  # attn | rwkv | mamba | zamba
    ssm_state: int = 0
    ssm_head_dim: int = 64
    shared_attn_every: int = 0  # zamba: one shared attn block every k mamba layers
    # enc-dec
    enc_layers: int = 0
    # numerics
    dtype: str = "float32"
    param_dtype: str = "float32"
    # execution
    q_chunk: int = 512
    kv_chunk: int = 1024
    ssm_chunk: int = 256
    attn_impl: str = "chunked"  # chunked | einsum | pallas
    remat: str = "full"  # full | dots | none
    # frontend stub
    frontend: Optional[str] = None  # vision | audio

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (sub-quadratic / bounded-window attention)."""
        return (self.block_kind in ("rwkv", "mamba", "zamba")
                or self.window is not None or self.local_global > 0)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
