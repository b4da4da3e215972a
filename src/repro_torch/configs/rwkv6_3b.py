"""RWKV6-3B "Finch" [arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b].

32L, d_model 2560 (attention-free), channel-mix d_ff 8960, vocab 65536.
Data-dependent per-channel decay (LoRA-projected), head_dim 64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv=40, d_ff=8960, vocab=65536,
    block_kind="rwkv", ssm_head_dim=64, rope="none",
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
    ssm_head_dim=16, ssm_chunk=16, dtype="float32", param_dtype="float32",
)
