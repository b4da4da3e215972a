"""Zamba2-7B [arXiv:2411.15242].

81 Mamba2 layers (d_model 3584, ssm_state 64) with a SHARED full-attention
transformer block applied every 6 mamba layers (32 heads, kv=32, d_ff 14336),
vocab 32000. We apply the shared block 13 times (81 = 13*6 + 3).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336, vocab=32000,
    block_kind="zamba", ssm_state=64, shared_attn_every=6,
    mlp_type="swiglu", rope_theta=10000.0,
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=7, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
    shared_attn_every=3, ssm_head_dim=16, ssm_chunk=16,
    dtype="float32", param_dtype="float32", q_chunk=16, kv_chunk=16,
)
