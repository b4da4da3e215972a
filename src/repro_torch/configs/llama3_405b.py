"""Llama-3.1-405B [arXiv:2407.21783].

126L, d_model 16384, 128 heads GQA kv=8, d_ff 53248, vocab 128256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv=8, d_ff=53248, vocab=128256,
    mlp_type="swiglu", rope_theta=500000.0,
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_ff=128, vocab=256,
    dtype="float32", param_dtype="float32", q_chunk=16, kv_chunk=16,
)
