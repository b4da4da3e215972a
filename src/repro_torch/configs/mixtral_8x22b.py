"""Mixtral-8x22B [arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1].

56L, d_model 6144, 48 heads GQA kv=8, expert d_ff 16384, vocab 32768,
8 experts top-2. Sliding-window attention per the assignment spec (4096).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, d_ff=16384, vocab=32768,
    n_experts=8, top_k=2, mlp_type="swiglu", rope_theta=1000000.0,
    window=4096, dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_ff=64, vocab=256,
    n_experts=4, top_k=2, capacity_factor=8.0, window=32, dtype="float32", param_dtype="float32",
    q_chunk=16, kv_chunk=16,
)
