"""Nemotron-4-340B [arXiv:2402.16819].

96L, d_model 18432, 96 heads GQA kv=8, d_ff 73728, vocab 256000.
Squared-ReLU MLP (no GLU).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv=8, d_ff=73728, vocab=256000,
    mlp_type="relu_sq", rope_theta=10000.0,
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_ff=256, vocab=256,
    dtype="float32", param_dtype="float32", q_chunk=16, kv_chunk=16,
)
