"""Qwen2-VL-2B [arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B] — backbone only.

28L, d_model 1536, 12 heads GQA kv=2, d_ff 8960, vocab 151936. M-RoPE;
dynamic-resolution vision frontend is a STUB: input_specs feed precomputed
patch/text embeddings plus 3-stream positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960, vocab=151936,
    mlp_type="swiglu", rope="mrope", rope_theta=1000000.0, frontend="vision",
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=48, n_heads=6, n_kv=2, d_ff=96, vocab=256,
    dtype="float32", param_dtype="float32", q_chunk=16, kv_chunk=16,
)
