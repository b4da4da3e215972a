"""Yi-6B [arXiv:2403.04652; hf:01-ai/Yi-6B].

32L, d_model 4096, 32 heads GQA kv=4, d_ff 11008, vocab 64000. Llama-style.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=4, d_ff=11008, vocab=64000,
    mlp_type="swiglu", rope_theta=5000000.0,
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_ff=128, vocab=256,
    dtype="float32", param_dtype="float32", q_chunk=16, kv_chunk=16,
)
