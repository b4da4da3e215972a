"""OLMoE-1B-7B [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924].

16L, d_model 2048, 16 heads (kv=16 — full MHA), expert d_ff 1024, vocab 50304,
64 experts top-8. SwiGLU experts, RoPE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, mlp_type="swiglu", rope_theta=10000.0,
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=32, vocab=256,
    n_experts=8, top_k=2, capacity_factor=8.0, dtype="float32", param_dtype="float32",
    q_chunk=32, kv_chunk=32, ssm_chunk=16,
)
