"""Gemma3-1B [hf:google/gemma-3-1b-pt].

26L, d_model 1152, 4 heads MQA kv=1 (d_head 256), d_ff 6912, vocab 262144.
5 local (sliding 512) : 1 global pattern; dual rope theta (10k local / 1M
global); tied embeddings with sqrt(d) scaling; GeGLU.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv=1, d_head=256, d_ff=6912,
    vocab=262144, mlp_type="geglu", rope_theta=10000.0,
    rope_theta_global=1000000.0, window=512, local_global=5,
    tie_embeddings=True, embed_scale=True,
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=7, d_model=48, n_heads=2, n_kv=1, d_head=24, d_ff=96, vocab=256,
    window=16, dtype="float32", param_dtype="float32", q_chunk=16, kv_chunk=16,
)
