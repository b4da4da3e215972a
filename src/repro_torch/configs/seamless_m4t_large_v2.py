"""SeamlessM4T-large-v2 [arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large].

Enc-dec backbone: 24 encoder + 24 decoder layers, d_model 1024, 16 heads,
d_ff 8192, vocab 256206. The speech/text modality frontend is a STUB
(input_specs feed precomputed frame embeddings to the encoder).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=8192,
    vocab=256206, mlp_type="gelu", rope_theta=10000.0, frontend="audio",
    dtype="bfloat16", param_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=256, dtype="float32", param_dtype="float32", q_chunk=16, kv_chunk=16,
)
