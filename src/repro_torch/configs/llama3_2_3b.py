"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.

Small llama3.  [hf:meta-llama/Llama-3.2-1B; unverified]
"""

from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    pattern=(ATTN,),
    cycles=28,
    mlp_kind="swiglu",
    rope_kind="rope",
    rope_theta=500_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-3b-smoke",
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    pattern=(ATTN,),
    cycles=2,
    mlp_kind="swiglu",
    rope_kind="rope",
    rope_theta=500_000.0,
    tie_embeddings=True,
    max_seq_len=512,
)
