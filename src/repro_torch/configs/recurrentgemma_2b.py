"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000.  RG-LRU + local attention, 1 attention per 3 blocks (2:1).
[arXiv:2402.19427; hf]

26 layers = 8 × (rglru, rglru, local_attn) + (rglru, rglru) remainder.
Sub-quadratic: local window 2048 + O(1) recurrent state → long_500k runs.
"""

from repro_torch.configs.base import LOCAL_ATTN, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    cycles=8,
    remainder=(RGLRU, RGLRU),
    head_dim=256,
    mlp_kind="geglu",
    rope_kind="rope",
    local_window=2048,
    lru_width=2560,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    d_model=96,
    num_heads=2,
    num_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    cycles=1,
    remainder=(RGLRU, RGLRU),
    head_dim=48,
    mlp_kind="geglu",
    rope_kind="rope",
    local_window=64,
    lru_width=96,
    tie_embeddings=True,
    max_seq_len=512,
)
