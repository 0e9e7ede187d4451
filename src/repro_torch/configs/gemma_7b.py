"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.

GeGLU, head_dim=256 (MQA on the 2b sibling).  [arXiv:2403.08295; hf]
"""

from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    pattern=(ATTN,),
    cycles=28,
    head_dim=256,
    mlp_kind="geglu",
    rope_kind="rope",
    tie_embeddings=True,
    logits_softcap=30.0,
)

SMOKE = ModelConfig(
    name="gemma-7b-smoke",
    d_model=96,
    num_heads=4,
    num_kv_heads=4,
    d_ff=384,
    vocab_size=512,
    pattern=(ATTN,),
    cycles=2,
    head_dim=32,
    mlp_kind="geglu",
    rope_kind="rope",
    tie_embeddings=True,
    logits_softcap=30.0,
    max_seq_len=512,
)
