"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

RoPE + GQA.  [hf:THUDM/glm-4-9b; hf]
"""

from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    pattern=(ATTN,),
    cycles=40,
    mlp_kind="swiglu",
    rope_kind="rope",
)

SMOKE = ModelConfig(
    name="glm4-9b-smoke",
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=352,
    vocab_size=512,
    pattern=(ATTN,),
    cycles=2,
    mlp_kind="swiglu",
    rope_kind="rope",
    max_seq_len=512,
)
