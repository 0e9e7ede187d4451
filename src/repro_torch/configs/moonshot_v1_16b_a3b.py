"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""

from repro_torch.configs.base import ATTN_MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    pattern=(ATTN_MOE,),
    cycles=48,
    mlp_kind="swiglu",
    rope_kind="rope",
    moe=MoEConfig(num_experts=64, top_k=6),
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke",
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    pattern=(ATTN_MOE,),
    cycles=2,
    mlp_kind="swiglu",
    rope_kind="rope",
    moe=MoEConfig(num_experts=8, top_k=2),
    max_seq_len=512,
)
