"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base; unverified]
"""

from repro_torch.configs.base import ATTN_MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    pattern=(ATTN_MOE,),
    cycles=40,
    mlp_kind="swiglu",
    rope_kind="rope",
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4),
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke",
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    pattern=(ATTN_MOE,),
    cycles=2,
    mlp_kind="swiglu",
    rope_kind="rope",
    moe=MoEConfig(num_experts=4, top_k=2),
    max_seq_len=512,
)
