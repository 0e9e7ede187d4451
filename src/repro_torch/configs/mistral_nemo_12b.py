"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx, head_dim=128.  [hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""

from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    pattern=(ATTN,),
    cycles=40,
    head_dim=128,
    mlp_kind="swiglu",
    rope_kind="rope",
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
)

SMOKE = ModelConfig(
    name="mistral-nemo-12b-smoke",
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=384,
    vocab_size=512,
    pattern=(ATTN,),
    cycles=2,
    head_dim=32,
    mlp_kind="swiglu",
    rope_kind="rope",
    rope_theta=1_000_000.0,
    max_seq_len=512,
)
