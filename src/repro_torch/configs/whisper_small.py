"""whisper-small [audio] — 12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.

Encoder–decoder; the conv frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings.
[arXiv:2212.04356; unverified]
"""

from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    pattern=(ATTN,),
    cycles=12,  # decoder layers
    encoder_layers=12,
    encoder_is_input_embeds=True,
    mlp_kind="gelu",
    rope_kind="learned",
    norm_kind="layernorm",
    max_seq_len=448,
)

SMOKE = ModelConfig(
    name="whisper-small-smoke",
    d_model=96,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    pattern=(ATTN,),
    cycles=2,
    encoder_layers=2,
    encoder_is_input_embeds=True,
    mlp_kind="gelu",
    rope_kind="learned",
    norm_kind="layernorm",
    max_seq_len=448,
)
