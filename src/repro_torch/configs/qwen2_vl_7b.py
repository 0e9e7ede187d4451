"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE + dynamic resolution; the vision frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed patch embeddings.
[arXiv:2409.12191; hf]
"""

from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    pattern=(ATTN,),
    cycles=28,
    mlp_kind="swiglu",
    rope_kind="mrope",
    rope_theta=1_000_000.0,
    decoder_only_inputs_embeds=True,
)

SMOKE = ModelConfig(
    name="qwen2-vl-7b-smoke",
    d_model=112,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    pattern=(ATTN,),
    cycles=2,
    mlp_kind="swiglu",
    rope_kind="mrope",
    decoder_only_inputs_embeds=True,
    max_seq_len=512,
)
