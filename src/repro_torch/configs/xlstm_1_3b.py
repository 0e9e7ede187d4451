"""xlstm-1.3b [ssm] — 48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304.

sLSTM + mLSTM blocks at the xLSTM[7:1] ratio: 48 = 6 × (7 mLSTM + 1 sLSTM).
d_ff=0: blocks carry their own up/down projections (no separate FFN).
Constant-size matrix memory → long_500k runs.  [arXiv:2405.04517; unverified]
"""

from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=(MLSTM,) * 7 + (SLSTM,),
    cycles=6,
    mlp_kind="gelu",
    rope_kind="none",
    norm_kind="layernorm",
)

SMOKE = ModelConfig(
    name="xlstm-1.3b-smoke",
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    pattern=(MLSTM, MLSTM, MLSTM, SLSTM),
    cycles=1,
    mlp_kind="gelu",
    rope_kind="none",
    norm_kind="layernorm",
    max_seq_len=512,
)
