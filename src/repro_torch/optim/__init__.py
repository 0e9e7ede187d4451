"""Optimizer substrate (the port of ``repro.optim``): AdamW with float32
state over (possibly bfloat16) parameters, learning-rate schedules, and
int8 gradient compression for slow links."""

from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.compress import compress_int8, decompress_int8
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = [
    "AdamW",
    "AdamWState",
    "cosine_schedule",
    "linear_warmup",
    "compress_int8",
    "decompress_int8",
]
