"""LM workloads hosted by the framework (serving and training).

A single :class:`repro_torch.models.transformer.Model` assembles a config's
block pattern; parameters and caches keep the reference's stacked trees,
and a Python loop over layers takes the place of ``lax.scan``.  Every
family of the repo's configs runs: the dense and MoE transformers,
RecurrentGemma's RG-LRU, xLSTM's mLSTM and sLSTM blocks
(:mod:`repro_torch.models.xlstm`) and Whisper's encoder-decoder path.  On
the card, attention (self, encoder and cross) runs the hand-written flash
and decode kernels, forward and (through their autograd Functions) in
training.
"""

from repro_torch.models.transformer import (
    Model,
    init_params,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = [
    "Model",
    "init_params",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
]
