"""LM workloads hosted by the framework (serving and training).

A single :class:`repro_torch.models.transformer.Model` assembles a config's
block pattern; parameters and caches keep the reference's stacked trees,
and a Python loop over layers takes the place of ``lax.scan``.  On the
card, attention runs the hand-written flash and decode kernels, forward
and (through their autograd Functions) in training.
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
