"""Fault-tolerance substrate: atomic, manifest-versioned, async checkpoints
(the port of ``repro.checkpoint``, without jax)."""

from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    load_pytree,
    save_pytree,
)

__all__ = ["CheckpointManager", "load_pytree", "save_pytree"]
