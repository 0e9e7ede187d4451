"""PyTorch/CUDA port of the stream processing engine (``repro``).

The reference package ``repro`` (JAX, Pallas TPU kernels) stays as it is;
this package is its port to one NVIDIA H100.  It imports ``torch``, numpy
and scipy, never ``jax`` and nothing of ``repro``: every module it needs is
its own copy, under the reference's module names.

This slice carries the classic engine tick and the ALBIC controller
(:class:`repro_torch.engine.Engine`, :class:`repro_torch.engine.Controller`)
with routing on the card: the hash partition plus arrival histogram and the
``(node, key group)`` composite sort run as hand-written CUDA kernels
(:mod:`repro_torch.kernels`).  Entry points take ``device=`` and default to
``"cuda"``; ``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
