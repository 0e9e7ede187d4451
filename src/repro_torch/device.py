"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument.

    ``"cuda"`` (the default everywhere) needs a CUDA build of torch and a
    card: without one this raises instead of running on the CPU unasked.
    ``"cpu"`` runs the kernels' plain PyTorch versions.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but CUDA is not available "
                "(torch.cuda.is_available() is False); pass device='cpu' to "
                "run the plain PyTorch kernels on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (use 'cuda' or 'cpu')")
    return dev


@contextlib.contextmanager
def declared_sync(device: torch.device):
    """A host↔device crossing the engine declares (a read the host needs, a
    blocking copy): ``torch.cuda``'s sync debug mode is set to 0 for its
    duration, so that under ``torch.cuda.set_sync_debug_mode("error")``
    only undeclared synchronizations (a boolean mask, ``.item()``, a
    ``nonzero`` inside an operator body) raise."""
    mode = torch.cuda.get_sync_debug_mode() if device.type == "cuda" else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)
