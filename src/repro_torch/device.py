"""Device selection for the port's entry points."""

from __future__ import annotations

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
