"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
import time

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


def capture_graph(fn, stream: "torch.cuda.Stream"):
    """Capture ``fn()`` into a CUDA graph on ``stream``.

    One eager warm-up call on ``stream`` comes first: it builds what the
    kernel wrappers keep per (device, stream), such as keygroup_partition's
    scratch words, so that nothing is allocated or zeroed for the first time
    inside the graph.  Warm-up and capture run as a declared sync (the
    capture synchronizes the device).  Returns the graph, the outputs of the
    captured call (the graph's static outputs, which each replay
    overwrites) and ``{"warmup_seconds", "capture_seconds", "launches"}``,
    where ``launches`` are the kernel launches the wrappers recorded into
    the graph: each replay makes them again without counting them.  A
    capture that fails raises.
    """
    from repro_torch.kernels import launch_counts

    dev = stream.device
    with declared_sync(dev):
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph, stream=stream):
            out = fn()
        launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    info = dict(warmup_seconds=t1 - t0, capture_seconds=time.perf_counter() - t1,
                launches=launches)
    return graph, out, info
