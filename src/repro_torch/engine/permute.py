"""Routing's gather: a batch's columns permuted by the composite sort's order.

NumPy's fancy indexing copies a structured record field by field.  A column
that holds no Python objects and is one C-contiguous dimension is gathered
instead through a view of its raw fixed-width items (``V{itemsize}``) with
one ``np.take``, which copies each item whole and releases the GIL; a long
order is split into contiguous chunks that a small per-process thread pool
takes together.  Every other column (object dtype, strided) is gathered by
``col[order]``.  Either way each result is a fresh array, byte for byte the
one ``col[order]`` gives: the engine's queues keep views into it.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

#: The fewest tuples of a chunk handed to a thread: a gather of ``n`` tuples
#: runs on ``n // CHUNK_MIN_TUPLES`` threads at most, on the calling thread
#: alone below twice this.  Smaller chunks cost more to hand over than they
#: save: ``benchmarks/torch_gather.py`` on the H100 host's CPU, job 3's
#: three columns (int64, 48-byte records, float64; PERF.md, section 6).
CHUNK_MIN_TUPLES = 1 << 15
#: The most threads one gather runs on, the caller's included.
POOL_MAX_THREADS = 8

_pool_lock = threading.Lock()
_pool: tuple[int, Optional[ThreadPoolExecutor], int] = (-1, None, 1)


def takes_view(col: np.ndarray) -> bool:
    """Whether ``permute_columns`` gathers ``col`` through a fixed-width view."""
    return (
        col.ndim == 1
        and col.itemsize > 0
        and not col.dtype.hasobject
        and col.flags.c_contiguous
    )


def _threads() -> tuple[Optional[ThreadPoolExecutor], int]:
    """This process's gather pool and the threads a gather runs on.  Built
    on first use and again in a forked child, whose copy of the parent's
    pool has no threads behind it."""
    global _pool
    pid = os.getpid()
    with _pool_lock:
        if _pool[0] != pid:
            k = min(len(os.sched_getaffinity(0)), POOL_MAX_THREADS)
            ex = ThreadPoolExecutor(k - 1, thread_name_prefix="gather") if k > 1 else None
            _pool = (pid, ex, k)
        return _pool[1], _pool[2]


def permute_columns(order: np.ndarray, *cols: np.ndarray) -> tuple[np.ndarray, ...]:
    """``tuple(col[order] for col in cols)``, at memory speed where a column
    allows.  ``order`` holds indices in ``range(-n, n)`` for columns of
    length ``n``, as the composite sort's permutation does."""
    n = len(order)
    outs, pairs = [], []
    for col in cols:
        if takes_view(col):
            out = np.empty(n, col.dtype)
            raw = np.dtype((np.void, col.itemsize))
            pairs.append((col.view(raw), out.view(raw)))
        else:
            out = col[order]
        outs.append(out)
    pool, k = None, 1
    if pairs and n >= 2 * CHUNK_MIN_TUPLES:
        pool, threads = _threads()
        k = min(threads, n // CHUNK_MIN_TUPLES)

    # mode="wrap" reads indices as col[order] does and, unlike "raise",
    # writes straight into ``out`` without a buffer.
    def take(a: int, z: int) -> None:
        idx = order[a:z]
        for src, dst in pairs:
            np.take(src, idx, out=dst[a:z], mode="wrap")

    if k <= 1:
        take(0, n)
    else:
        bounds = [n * i // k for i in range(k + 1)]
        futures = [pool.submit(take, bounds[i], bounds[i + 1]) for i in range(1, k)]
        take(bounds[0], bounds[1])
        for f in futures:
            f.result()
    return tuple(outs)
