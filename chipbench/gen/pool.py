"""The benchmark's one load generator: a pool of distinct batches from a
frozen stream, replayed as an endless stream of tuples.

A configuration names the stream (a function of :mod:`chipbench.gen.streams`)
and its parameters; a traffic mix names the batch size and how many distinct
batches set-up makes.  Stream tick ``s`` is pool batch ``s % count``: its
tuples carry timestamp ``s``, and the stream's ``RETIME`` hook rewrites what
else follows the tick (the airline year), so windows and years keep
advancing through every cycle.  Every hand-over is a fresh array.
"""

from __future__ import annotations

import numpy as np

from chipbench.gen import streams


class Pool:
    """``count`` batches of exactly ``batch`` tuples each, drawn from
    ``streams.<stream>(StreamSpec(seed=seed), **params)``."""

    def __init__(self, stream: str, params: dict, batch: int, count: int, seed: int):
        make = getattr(streams, stream)
        # The rate sits 8 standard deviations above the batch, so every
        # Poisson draw covers it; the draw is cut to the batch.
        spec = streams.StreamSpec(
            rate=batch + 8 * batch**0.5 + 64, fluctuation=0.0, seed=seed
        )
        it = make(spec, **params)
        self.batches = []
        for i in range(count):
            k, v, _ = next(it)
            if len(k) < batch:
                raise RuntimeError(f"{stream} drew {len(k)} < {batch} tuples at tick {i}")
            self.batches.append((k[:batch].copy(), v[:batch].copy()))
        self.batch_size = batch
        self.count = count
        self._retime = streams.RETIME.get(stream)

    def tuples(self, a: int, b: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fresh ``(keys, values, ts)`` of stream tuples ``[a, b)``."""
        size = self.batch_size
        parts = []
        s = a // size
        while s * size < b:
            lo, hi = max(a, s * size) - s * size, min(b, (s + 1) * size) - s * size
            k, v = self.batches[s % self.count]
            v = v[lo:hi].copy()
            if self._retime is not None:
                self._retime(v, s)
            parts.append((k[lo:hi].copy(), v, np.full(hi - lo, float(s))))
            s += 1
        if len(parts) == 1:
            return parts[0]
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))

    def batch(self, s: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fresh arrays of stream tick ``s``'s whole batch."""
        return self.tuples(s * self.batch_size, (s + 1) * self.batch_size)
