"""Sharded token pipeline for the LM workloads (the port of
``repro.data.pipeline``: numpy only, batches byte-identical to the
reference's for the same config, seed, step and restored cursor).

A deterministic, restartable synthetic-token stream (offline container):
each *data shard* owns a disjoint key range; the cursor (shard, step) is
checkpointed so restarts resume exactly.  Shards are the paper's key groups
on the training plane: per-shard throughput statistics feed the controller's
``gLoad_k`` and the MILP's heterogeneous-capacity rebalancing assigns shards
to (possibly unequal) workers — see repro_torch/launch/train.py.

Double-buffered host prefetch keeps the input pipeline off the step's
critical path.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_shards: int = 16
    seed: int = 0


class TokenPipeline:
    """Deterministic restartable synthetic LM batches."""

    def __init__(self, config: PipelineConfig, *, start_step: int = 0) -> None:
        self.config = config
        self.step = start_step
        if config.global_batch % config.num_shards != 0:
            raise ValueError("global_batch must divide into shards")
        self.per_shard = config.global_batch // config.num_shards
        # Shard→worker assignment: the controller's rebalancing lever.
        self.shard_assignment = np.arange(config.num_shards)

    def cursor(self) -> dict:
        return {"step": self.step, "assignment": self.shard_assignment.copy()}

    def restore(self, cursor: dict) -> None:
        self.step = int(cursor["step"])
        self.shard_assignment = np.asarray(cursor["assignment"])

    def _shard_batch(self, shard: int, step: int) -> np.ndarray:
        cfg = self.config
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + shard) * 1_000_003 + step
        )
        # Zipf-ish token distribution: realistic softmax pressure.
        toks = rng.zipf(1.2, size=(self.per_shard, cfg.seq_len + 1))
        return np.minimum(toks, cfg.vocab_size - 1).astype(np.int32)

    def next_batch(self) -> dict[str, np.ndarray]:
        cfg = self.config
        rows = [self._shard_batch(s, self.step) for s in range(cfg.num_shards)]
        data = np.concatenate(rows, axis=0)
        self.step += 1
        return {"tokens": data[:, :-1], "labels": data[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


class Prefetcher:
    """Double-buffered background prefetch over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = False
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self) -> None:
        try:
            for item in self._it:
                self._q.put(item)
                if self._done:
                    return
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self) -> None:
        self._done = True


@dataclasses.dataclass
class ShardStats:
    """Per-shard throughput statistics → ClusterState for the controller."""

    num_shards: int

    def __post_init__(self) -> None:
        self.tokens = np.zeros(self.num_shards)
        self.seconds = np.zeros(self.num_shards)

    def record(self, shard: int, tokens: int, seconds: float) -> None:
        self.tokens[shard] += tokens
        self.seconds[shard] += seconds

    def loads(self) -> np.ndarray:
        """Load per shard: time share, in percent of the period."""
        total = self.seconds.sum()
        if total <= 0:
            return np.zeros(self.num_shards)
        return 100.0 * self.seconds / total

    def reset(self) -> None:
        self.tokens[:] = 0
        self.seconds[:] = 0
