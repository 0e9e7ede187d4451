"""Routing table: key group → node, with redirect/buffer for direct migration.

During a migration of g_k from n1 to n2 (paper §3):

  * `redirect(k, n2)` flips the table immediately — upstream sends for g_k now
    land at n2 and are *buffered* there (n2 does not own σ_k yet); the work
    already queued at n1 is extracted engine-side and ships inside the
    serialize envelope instead (see repro_torch.engine.serde);
  * `install(...)` (driven by the engine's StateMover) hands σ_k over, after
    which `complete(k)` returns the buffered tuples for replay — behind the
    shipped backlog, preserving FIFO — and the key group resumes at n2.
"""

from __future__ import annotations

import numpy as np

from repro_torch.engine.topology import Batch, empty_batch


class Router:
    def __init__(self, num_keygroups: int, initial_alloc: np.ndarray) -> None:
        if len(initial_alloc) != num_keygroups:
            raise ValueError("alloc length mismatch")
        self.table = np.asarray(initial_alloc, dtype=np.int64).copy()
        # Bumped on every table mutation — consumers that cache a derived
        # view of the table (the superstep runtime keeps device-resident
        # copies) re-read when the version moves; this is the per-superstep
        # reconfiguration hook.
        self.version = 0
        self._buffers: dict[int, list[Batch]] = {}
        self._in_flight: set[int] = set()
        self._in_flight_arr = np.empty(0, dtype=np.int64)  # sorted cache

    # -- routing -------------------------------------------------------------
    def node_of(self, kg: int) -> int:
        return int(self.table[kg])

    def nodes_of(self, kgs: np.ndarray) -> np.ndarray:
        """Vectorized table lookup: target node per key group."""
        return self.table[kgs]

    def has_in_flight(self) -> bool:
        return bool(self._in_flight)

    def is_in_flight(self, kg: int) -> bool:
        return kg in self._in_flight

    def in_flight_mask(self, kgs: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`is_in_flight` over an array of key-group ids."""
        return np.isin(kgs, self._in_flight_arr)

    def buffer(self, kg: int, batch: Batch) -> None:
        """Hold a batch for a key group whose migration is in flight."""
        self._buffers.setdefault(kg, []).append(batch)

    # -- migration protocol ----------------------------------------------------
    def redirect(self, kg: int, dst: int) -> None:
        self.table[kg] = dst
        self.version += 1
        self._in_flight.add(kg)
        self._in_flight_arr = np.fromiter(self._in_flight, dtype=np.int64)
        self._buffers.setdefault(kg, [])

    def complete(self, kg: int) -> list[Batch]:
        """State installed at dst: stop buffering, return tuples to replay."""
        self._in_flight.discard(kg)
        self._in_flight_arr = np.fromiter(self._in_flight, dtype=np.int64)
        return self._buffers.pop(kg, [])

    @property
    def in_flight(self) -> set[int]:
        return set(self._in_flight)

    def keygroups_on(self, node: int) -> np.ndarray:
        return np.where(self.table == node)[0]

    # -- recovery --------------------------------------------------------------
    def reset(self, table: np.ndarray) -> None:
        """Adopt ``table`` wholesale and drop every transient (restore path).

        Buffered batches and in-flight markers describe migrations that no
        longer exist after a checkpoint rewind — the replacement state comes
        from the checkpoint envelopes, not from a serialize handoff.
        """
        if len(table) != len(self.table):
            raise ValueError("reset table length mismatch")
        self.table[:] = np.asarray(table, dtype=np.int64)
        self.version += 1
        self._buffers.clear()
        self._in_flight.clear()
        self._in_flight_arr = np.empty(0, dtype=np.int64)


def concat_batches(batches: list[Batch]) -> Batch:
    if not batches:
        return empty_batch()
    ks = np.concatenate([b[0] for b in batches])
    vs = np.concatenate([b[1] for b in batches])
    ts = np.concatenate([b[2] for b in batches])
    return ks, vs, ts
