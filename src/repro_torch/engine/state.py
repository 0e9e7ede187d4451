"""Keyed state store: the σ_k of every key group, with direct-migration codecs.

State is a plain dict per key group (operators put whatever they need in it —
counters, windows, jnp arrays).  Serialization uses pickle over a numpy-
friendly normal form; sizes feed the migration cost model mc_k = α·|σ_k|.
This codec covers the *state* half of a migration blob only — the engine
wraps it in an envelope that also carries the key group's queued segments
(repro_torch.engine.serde), without affecting the |σ_k| sizes measured here.
"""

from __future__ import annotations

import pickle
from typing import Iterator

import numpy as np

from repro_torch.engine.serde import loads


class KeyedStore:
    """σ_k for all key groups of a job, owned by logical nodes."""

    def __init__(self, num_keygroups: int) -> None:
        self._state: list[dict] = [dict() for _ in range(num_keygroups)]
        self._sizes = np.zeros(num_keygroups)  # cached |σ_k| estimates

    def get(self, kg: int) -> dict:
        return self._state[kg]

    def put(self, kg: int, state: dict) -> None:
        self._state[kg] = state

    def raw(self) -> list[dict]:
        """The underlying per-key-group state list (hot-path access)."""
        return self._state

    def serialize(self, kg: int) -> bytes:
        blob = pickle.dumps(self._state[kg], protocol=pickle.HIGHEST_PROTOCOL)
        self._sizes[kg] = len(blob)
        return blob

    def deserialize(self, kg: int, blob: bytes) -> None:
        self._state[kg] = loads(blob)
        self._sizes[kg] = len(blob)

    def state_bytes(self, refresh: bool = False) -> np.ndarray:
        """|σ_k| vector.  `refresh` re-measures every key group (slow path)."""
        if refresh:
            for kg in range(len(self._state)):
                try:
                    self._sizes[kg] = len(
                        pickle.dumps(self._state[kg], protocol=pickle.HIGHEST_PROTOCOL)
                    )
                except Exception:
                    self._sizes[kg] = 64.0
        return np.maximum(self._sizes, 64.0)  # floor: even empty state has framing

    def items(self) -> Iterator[tuple[int, dict]]:
        return enumerate(self._state)

    def __len__(self) -> int:
        return len(self._state)
