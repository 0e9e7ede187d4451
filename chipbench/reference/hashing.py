"""Frozen copy of the engine's partition hash, for the plain references.

Copied from ``src/repro_torch/engine/topology.py`` as of commit 1b40d26
(``mix32_scalar``, ``mix32``'s arithmetic, ``hash_key``, and
``Topology.keygroup_of``'s ``base + hash % num_keygroups``), written over
uint64 lanes without the original's 32-bit shortcuts.  Integer keys take
the 32-bit mix; any other key takes Python's ``hash``, which is salted per
interpreter: the harness fixes ``PYTHONHASHSEED`` from the run's seed, and
the reference runs in the program's process, so both place a string key
alike.  ``chipbench/tests/test_chipbench_reference.py`` holds this copy
equal to the port's.
"""

from __future__ import annotations

import numpy as np

_MIX_C1 = 0x85EBCA6B
_MIX_C2 = 0xC2B2AE35
MASK31 = 0x7FFFFFFF


def mix32(x: np.ndarray) -> np.ndarray:
    """The 32-bit finisher over the 64→32 folded integer key, as uint64."""
    u = np.asarray(x).astype(np.int64).view(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    h = (u ^ (u >> np.uint64(32))) & m32
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(_MIX_C1)) & m32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(_MIX_C2)) & m32
    h ^= h >> np.uint64(16)
    return h


def int_keygroups(keys: np.ndarray, base: int, nkg: int) -> np.ndarray:
    """Global key-group id of each integer key (int64)."""
    h = (mix32(keys) & np.uint64(MASK31)).astype(np.int64)
    return base + h % nkg


def hash_key(x: object) -> int:
    """31-bit partition hash of one key: the mix for ints, ``hash`` else."""
    if type(x) is int or isinstance(x, np.integer):
        return int(mix32(np.array([x]))[0]) & MASK31
    return hash(x) & MASK31


def keygroup_of(key: object, base: int, nkg: int) -> int:
    return base + hash_key(key) % nkg
