"""Engine checkpoints: one consistent snapshot under one atomic manifest.

A checkpoint captures everything the control plane needs to rebuild a
consistent engine at a period-ish boundary:

* the routing table (including replica slots),
* every key group's state envelope — σ_k plus any *parked* migration
  backlog, exported non-destructively (unlike ``Engine.serialize`` this
  never pops the backlog: checkpointing must not mutate the engine),
* hot-key split topology and the round-robin fan-out cursors (replica
  placement is bit-exact across a restore — the cursor is part of the
  data-plane state),
* the partial SPL window (usage, arrivals, pair sends) and the period's
  tick count, so the first post-restore ``end_period`` folds the same
  statistics the original would have,
* the ingestion cursor — how many source batches were admitted — so a
  supervisor can replay exactly the admissions after the cut.

What it deliberately does **not** capture: tuples sitting in work queues
or router in-flight buffers at the cut.  Their effects up to the cut are
in σ; re-processing after a rewind is covered by replaying admissions
*after* the cursor.  Queued-but-unprocessed tuples from admissions
*before* the cursor are the loss bound of a recovery — bounded by the
credit window, see docs/fault_tolerance.md.

The snapshot is a plain dict pickled into one uint8 leaf of a
:func:`repro_torch.checkpoint.checkpoint.save_pytree` tree, so the atomic
stage-and-rename commit (manifest written last) applies unchanged.  Both
the single-process :class:`~repro_torch.engine.executor.Engine` and the
multi-worker coordinator produce this payload shape — recovery conformance
tests restore a cluster-written checkpoint into a single-process oracle.

The port of ``repro.engine.checkpointing``: the payload holds only numpy
arrays, ints and serde envelopes, so it is the reference's payload, and a
checkpoint written by either package restores an engine of the other
(``arrays.npz``'s one leaf read through :func:`payload_from_tree`; the
``treedef.pkl`` beside it is each package's own, see
:mod:`repro_torch.checkpoint.checkpoint`).  On the card
:func:`snapshot_payload` materializes the fused superstep's device pendings
and the compiled tier's device columns first (declared syncs).
"""

from __future__ import annotations

import pickle
from typing import Any, Optional

import numpy as np

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.engine import serde
from repro_torch.engine.config import CheckpointPolicy

PAYLOAD_VERSION = 1


# -- building blocks ----------------------------------------------------------
def keygroup_blob(engine, kg: int) -> bytes:
    """Non-destructive checkpoint envelope for one key group.

    ``Engine.serialize`` *pops* the parked migration backlog into the blob
    (migration hand-off semantics); a checkpoint must leave the engine
    untouched, so the backlog is copied, never popped.
    """
    if getattr(engine, "_jit", None) is not None:
        engine._jit.ensure_dict(kg)
    return serde.encode_migration(
        engine.store.serialize(kg), list(engine._backlog.get(kg, []))
    )


def window_peek(window) -> dict:
    """Copy the partial SPL window without folding or resetting it."""
    pairs = window.pair_counts()  # compacts in place; non-destructive
    return {
        "usage": {r: u.copy() for r, u in window.kg_usage.items()},
        "arrivals": window.kg_arrivals.copy(),
        "pairs": (pairs.src.copy(), pairs.dst.copy(), pairs.rate.copy()),
        "samples": int(window.samples),
    }


def window_restore(window, peek: dict) -> None:
    window.reset()
    for r, u in peek["usage"].items():
        window.kg_usage[r][:] = u
    window.kg_arrivals[:] = peek["arrivals"]
    src, dst, rate = peek["pairs"]
    if len(src):
        window.record_send_counts(src, dst, rate)
    window.samples = int(peek["samples"])


def window_merge(into: dict, part: dict) -> None:
    """Fold one worker's window peek into an accumulating peek dict."""
    for r, u in part["usage"].items():
        into["usage"][r] = into["usage"].get(r, 0) + u
    into["arrivals"] = into["arrivals"] + part["arrivals"]
    src, dst, rate = part["pairs"]
    isrc, idst, irate = into["pairs"]
    into["pairs"] = (
        np.concatenate([isrc, src]),
        np.concatenate([idst, dst]),
        np.concatenate([irate, rate]),
    )
    into["samples"] = int(into.get("samples", 0)) + int(part["samples"])


def empty_window_peek(g: int, resources=("cpu", "network", "memory")) -> dict:
    z = np.zeros(0, dtype=np.int64)
    return {
        "usage": {r: np.zeros(g) for r in resources},
        "arrivals": np.zeros(g),
        "pairs": (z, z, np.zeros(0)),
        "samples": 0,
    }


def split_state(engine) -> dict:
    return {
        "map": {int(p): [int(s) for s in fam] for p, fam in engine._split_map.items()},
        "rr": {int(p): int(c) for p, c in engine._split_rr.items()},
        "free": [int(s) for s in engine._free_slots],
        "kg_op": engine._kg_op.copy(),
    }


# -- single-process snapshot / restore ---------------------------------------
def snapshot_payload(engine, *, ingest_cursor: Optional[int] = None) -> dict:
    """One consistent snapshot of a single-process engine (a dict).

    The multi-worker coordinator assembles the same shape from worker
    exports (see :mod:`repro_torch.engine.supervisor`).
    """
    if getattr(engine, "_superstep", None) is not None:
        engine._superstep.flush_to_host()
    if getattr(engine, "_jit", None) is not None:
        engine._jit.sync_store()
    g_eff = len(engine.router.table)
    cursor = engine.ingest_cursor if ingest_cursor is None else int(ingest_cursor)
    return {
        "version": PAYLOAD_VERSION,
        "table": engine.router.table.copy(),
        "alive": engine.alive.copy(),
        "capacity": engine.capacity.copy(),
        "num_nodes": int(engine.num_nodes),
        "envelopes": {kg: keygroup_blob(engine, kg) for kg in range(g_eff)},
        "split": split_state(engine),
        "window": window_peek(engine.window),
        "ticks_this_period": int(engine._ticks_this_period),
        "ticks": int(engine.metrics.ticks),
        "ingest_cursor": cursor,
        "sink_len": len(engine.metrics.sink_outputs),
    }


def restore_engine(engine, payload: dict) -> None:
    """Rewind a single-process engine to a checkpoint payload, in place.

    The engine must have been built from the same topology/config family
    (same extended key-group space).  Transients — queued runs, parked
    backlogs, pending outputs, router buffers — are dropped; σ comes from
    the envelopes, statistics from the window peek.  Cumulative metrics
    and collected sinks are left alone (a restore is not amnesia: emitted
    duplicates are measured, not erased).
    """
    if payload.get("version") != PAYLOAD_VERSION:
        raise ValueError(f"unknown checkpoint payload version {payload.get('version')}")
    g_eff = len(engine.router.table)
    if len(payload["table"]) != g_eff:
        raise ValueError(
            "checkpoint key-group space mismatch: "
            f"{len(payload['table'])} != {g_eff}"
        )
    if getattr(engine, "_superstep", None) is not None:
        engine._superstep.flush_to_host()
    if int(payload["num_nodes"]) > engine.num_nodes:
        engine.add_nodes(int(payload["num_nodes"]) - engine.num_nodes)
    for q in engine._queues:
        q.clear()
    engine._backlog.clear()
    engine._out_pending.clear()
    engine.router.reset(payload["table"])
    engine.alive[: len(payload["alive"])] = payload["alive"]
    engine.capacity[: len(payload["capacity"])] = payload["capacity"]
    engine._capacity_list = engine.capacity.tolist()
    # Split topology + fan-out cursors before installs (kg → operator).
    sp = payload["split"]
    engine._split_map = {int(p): list(f) for p, f in sp["map"].items()}
    engine._split_parent = {
        int(s): int(p) for p, fam in sp["map"].items() for s in fam
    }
    engine._split_rr = {int(p): int(c) for p, c in sp["rr"].items()}
    engine._free_slots = list(sp["free"])
    engine._kg_op = np.asarray(sp["kg_op"], dtype=np.int64).copy()
    engine._rebuild_split_tables()
    # σ: wipe, then install every envelope at its checkpointed node.
    table = payload["table"]
    for kg in range(g_eff):
        engine.store.put(kg, {})
    for kg in sorted(payload["envelopes"]):
        engine.install(int(kg), int(table[kg]), payload["envelopes"][kg])
    window_restore(engine.window, payload["window"])
    engine._ticks_this_period = int(payload["ticks_this_period"])
    engine.ingest_cursor = int(payload["ingest_cursor"])


# -- manifest plumbing --------------------------------------------------------
def payload_to_tree(payload: dict) -> dict:
    """Pack the payload as a one-leaf pytree for ``save_pytree``."""
    return {"payload_u8": np.frombuffer(pickle.dumps(payload), dtype=np.uint8)}


def payload_from_tree(tree: Any) -> dict:
    """The payload of a checkpoint tree, from either package (classes the
    reference pickled under ``repro.*`` — a cluster checkpoint's folded
    ``ClusterState`` — resolve to the port's copies)."""
    leaf = np.asarray(tree["payload_u8"], dtype=np.uint8)
    return serde.loads(leaf.tobytes())


class EngineCheckpointer:
    """Drives :class:`CheckpointManager` from a :class:`CheckpointPolicy`.

    ``note_period`` is the cadence hook — call it once per ``end_period``;
    every ``policy.every``-th call commits a checkpoint synchronously (the
    atomic stage-and-rename is the commit point).  ``step`` is the engine's
    cumulative tick count: unique, monotone, and meaningful in logs.
    """

    def __init__(self, policy: CheckpointPolicy) -> None:
        self.policy = policy
        self.manager = CheckpointManager(policy.directory, keep=policy.keep)
        self.periods_seen = 0

    def note_period(self, engine) -> Optional[int]:
        self.periods_seen += 1
        if self.periods_seen % self.policy.every:
            return None
        return self.save(engine)

    def save(self, engine, *, payload: Optional[dict] = None) -> int:
        payload = snapshot_payload(engine) if payload is None else payload
        step = int(payload["ticks"])
        self.manager.save(
            step,
            payload_to_tree(payload),
            metadata={
                "period": self.periods_seen,
                "ingest_cursor": int(payload["ingest_cursor"]),
                "sink_len": int(payload["sink_len"]),
            },
        )
        return step

    def latest_payload(self) -> tuple[Optional[dict], dict]:
        """(payload, metadata) of the newest complete checkpoint, or (None, {})."""
        if self.manager.latest_step() is None:
            return None, {}
        tree, meta = self.manager.restore()
        return payload_from_tree(tree), meta
