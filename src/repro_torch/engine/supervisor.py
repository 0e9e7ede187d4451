"""Cluster supervision: liveness, periodic checkpoints, worker respawn.

The :class:`Supervisor` rides inside the coordinator and closes the loop
the fault-injection tests open:

* **Liveness** — every worker heartbeats over its report queue after each
  command (:func:`repro_torch.engine.cluster._worker_main`).  A worker with
  outstanding commands and no message for ``hb_interval_s * hb_misses``
  seconds is *wedged, not dead* — the supervisor escalates it to SIGKILL
  (``escalate_wedged``), turning a hang into the crash the recovery path
  already handles.  The deadline must exceed the worst legitimate tick
  time: a worker mid-tick is silent by design (see
  docs/fault_tolerance.md).
* **Checkpoints** — every ``CheckpointPolicy.every``-th period boundary,
  ``note_period`` assembles one consistent payload from worker exports
  (σ + parked backlog per key group, non-destructively), the routing
  table, the folded :class:`~repro_torch.core.stats.ClusterState` and the
  ingestion cursor, and commits it through the atomic stage-and-rename
  manifest (:mod:`repro_torch.engine.checkpointing`).  The coordinator's replay
  buffer is pruned to admissions after the cut.
* **Recovery = reconfiguration** — on worker death, ``recover`` rewinds
  the whole cluster to the latest checkpoint: barrier on in-flight ticks,
  bounded-backoff respawn over fresh exchange lanes, survivors re-attach
  via ``peer_up``, every worker adopts the checkpoint table (re-homed
  through ALBIC or the MILP — the same allocators that drive planned
  reconfiguration, with orphan state bytes zeroed since their envelopes
  ship from the checkpoint, not a live node), envelopes reinstall at
  their new homes, and the coordinator replays buffered post-checkpoint
  admissions one tick each.  Everything after the recovery's sink mark is
  bit-identical to a fresh engine restored from the same checkpoint and
  fed the same batches (pinned by tests/test_supervisor.py).

A rewind is not amnesia: sinks emitted between the checkpoint and the
crash stay in ``metrics.sink_outputs`` and are re-emitted by the replay —
recovery is at-least-once across the cut, and the duplicate/loss
accounting is measured by ``benchmarks/fault_recovery.py``.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.engine import checkpointing
from repro_torch.engine.checkpointing import EngineCheckpointer


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """What one recovery attempt did (``ClusterEngine.recoveries``)."""

    worker: int
    cause: str  # "kill" | "hang" | "delay" | "wedged" | "crash"
    respawn_attempt: int
    mttr_s: float  # death detection → cluster serving again
    gave_up: bool = False  # respawn budget exhausted: fail_node semantics
    restored_step: int = -1  # checkpoint step rewound to (-1: from scratch)
    restored_cursor: int = 0  # admissions covered by the checkpoint
    restored_sink_len: int = 0  # sink mark: tail after this is oracle-equal
    orphans: int = 0  # key groups homed on the dead worker at the cut
    rehomed: int = 0  # key groups the allocator moved during recovery
    replayed_batches: int = 0  # buffered admissions re-shipped after rewind


class Supervisor:
    """Per-cluster supervision state machine (coordinator-side, no threads).

    All hooks run on the coordinator's thread at deterministic points —
    ``note_*`` from the report loop, ``escalate_wedged`` from the receive
    poll, ``recover`` from the safe-point scheduler — so supervision never
    races the data plane.
    """

    def __init__(self, cluster) -> None:
        self.cluster = cluster
        self.policy = cluster.config.supervision
        self.checkpointer: Optional[EngineCheckpointer] = (
            EngineCheckpointer(cluster.config.checkpoint)
            if cluster.config.checkpoint is not None
            else None
        )
        self.last_activity: dict[int, float] = {}
        self.last_done: dict[int, int] = {}
        self.cause: dict[int, str] = {}
        self.attempts: dict[int, int] = {}
        for w in range(cluster.num_workers):
            self.note_spawn(w)

    # ------------------------------------------------------------- liveness
    def note_spawn(self, wid: int) -> None:
        self.last_activity[wid] = time.monotonic()
        self.last_done[wid] = 0

    def note_activity(self, wid: int) -> None:
        self.last_activity[wid] = time.monotonic()

    def note_hb(self, wid: int, done: int) -> None:
        self.last_activity[wid] = time.monotonic()
        self.last_done[wid] = done
        if done >= self.cluster.pool.sent_counts[wid] and self.cause.get(
            wid
        ) in ("hang", "delay"):
            # Caught up: an injected hang/delay that ran to completion is
            # no longer this worker's cause of anything.  A noted "kill"
            # sticks — the victim's final heartbeat (drained at death)
            # legitimately shows it caught up.
            self.cause.pop(wid)

    def note_fault(self, wid: int, event) -> None:
        self.cause[wid] = event.kind

    def escalate_wedged(self) -> bool:
        """SIGKILL workers with outstanding commands past the deadline.

        Wedged ≠ dead: the process is alive but its command loop has gone
        silent.  Escalation converts it into the crash the recovery path
        handles.  Returns True if anyone was killed (the caller re-runs
        death detection).
        """
        if self.policy is None:
            return False
        c = self.cluster
        now = time.monotonic()
        overdue = []
        for w in c._alive_workers():
            if c.pool.sent_counts[w] <= self.last_done.get(w, 0):
                continue  # no outstanding work: silence is idleness
            silence = now - self.last_activity.get(w, now)
            if silence <= self.policy.deadline_s:
                continue
            if not c.pool.alive(w):
                continue  # already dead; the poll loop handles it
            overdue.append((silence, w))
        if not overdue:
            return False
        # One victim per pass — the longest-silent worker.  A peer blocked
        # in the BSP exchange *on the victim* advertises liveness with
        # ``hb_wait`` messages (waiting ≠ wedged), so under normal delivery
        # only the true wedge is ever overdue.  The single-victim rule is
        # the backstop for delayed wait-heartbeats: restart everyone else's
        # clock; a genuinely wedged peer goes silent again and is next.
        _, victim = max(overdue)
        self.cause.setdefault(victim, "wedged")
        c.pool.kill(victim)
        for w in c._alive_workers():
            if w != victim:
                self.note_activity(w)
        return True

    # ----------------------------------------------------------- checkpoints
    def note_period(self, state) -> None:
        """Checkpoint cadence hook — called once per ``end_period`` fold."""
        ck = self.checkpointer
        if ck is None:
            return
        ck.periods_seen += 1
        if ck.periods_seen % ck.policy.every:
            return
        payload = self._cluster_payload(state)
        ck.save(None, payload=payload)
        cut = int(payload["ingest_cursor"])
        c = self.cluster
        c._replay = [e for e in c._replay if e[0] > cut]
        # A committed checkpoint is forward progress: reopen the full
        # respawn budget for future failures.
        self.attempts.clear()

    def _cluster_payload(self, state) -> dict:
        """Assemble the engine-checkpoint payload from worker exports.

        Called right after the ``end_period`` fold, so worker windows are
        freshly reset — the checkpointed window is empty and
        ``ticks_this_period`` is 0 by construction, exactly what a
        single-process engine checkpointing at the same boundary records.
        """
        c = self.cluster
        g = c.topology.num_keygroups
        owner = c.node_worker[c.router.table]
        wids = c._alive_workers()
        for w in wids:
            kgs = [int(k) for k in np.flatnonzero(owner == w)]
            c.pool.send(w, ("export_all", kgs))
        envelopes: dict[int, bytes] = {}
        for blobs in c._await_acks(wids, "export_all").values():
            envelopes.update(blobs)
        return {
            "version": checkpointing.PAYLOAD_VERSION,
            "table": c.router.table.copy(),
            "alive": c.alive.copy(),
            "capacity": c.capacity.copy(),
            "num_nodes": int(c.num_nodes),
            "envelopes": envelopes,
            # The cluster runtime never splits hot keys worker-side; the
            # trivial split state keeps the payload oracle-restorable.
            "split": {"map": {}, "rr": {}, "free": [], "kg_op": c._kg_op.copy()},
            "window": checkpointing.empty_window_peek(g, c._window_resources),
            "ticks_this_period": 0,
            "ticks": int(c.metrics.ticks),
            "ingest_cursor": int(c.ingest_cursor),
            "sink_len": len(c.metrics.sink_outputs),
            # The fold that triggered this checkpoint — recovery re-homes
            # against the loads the cluster actually had at the cut.
            "folded_state": state,
        }

    # -------------------------------------------------------------- recovery
    def recover(self, wid: int) -> None:
        """Respawn ``wid`` and rewind the cluster to the latest checkpoint.

        Runs only at safe points (no tick in flight once the barrier
        drains).  If a *second* worker dies mid-recovery the partial work
        is abandoned — the next scheduled recovery redoes the global
        rewind from the same checkpoint, which is idempotent.
        """
        c = self.cluster
        death = c._death_ts.get(wid, time.monotonic())
        cause = self.cause.pop(wid, "crash")
        attempt = self.attempts.get(wid, 0) + 1
        self.attempts[wid] = attempt
        if attempt > self.policy.max_respawns:
            c.recoveries.append(
                RecoveryReport(
                    worker=wid,
                    cause=cause,
                    respawn_attempt=attempt,
                    mttr_s=time.monotonic() - death,
                    gave_up=True,
                )
            )
            return  # stays dead: plain fail_node semantics from here on
        try:
            self._recover(wid, cause, attempt, death)
        except Exception:
            if c._needs_recovery:
                # Another death landed mid-recovery.  Abandon this pass;
                # make sure wid is rescheduled if it never respawned.
                if wid in c._dead_workers and wid not in c._needs_recovery:
                    c._needs_recovery.append(wid)
                return
            raise

    def _recover(self, wid: int, cause: str, attempt: int, death: float) -> None:
        c = self.cluster
        # Barrier: every commanded tick must merge before the rewind, so
        # no exchange is in flight anywhere (survivors' rings are drained,
        # their stashes empty) and `_merge_ready_ticks` never waits on the
        # replacement for a tick commanded to the dead incarnation.
        if c._pending_ticks:
            c._wait_tick(c._pending_ticks[-1])
        payload: Optional[dict] = None
        if self.checkpointer is not None:
            payload, _ = self.checkpointer.latest_payload()
        g = c.topology.num_keygroups
        if payload is None:
            # No checkpoint committed yet: rewind to T0 — the replay
            # buffer holds every admission since start.
            restored_step = -1
            payload = {
                "table": c._initial_alloc.copy(),
                "alive": np.ones(c.num_nodes, dtype=bool),
                "envelopes": {},
                "window": checkpointing.empty_window_peek(
                    g, c._window_resources
                ),
                "ticks_this_period": 0,
                "ingest_cursor": 0,
                "folded_state": None,
            }
        else:
            restored_step = int(payload.get("ticks", -1))
            if int(payload["num_nodes"]) != c.num_nodes:
                raise RuntimeError(
                    "recovery across an elastic resize is not supported: "
                    f"checkpoint has {payload['num_nodes']} nodes, "
                    f"cluster has {c.num_nodes}"
                )
        ck_table = np.asarray(payload["table"], dtype=np.int64)
        orphans = np.flatnonzero(c.node_worker[ck_table] == wid)
        # Alive mask after recovery: the checkpoint's view, minus nodes of
        # workers that are (still) dead.  Explicit fail_node calls after
        # the cut are forgotten — a rewind resurrects what the checkpoint
        # saw (documented in docs/fault_tolerance.md).
        new_alive = np.asarray(payload["alive"], dtype=bool).copy()
        for w2 in c._dead_workers:
            if w2 != wid:
                new_alive[c.node_worker == w2] = False
        # Re-home against post-recovery capacity (the respawn brings the
        # dead worker's nodes back): the allocator decides whether orphans
        # return home or spread.
        new_table, rehomed = self._rehome(payload, orphans, new_alive)
        # Bounded exponential backoff before the fork (a crash-looping
        # replacement must not melt the host).
        delay = min(
            self.policy.backoff_cap_s,
            self.policy.backoff_base_s * (2 ** (attempt - 1)),
        )
        if delay > 0:
            time.sleep(delay)
        spec = c.pool.spec
        spec["initial_alloc"] = new_table.copy()
        spec["dead_peers"] = sorted(c._dead_workers - {wid})
        spec["start_dead_nodes"] = np.flatnonzero(~new_alive).tolist()
        in_names, out_names = c.pool.respawn(wid)
        c._dead_workers.discard(wid)
        c.alive[: len(new_alive)] = new_alive
        c._worst[wid] = 0.0
        # Stale acks from the dead incarnation must not satisfy waits on
        # the replacement.
        c._stashed_acks = {
            k: v for k, v in c._stashed_acks.items() if k[0] != wid
        }
        c._last_hb.pop(wid, None)
        self.note_spawn(wid)
        # Survivors first: re-attach fresh lanes and mark the returned
        # nodes alive, *before* any restore traffic routes to them.
        mine = c.node_worker == wid
        up_nodes = np.flatnonzero(mine & new_alive).tolist()
        survivors = [w for w in c._alive_workers() if w != wid]
        for w in survivors:
            c.pool.send(
                w,
                (
                    "peer_up",
                    wid,
                    up_nodes,
                    in_names[w] if in_names is not None else None,
                    out_names[w] if out_names is not None else None,
                ),
            )
        c._await_acks(survivors, "peer_up")
        # Global rewind: every replica table adopts the recovered
        # allocation, every transient drops, σ reinstalls from envelopes.
        c.router.reset(new_table)
        c._command_all(("restore", new_table.copy()), "restore")
        per_worker: dict[int, dict[int, bytes]] = {}
        for kg, blob in payload["envelopes"].items():
            w = int(c.node_worker[new_table[int(kg)]])
            if w not in c._dead_workers:
                per_worker.setdefault(w, {})[int(kg)] = blob
        for w, blobs in per_worker.items():
            c.pool.send(w, ("install_bulk", blobs))
        c._await_acks(sorted(per_worker), "install_bulk")
        c._window_base = payload["window"]
        c._ticks_this_period = int(payload["ticks_this_period"])
        restored_cursor = int(payload["ingest_cursor"])
        sink_mark = len(c.metrics.sink_outputs)
        # Replay: re-ship each buffered post-checkpoint admission in its
        # own tick (the drive shape the conformance harness uses).  These
        # are re-emissions of work already admitted — no credit check.
        replay = [e for e in c._replay if e[0] > restored_cursor]
        for _, oid, batch in replay:
            c._ship_batch(oid, batch)
            c.tick()
        c.recoveries.append(
            RecoveryReport(
                worker=wid,
                cause=cause,
                respawn_attempt=attempt,
                mttr_s=time.monotonic() - death,
                restored_step=restored_step,
                restored_cursor=restored_cursor,
                restored_sink_len=sink_mark,
                orphans=int(len(orphans)),
                rehomed=rehomed,
                replayed_batches=len(replay),
            )
        )
        c._death_ts.pop(wid, None)

    def _rehome(self, payload: dict, orphans: np.ndarray, alive: np.ndarray):
        """Recovery *is* reconfiguration: place the checkpoint's key groups
        through the same allocators that drive planned reconfiguration.

        Orphan state bytes are zeroed first — their envelopes ship from
        the checkpoint, not a live node, so moving them is free (the same
        treatment ``Controller.handle_node_failure`` applies).
        """
        table = np.asarray(payload["table"], dtype=np.int64).copy()
        mode = self.policy.rehome if self.policy is not None else "keep"
        state = payload.get("folded_state")
        if mode == "keep" or state is None or not len(orphans):
            return table, 0
        state = copy.deepcopy(state)
        state.alloc = table.copy()
        state.kg_state_bytes = np.asarray(
            state.kg_state_bytes, dtype=float
        ).copy()
        state.kg_state_bytes[orphans] = 0.0
        state.alive = np.asarray(alive, dtype=bool).copy()
        if mode == "milp":
            from repro_torch.core.milp import solve_allocation

            new = np.asarray(solve_allocation(state).alloc, dtype=np.int64)
        else:
            from repro_torch.core.albic import albic

            new = np.asarray(albic(state).plan.alloc, dtype=np.int64)
        return new.copy(), int((new != table).sum())
