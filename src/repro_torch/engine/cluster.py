"""Multi-worker host runtime: real OS processes behind the Engine surface.

The single-process :class:`~repro_torch.engine.executor.Engine` timeshares N
logical nodes inside one Python loop, so aggregate throughput, migration
cost and backpressure are single-core fictions.  This module runs the same
topology over a :class:`WorkerPool` of real ``multiprocessing`` worker
processes — each worker owns a **contiguous block of nodes** and hosts a
full engine shard (:class:`_ShardEngine`) — coordinated by a
:class:`ClusterEngine` that keeps the Engine API (``push_source`` /
``tick`` / ``redirect`` / ``serialize`` / ``install`` / ``end_period``) so
the controller, the adaptation framework and the conformance harness drive
it unchanged.

Execution stays a BSP superstep per tick, now distributed:

1. **Ingestion** — the coordinator admits source batches against
   credit-based backpressure computed from the *global* worst queue depth
   (each tick report carries the worker's deepest local queue; lockstep
   drivers refresh synchronously, the pipelined driver uses the latest
   report — credits replace any in-loop budget coupling between workers),
   converts them to the declared schema, partitions by key group and ships
   each worker exactly the slice destined to its nodes.
2. **Drain** — every worker drains its own nodes concurrently (real
   parallelism; the numpy operator tiers run outside any shared lock).
3. **Exchange** — instead of routing its tick outputs directly, a shard
   splits each downstream operator's gathered batch by owning worker
   (:meth:`_ShardEngine._dispatch_batch`) and sends the remote slices to
   its peers: raw ``serde``-layout columns spliced into the per-lane
   shared-memory ring (:mod:`repro_torch.engine.shmx` — zero pickling, one
   memcpy each side), falling back to the pickled-queue lane for
   ring-full overflow and object-dtype batches, at whole-message
   granularity so a (tick, lane) contribution travels on exactly one
   transport.  Each worker then concatenates the per-operator
   contributions *in ascending worker id order* (its own slice in its own
   slot) and routes the merged batch once.

Because node blocks are contiguous and ascending in worker id, that merge
order equals the single-process engine's node-ascending flush order — so
per-node queues, per-key-group state trajectories, SPL statistics, sink
tuples *and their order*, and migration envelopes are **bit-identical** to
the single-process run (pinned by the ``soa+seg+schema+workers``
conformance configuration).  The contract and its limits (what degrades
after worker failure) are documented in ``docs/execution_tiers.md``.

In-flight migration between live workers follows the paper's direct state
migration across real processes: ``redirect`` flips every replica routing
table (the redirect-time owner parks the key group's queued runs),
``serialize`` exports the versioned :class:`~repro_torch.engine.serde.Envelope`
on worker A, ``install`` ships it to worker B which replays backlog then
buffered arrivals in FIFO order.  The coordinator folds per-worker SPL
windows (key-group loads, arrival rates, sparse pair rates, state bytes)
into one :class:`~repro_torch.core.stats.ClusterState` each period, so
ALBIC/MILP plan against exactly the signals the single-process engine
reports.

The port of ``repro.engine.cluster``, with routing on the card: every
worker is a full ``.typed()`` engine shard whose hops run the
``keygroup_partition`` and ``radix_sort`` CUDA kernels, as the
single-process engine's do (``ClusterEngine(..., device="cuda")``, the
default; ``device="cpu"`` runs the kernels' plain versions).  The
coordinator routes only on the host and makes **no CUDA call** in its whole
life, because it forks: at construction, and again for every respawn.  CUDA
cannot be used in a child forked from a process that has initialized it,
so each worker resolves the device itself (after
``torch.set_num_threads(1)``: a child forked from a process whose torch
thread pool ran hangs in its first threaded op), the two routing kernels
are built by ``nvcc`` in the coordinator before the fork (a subprocess, no
CUDA call) and loaded by each worker, and ``ClusterEngine`` refuses
``device="cuda"`` in a process where CUDA is already initialized, before it
forks.  A worker that cannot reach the card dies with its traceback, which
the coordinator raises; there is no CPU fallback.  Workers report the
port's routing counters (``EngineMetrics``' per-operator kernel batches,
host↔device copies and bytes, ``device_route_seconds``) and their kernel
wrappers' launch counts, which the coordinator folds into
:attr:`ClusterEngine.metrics`, :attr:`ClusterEngine.kernel_launches` and
:attr:`ClusterEngine.worker_stats` once per worker lifetime.

The runtime requires the ``fork`` start method (operator closures are
inherited, never pickled) and therefore POSIX.  Transport is strictly
single-writer — per-worker command and report queues, per-``(sender →
receiver)`` exchange lanes (one shm ring plus one fallback queue each,
both single-producer/single-consumer), coordinator-owned death Events
(see :class:`WorkerPool`) — so a SIGKILLed worker cannot orphan a lock
any survivor needs, and every blocking wait is deadline-guarded so a
wedged pool fails the run fast instead of deadlocking it.  The shm
segments are coordinator-allocated before the fork and coordinator-owned
thereafter: only the coordinator ever ``unlink``\\ s them — on shutdown
and on worker death — so a killed worker cannot leak a segment.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue as _queue_mod
import signal
import uuid
from multiprocessing import connection as mp_connection
import time
import traceback
from typing import Optional

import numpy as np

import torch

from repro_torch.core.stats import ClusterState, PairRates
from repro_torch.engine import serde, shmx
from repro_torch.engine.backpressure import CreditController, LatencyTracker
from repro_torch.engine.config import ExecutionConfig
from repro_torch.engine.executor import Engine, EngineMetrics, hot_key_summary
from repro_torch.engine.faults import FaultPlan
from repro_torch.engine.router import Router, concat_batches
from repro_torch.engine.state import KeyedStore
from repro_torch.engine.topology import Topology, make_batch
from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts

#: Seconds a coordinator/worker blocking wait may stall before the run is
#: declared wedged (overridable via the REPRO_CLUSTER_TIMEOUT env var).
DEFAULT_TIMEOUT = float(os.environ.get("REPRO_CLUSTER_TIMEOUT", "120"))

_METRIC_SUM_FIELDS = (
    "processed_tuples",
    "emitted_tuples",
    "cross_node_tuples",
    "intra_node_tuples",
    "sink_tuples",
    "seg_calls",
    "seg_tuples",
    "typed_batches",
    # The port's routing counters (host↔device traffic of the card's
    # routing, per worker).
    "host_device_copies",
    "host_device_bytes",
    "device_route_seconds",
    # Host seconds at the engine's layer boundaries (EngineMetrics).
    "admit_seconds",
    "jit_seconds",
    "jit_put_seconds",
    "jit_call_seconds",
    "jit_fetch_seconds",
    "flush_seconds",
    "gather_seconds",
    "gather_view_columns",
    "gather_object_columns",
    "stats_seconds",
    "pair_dense_entries",
    "pair_sparse_entries",
)

#: The port's per-operator counters (dicts keyed by operator id), summed
#: key by key across workers.
_METRIC_OP_FIELDS = (
    "routed_batches",
    "partition_kernel_batches",
    "sort_kernel_batches",
    "exchange_split_batches",
    "route_seconds",
    "op_seconds",
)

#: The routing kernels every worker loads (built before the fork).
ROUTING_KERNELS = ("keygroup_partition", "radix_sort")

#: Per-worker exchange counters, summed into ``ClusterEngine.exchange_stats``
#: at finalize (the benchmark's encode+decode and bytes-copied columns).
_EXCHANGE_STAT_FIELDS = (
    "enc_s",
    "dec_s",
    "shm_msgs",
    "queue_msgs",
    "shm_bytes_out",
    "shm_bytes_in",
)

#: Minimum seconds between worker heartbeats while the command queue is
#: busy.  An idle worker (empty command queue) always heartbeats after its
#: last command, so a quiescent worker's counters are exact and liveness
#: tracking never sees a silent-but-done worker as outstanding.
_HB_MIN_INTERVAL_S = 0.02


def contiguous_node_worker(num_nodes: int, num_workers: int) -> np.ndarray:
    """Node → worker map as contiguous ascending blocks.

    Contiguity in ascending worker order is what makes the exchange's
    worker-major merge equal the single-process node-major flush order —
    the determinism contract depends on this map staying monotone.
    """
    return (np.arange(num_nodes) * num_workers) // max(num_nodes, 1)


def worker_rng(seed: int, wid: int) -> np.random.Generator:
    """Per-worker RNG derived from the engine's single seed."""
    return np.random.default_rng([np.uint32(seed), np.uint32(wid)])


def _check_fork_safe(device: torch.device) -> None:
    """Refuse to fork card workers from a process that initialized CUDA.

    ``torch.cuda.is_initialized`` reads torch's own flag and makes no CUDA
    call, so the check itself keeps the coordinator CUDA-free."""
    if device.type == "cuda" and torch.cuda.is_initialized():
        raise RuntimeError(
            "ClusterEngine(device='cuda') must fork its workers from a process "
            "that has not initialized CUDA (a forked child cannot use it): "
            "build the cluster in a fresh interpreter, before any CUDA call, "
            "and make CUDA calls in this process only after closing it"
        )


def _fold_counters(metrics: EngineMetrics, launches: dict, counters: dict) -> None:
    """Add one worker lifetime's counters to the coordinator's totals."""
    for f in _METRIC_SUM_FIELDS:
        setattr(metrics, f, getattr(metrics, f) + counters["metrics"][f])
    for f in _METRIC_OP_FIELDS:
        into = getattr(metrics, f)
        for op, n in counters["per_op"][f].items():
            into[op] = into.get(op, 0) + n
    for name, n in counters["launches"].items():
        launches[name] = launches.get(name, 0) + n


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


class _ShardEngine(Engine):
    """One worker's engine shard: full topology, full routing table, but it
    drains only its own nodes and exchanges remote-destined outputs instead
    of enqueuing them."""

    def __init__(self, *args, wid: int, node_worker: np.ndarray, **kw):
        super().__init__(*args, **kw)
        self._wid = wid
        self._node_worker = node_worker
        # Per-tick exchange state: dop → [(batch, src_kgs, src_nodes)] for
        # my own nodes, and per-peer outboxes for everyone else's.
        self._xchg_local: dict[int, list] = {}
        self._xchg_out: dict[int, dict[int, list]] = {}
        self.rng = worker_rng(self.seed, wid)

    def _dispatch_batch(self, dop, batch, src_kgs, src_nodes) -> None:
        # Routing's first half here: counted as the hop's route_seconds, as
        # the single-process engine counts its whole _route_batch.
        t0 = time.perf_counter()
        keys, values, ts = batch
        # The first of the hop's two partitions (on the card when the keys
        # allow it): only the ids are needed, to split by owning worker.
        kgs, _, _ = self._partition(dop, keys, values)
        m = self.metrics
        m.exchange_split_batches[dop] = m.exchange_split_batches.get(dop, 0) + 1
        owners = self._node_worker[self.router.table[kgs]]
        for w in np.unique(owners):
            mask = owners == w
            if mask.all():
                sub, sk, sn = batch, src_kgs, src_nodes
            else:
                sub = (keys[mask], values[mask], ts[mask])
                sk = src_kgs[mask] if src_kgs is not None else None
                sn = src_nodes[mask] if src_nodes is not None else None
            w = int(w)
            if w == self._wid:
                self._xchg_local.setdefault(dop, []).append((sub, sk, sn))
            else:
                self._xchg_out.setdefault(w, {}).setdefault(dop, []).append(
                    (sub, sk, sn)
                )
        m.route_seconds[dop] = m.route_seconds.get(dop, 0.0) + (time.perf_counter() - t0)

    def take_exchange(self):
        local, self._xchg_local = self._xchg_local, {}
        out, self._xchg_out = self._xchg_out, {}
        return local, out

    def route_merged(self, per_dop: dict[int, list]) -> None:
        """Route each operator's worker-order-merged contribution once —
        the distributed half of ``_flush_outputs`` (same sorted-operator
        order, same single concatenated batch per operator)."""
        for dop in sorted(per_dop):
            items = per_dop[dop]
            if len(items) == 1:
                batch, sk, sn = items[0]
            else:
                batch = concat_batches([it[0] for it in items])
                sk = np.concatenate([it[1] for it in items])
                sn = np.concatenate([it[2] for it in items])
            Engine._route_batch(self, dop, batch, src_kgs=sk, src_nodes=sn)

    def worst_cost(self) -> float:
        my = self._node_worker == self._wid
        costs = [q.cost for n, q in enumerate(self._queues) if my[n]]
        return max(costs, default=0.0)

    def owned_keygroups(self) -> np.ndarray:
        return np.flatnonzero(self._node_worker[self.router.table] == self._wid)


def _encode_items(items):
    return [
        (dop, serde.encode_batch(batch), sk, sn)
        for dop, batch, sk, sn in items
    ]


def _worker_counters(eng, xchg) -> dict:
    """A worker's cumulative counters (heartbeat and gather payloads)."""
    m = eng.metrics
    return {
        "metrics": {f: getattr(m, f) for f in _METRIC_SUM_FIELDS},
        "per_op": {f: dict(getattr(m, f)) for f in _METRIC_OP_FIELDS},
        "launches": launch_counts(),
        "exchange": xchg,
    }


def _worker_main(wid, spec):
    """Worker process body (fork-inherited arguments, nothing pickled)."""
    # Before any torch op: torch's intra-op pool does not survive the fork,
    # and a child whose parent ran a threaded op hangs in its first one.
    torch.set_num_threads(1)
    cmd_q = spec["cmd_queues"][wid]
    rep_q = spec["report_queues"][wid]
    try:
        # This process's launches only (the wrapper counts are per process).
        reset_launch_counts()
        # The device resolves here, never in the coordinator: a card that
        # cannot be reached fails this worker, and the coordinator raises
        # its traceback.
        eng = _ShardEngine(
            spec["topology"],
            spec["num_nodes"],
            config=spec["config"],
            initial_alloc=spec["initial_alloc"],
            capacity=spec["capacity"],
            service_rate=spec["service_rate"],
            ser_cost=spec["ser_cost"],
            seed=spec["seed"],
            collect_sinks=spec["collect_sinks"],
            device=spec["device"],
            wid=wid,
            node_worker=spec["node_worker"].copy(),
        )
    except BaseException:
        rep_q.put(("error", wid, traceback.format_exc()))
        raise
    inboxes = spec["inboxes"]  # inboxes[receiver][sender]
    rings = spec["rings"]  # rings[receiver][sender] (ShmRing or None)
    dead_events = spec["dead_events"]
    num_workers = spec["num_workers"]
    timeout = spec["timeout"]
    # A replacement worker forks into a cluster with history: peers already
    # dead, nodes already failed (the respawn path fills these in).
    dead: set[int] = set(spec.get("dead_peers", ()))
    for node in spec.get("start_dead_nodes", ()):
        eng.fail_node(int(node))
    # Lane codecs over the fork-inherited rings: senders[peer] writes my
    # (wid → peer) ring, receivers[peer] reads the (peer → wid) ring.
    senders = [
        shmx.LaneSender(rings[w][wid]) if rings[w][wid] is not None else None
        for w in range(num_workers)
    ]
    receivers = [
        shmx.LaneReceiver(rings[wid][w]) if rings[wid][w] is not None else None
        for w in range(num_workers)
    ]
    xchg = dict.fromkeys(_EXCHANGE_STAT_FIELDS, 0)
    # stash[sender][tick] → ("s", decoded items) | ("q", encoded items)
    # (per-sender lanes deliver in tick order, but a fast peer can run
    # ahead in pipelined mode, and one sender's ticks may alternate between
    # the shm ring and the queue fallback).
    stash: dict[int, dict[int, tuple]] = {}
    sink_cursor = 0
    cmds_done = 0
    last_hb = [0.0]

    def maybe_hb():
        """Heartbeat over the report queue: liveness + the worker's current
        cumulative counters (the coordinator folds a dead worker's *last*
        heartbeat exactly once, so counters survive a respawn).

        Throttled while the command queue is busy; always emitted once the
        queue drains, so an idle worker's last heartbeat is exact.
        """
        now = time.monotonic()
        try:
            busy = not cmd_q.empty()
        except (NotImplementedError, OSError):  # pragma: no cover
            busy = False
        if busy and now - last_hb[0] < _HB_MIN_INTERVAL_S:
            return
        last_hb[0] = now
        xstats = dict(xchg)
        xstats["shm_bytes_out"] = sum(
            s.bytes_copied for s in senders if s is not None
        )
        xstats["shm_bytes_in"] = sum(
            r.bytes_copied for r in receivers if r is not None
        )
        rep_q.put(("hb", wid, cmds_done, _worker_counters(eng, xstats)))

    def drain_lanes(sender):
        """Move every delivered (sender → me) message into the stash."""
        per = stash.setdefault(sender, {})
        rx = receivers[sender]
        if rx is not None:
            while True:
                t0 = time.perf_counter()
                got = rx.poll()
                if got is None:
                    break
                xchg["dec_s"] += time.perf_counter() - t0
                per[got[0]] = ("s", got[1])
        lane = inboxes[wid][sender]
        while True:
            # Timed around the successful get too: the queue path pays a
            # pipe read plus wrapper unpickle per message — real decode
            # cost of that transport, attributed where it is paid.
            t0 = time.perf_counter()
            try:
                blob = lane.get_nowait()
            except _queue_mod.Empty:
                break
            mt, enc = pickle.loads(blob)
            xchg["dec_s"] += time.perf_counter() - t0
            per[mt] = ("q", enc)

    def recv_exchange(t, sender):
        per = stash.setdefault(sender, {})
        now = time.monotonic()
        deadline = now + timeout
        next_wait_hb = now + _HB_MIN_INTERVAL_S
        while t not in per:
            drain_lanes(sender)
            if t in per:
                break
            if dead_events[sender].is_set():
                # Final sweep: a contribution published between our poll
                # and the peer's death still counts (the ring mapping
                # outlives the coordinator's unlink).
                drain_lanes(sender)
                if t in per:
                    break
                # Peer died before contributing this tick: its tuples
                # are lost (fail_node semantics) — drain with nothing.
                dead.add(sender)
                return None
            now = time.monotonic()
            if now >= next_wait_hb:
                # Blocked on a peer is waiting, not wedged: advertise
                # liveness so the supervisor's escalation targets the
                # silent peer, never the worker stuck waiting on it.
                # Deliberately NOT a full heartbeat — counters only ride
                # command-boundary heartbeats, so a mid-tick death never
                # folds a partially-executed tick into the lost totals.
                rep_q.put(("hb_wait", wid))
                next_wait_hb = now + _HB_MIN_INTERVAL_S
            if now > deadline:
                raise RuntimeError(
                    f"worker {wid}: exchange wait for peer {sender} "
                    f"tick {t} timed out"
                )
            time.sleep(0.0005)
        kind, payload = per.pop(t)
        if kind == "s":
            return payload
        t0 = time.perf_counter()
        items = [
            (dop, serde.decode_batch(enc), sk, sn)
            for dop, enc, sk, sn in payload
        ]
        xchg["dec_s"] += time.perf_counter() - t0
        return items

    def send_exchange(t, w, items):
        """Ship one tick's contribution to peer ``w``: shm ring when it
        fits and every batch is native, else the pickled queue lane.

        The fallback pickles to bytes *inline* (not via the queue's feeder
        thread) so the exchange counters attribute the serialization cost
        where it is actually paid.
        """
        tx = senders[w]
        if tx is not None:
            t0 = time.perf_counter()
            sent = tx.try_send(t, items)
            xchg["enc_s"] += time.perf_counter() - t0
            if sent:
                xchg["shm_msgs"] += 1
                return
        t0 = time.perf_counter()
        blob = pickle.dumps(
            (t, _encode_items(items)), protocol=pickle.HIGHEST_PROTOCOL
        )
        xchg["enc_s"] += time.perf_counter() - t0
        inboxes[w][wid].put(blob)
        xchg["queue_msgs"] += 1

    def do_tick(t):
        nonlocal sink_cursor
        eng.tick()  # drain + flush → exchange stashes
        local, out = eng.take_exchange()
        peers = [w for w in range(num_workers) if w != wid and w not in dead]
        for w in peers:
            send_exchange(t, w, [
                (dop, batch, sk, sn)
                for dop, items in sorted(out.get(w, {}).items())
                for batch, sk, sn in items
            ])
        contribs: dict[int, list] = {wid: [
            (dop, batch, sk, sn)
            for dop, items in sorted(local.items())
            for batch, sk, sn in items
        ]}
        for w in peers:
            contribs[w] = recv_exchange(t, w) or []
        per_dop: dict[int, list] = {}
        for w in sorted(contribs):
            for dop, batch, sk, sn in contribs[w]:
                per_dop.setdefault(dop, []).append((batch, sk, sn))
        eng.route_merged(per_dop)
        sinks = None
        if eng.collect_sinks:
            outs = eng.metrics.sink_outputs
            sinks = outs[sink_cursor:]
            sink_cursor = len(outs)
        rep_q.put(("tick", t, wid, eng.worst_cost(), sinks))

    try:
        while True:
            cmd = cmd_q.get()
            op = cmd[0]
            if op == "push":
                _, oid, keys, values, ts = cmd
                eng._route_batch(oid, (keys, values, ts), src_kgs=None,
                                 src_nodes=None)
            elif op == "tick":
                do_tick(cmd[1])
            elif op == "costs":
                rep_q.put(("ack", wid, "costs", eng.worst_cost()))
            elif op == "redirect":
                _, kg, dst = cmd
                eng.redirect(kg, dst)
                rep_q.put(("ack", wid, "redirect", None))
            elif op == "serialize":
                env = eng.export_keygroup(cmd[1])
                rep_q.put(("ack", wid, "serialize", env.blob))
            elif op == "install":
                _, kg, dst, blob = cmd
                eng.import_keygroup(serde.Envelope(kg, blob), dst)
                rep_q.put(("ack", wid, "install", None))
            elif op == "complete":
                eng.router.complete(cmd[1])  # never buffered here: discard
                rep_q.put(("ack", wid, "complete", None))
            elif op == "set_alloc":
                _, kgs, dst = cmd
                eng.router.table[np.asarray(kgs, dtype=np.int64)] = dst
                eng.router.version += 1
                rep_q.put(("ack", wid, "set_alloc", None))
            elif op == "export":
                rep_q.put(("ack", wid, "export", eng.export_keygroup(cmd[1]).blob))
            elif op == "node_down":
                for node in cmd[1]:
                    if eng.alive[node]:
                        eng.fail_node(node)
                rep_q.put(("ack", wid, "node_down", None))
            elif op == "peer_dead":
                dead.add(cmd[1])
            elif op == "add_nodes":
                _, count, capacity, owner = cmd
                eng.add_nodes(count, capacity)
                eng._node_worker = np.concatenate(
                    [eng._node_worker, np.full(count, owner, dtype=np.int64)]
                )
                rep_q.put(("ack", wid, "add_nodes", None))
            elif op == "end_period":
                win = eng.window
                pairs = win.pair_counts()
                payload = {
                    "usage": {r: u.copy() for r, u in win.kg_usage.items()},
                    "arrivals": win.kg_arrivals.copy(),
                    "pairs": (pairs.src, pairs.dst, pairs.rate),
                    "state_bytes": eng.store.state_bytes(refresh=True),
                    "ticks": eng._ticks_this_period,
                }
                win.reset()
                eng._ticks_this_period = 0
                rep_q.put(("ack", wid, "end_period", payload))
            elif op == "gather":
                owned_kgs = eng.owned_keygroups()
                my_nodes = np.flatnonzero(eng._node_worker == wid)
                xchg["shm_bytes_out"] = sum(
                    s.bytes_copied for s in senders if s is not None
                )
                xchg["shm_bytes_in"] = sum(
                    r.bytes_copied for r in receivers if r is not None
                )
                payload = {
                    **_worker_counters(eng, dict(xchg)),
                    "states": {
                        int(kg): eng.store.get(int(kg)) for kg in owned_kgs
                    },
                    "queue_costs": {
                        int(n): eng._queues[n].cost for n in my_nodes
                    },
                }
                rep_q.put(("ack", wid, "gather", payload))
            elif op == "latency":
                # The port's Controller reads queueing latency through the
                # coordinator (see ClusterEngine.latency).
                rep_q.put(("ack", wid, "latency", list(eng.latency.samples)))
            elif op == "latency_reset":
                eng.latency.reset()
                rep_q.put(("ack", wid, "latency_reset", None))
            elif op == "export_all":
                # Checkpoint export: σ + *parked* backlog per key group,
                # never popping the backlog (unlike serialize — checkpoints
                # must not mutate the engine).
                blobs = {
                    int(kg): serde.encode_migration(
                        eng.store.serialize(int(kg)),
                        list(eng._backlog.get(int(kg), [])),
                    )
                    for kg in cmd[1]
                }
                rep_q.put(("ack", wid, "export_all", blobs))
            elif op == "window_peek":
                win = eng.window
                pairs = win.pair_counts()
                payload = {
                    "usage": {r: u.copy() for r, u in win.kg_usage.items()},
                    "arrivals": win.kg_arrivals.copy(),
                    "pairs": (
                        pairs.src.copy(),
                        pairs.dst.copy(),
                        pairs.rate.copy(),
                    ),
                    "samples": int(win.samples),
                    "ticks": eng._ticks_this_period,
                    "state_bytes": eng.store.state_bytes(refresh=True),
                }
                rep_q.put(("ack", wid, "window_peek", payload))
            elif op == "restore":
                # Global rewind to a checkpoint: adopt the table, drop every
                # transient, wipe σ (install_bulk follows with the
                # checkpointed envelopes for this worker's key groups).
                _, table = cmd
                for q in eng._queues:
                    q.clear()
                eng._backlog.clear()
                eng._out_pending.clear()
                eng.router.reset(table)
                for kg in range(len(eng.router.table)):
                    eng.store.put(kg, {})
                eng.window.reset()
                eng._ticks_this_period = 0
                stash.clear()
                rep_q.put(("ack", wid, "restore", None))
            elif op == "install_bulk":
                for kg in sorted(cmd[1]):
                    eng.install(
                        int(kg), int(eng.router.table[kg]), cmd[1][kg]
                    )
                rep_q.put(("ack", wid, "install_bulk", None))
            elif op == "peer_up":
                # A respawned peer: fresh exchange lanes (attach the
                # replacement segments by name — they were created after
                # our fork), cleared stash, nodes back alive.  Byte
                # counters carry over so gather/heartbeat totals stay
                # cumulative across the peer's incarnations.
                _, peer, nodes, in_ring, out_ring = cmd
                dead.discard(peer)
                stash.pop(peer, None)
                while True:  # drop the dead incarnation's stale fallbacks
                    try:
                        inboxes[wid][peer].get_nowait()
                    except _queue_mod.Empty:
                        break
                old_tx, old_rx = senders[peer], receivers[peer]
                senders[peer] = (
                    shmx.LaneSender(shmx.ShmRing.open(out_ring))
                    if out_ring
                    else None
                )
                receivers[peer] = (
                    shmx.LaneReceiver(shmx.ShmRing.open(in_ring))
                    if in_ring
                    else None
                )
                if old_tx is not None:
                    if senders[peer] is not None:
                        senders[peer].bytes_copied += old_tx.bytes_copied
                    old_tx.ring.close()
                if old_rx is not None:
                    if receivers[peer] is not None:
                        receivers[peer].bytes_copied += old_rx.bytes_copied
                    old_rx.ring.close()
                for node in nodes:
                    eng.alive[node] = True
                rep_q.put(("ack", wid, "peer_up", None))
            elif op == "fault":
                # Injected wedge: hang (optionally SIGTERM-deaf — the
                # shutdown-escalation worst case) or a bounded delay.  No
                # ack — from outside this is indistinguishable from a
                # worker stuck mid-command, which is the point.
                _, kind, seconds, ignore_term = cmd
                if kind == "hang":
                    if ignore_term:
                        signal.signal(signal.SIGTERM, signal.SIG_IGN)
                    end = time.monotonic() + seconds
                    while time.monotonic() < end:
                        time.sleep(0.01)
                elif kind == "delay":
                    time.sleep(seconds)
            elif op == "stop":
                # Drop this process's lane mappings explicitly: rings opened
                # after a peer respawn are reachable only from these locals,
                # and GC'ing a ShmRing tears down its SharedMemory before the
                # numpy/memoryview exports — close() releases the views first.
                for lane in (*senders, *receivers):
                    if lane is not None:
                        lane.ring.close()
                rep_q.put(("ack", wid, "stop", None))
                break
            else:  # pragma: no cover - protocol error
                raise RuntimeError(f"worker {wid}: unknown command {op!r}")
            cmds_done += 1
            maybe_hb()
    except BaseException:  # pragma: no cover - surfaced coordinator-side
        rep_q.put(("error", wid, traceback.format_exc()))
        raise


# ---------------------------------------------------------------------------
# Coordinator side
# ---------------------------------------------------------------------------


class WorkerPool:
    """Owns the worker processes and their channels (fork context).

    Every channel has exactly ONE writer — per-worker command queues
    (written by the coordinator), per-worker report queues (written by that
    worker), and per-``(sender → receiver)`` exchange lanes: one shm ring
    (:class:`repro_torch.engine.shmx.ShmRing`, single-producer/single-consumer
    by construction) plus one fallback queue each.  The
    discipline is what makes ``kill()`` safe: a SIGKILLed process can die
    holding only locks no survivor ever takes (an ``mp.Queue`` shared by
    two writers serializes them on one pipe lock, and a process killed
    between its pipe write and the lock release — a wide window on a
    loaded single-CPU host — wedges every other writer forever).  Worker
    death is signalled to peers through per-worker Events (set by the
    coordinator only), never by injecting messages into another writer's
    channel.
    """

    #: Seconds to wait for a worker to exit after SIGTERM/SIGKILL before
    #: escalating / declaring it leaked (tests shrink this).
    _GRACE_S = 5.0

    def __init__(
        self,
        num_workers: int,
        spec: dict,
        timeout: float,
        *,
        shm_lane_bytes: int = 0,
    ):
        ctx = multiprocessing.get_context("fork")
        self._ctx = ctx
        self.num_workers = num_workers
        self.timeout = timeout
        self._shm_lane_bytes = shm_lane_bytes
        #: Respawns per worker: its current incarnation (0 = the original).
        self.spawns = [0] * num_workers
        #: Commands sent per worker since its (re)spawn — the liveness
        #: tracker's "outstanding work" side of the heartbeat equation.
        self.sent_counts = [0] * num_workers
        self.cmd_queues = [ctx.Queue() for _ in range(num_workers)]
        self.report_queues = [ctx.Queue() for _ in range(num_workers)]
        # inboxes[receiver][sender]: the (sender → receiver) exchange lane's
        # fallback queue (ring-full overflow, object-dtype batches).
        self.inboxes = [
            [ctx.Queue() if s != r else None for s in range(num_workers)]
            for r in range(num_workers)
        ]
        # rings[receiver][sender]: the lane's shm ring — allocated here,
        # BEFORE the fork, so workers inherit the mappings; unlinked only
        # by the coordinator (shutdown / worker death).
        self.rings: list[list] = [
            [None] * num_workers for _ in range(num_workers)
        ]
        if shm_lane_bytes:
            uid = uuid.uuid4().hex[:8]
            try:
                for r in range(num_workers):
                    for s in range(num_workers):
                        if s != r:
                            self.rings[r][s] = shmx.ShmRing.create(
                                f"{shmx.SEGMENT_PREFIX}_{os.getpid()}"
                                f"_{uid}_{s}to{r}",
                                shm_lane_bytes,
                            )
            except OSError:
                # No usable /dev/shm on this host: run on the queue path.
                self._destroy_rings()
        self.dead_events = [ctx.Event() for _ in range(num_workers)]
        spec = dict(
            spec,
            cmd_queues=self.cmd_queues,
            report_queues=self.report_queues,
            inboxes=self.inboxes,
            rings=self.rings,
            dead_events=self.dead_events,
            num_workers=num_workers,
            timeout=timeout,
        )
        self.spec = spec
        self.processes = [
            ctx.Process(target=_worker_main, args=(w, spec), daemon=True)
            for w in range(num_workers)
        ]
        for p in self.processes:
            p.start()

    def _destroy_rings(self) -> None:
        for row in self.rings:
            for s, ring in enumerate(row):
                if ring is not None:
                    ring.unlink()
                    ring.close()
                    row[s] = None

    def release_worker_lanes(self, wid: int) -> None:
        """Unlink every segment a dead worker touches (coordinator-owned
        cleanup).  Survivors' inherited mappings stay valid, so a peer can
        still drain the dead sender's ring during its final sweep — only
        the *name* goes away, which is what prevents the leak."""
        for r in range(self.num_workers):
            for s in range(self.num_workers):
                if wid in (r, s) and self.rings[r][s] is not None:
                    self.rings[r][s].unlink()

    def send(self, wid: int, msg) -> None:
        self.sent_counts[wid] += 1
        self.cmd_queues[wid].put(msg)

    def alive(self, wid: int) -> bool:
        return self.processes[wid].is_alive()

    def kill(self, wid: int) -> None:
        p = self.processes[wid]
        if p.is_alive():
            p.kill()
            p.join(timeout=self._GRACE_S)
            if p.is_alive():  # pragma: no cover - SIGKILL cannot be ignored
                raise RuntimeError(
                    f"worker {wid} (pid {p.pid}) survived SIGKILL"
                )

    @staticmethod
    def _drain(q) -> None:
        while True:
            try:
                q.get_nowait()
            except (_queue_mod.Empty, OSError):
                return

    def respawn(self, wid: int) -> tuple[Optional[list], Optional[list]]:
        """Fork a replacement for a dead worker over fresh exchange lanes.

        Drains the dead incarnation's channels (its queues have exactly one
        other writer — the coordinator — so draining here cannot race a
        worker), replaces every (wid ↔ peer) shm ring *in the rings matrix
        before forking* (the replacement inherits the new mappings; the old
        segments were unlinked at death), clears the death Event survivors
        watch, and forks.  Returns ``(in_ring_names, out_ring_names)`` —
        per-peer segment names survivors attach via ``peer_up`` (None when
        lanes are disabled).

        The caller updates ``spec`` beforehand (current table, node map,
        dead peers) via :attr:`spec`; channel objects are reused — the fork
        start method hands the replacement the same queues and Events.
        """
        p = self.processes[wid]
        if p.is_alive():  # pragma: no cover - protocol error
            raise RuntimeError(f"worker {wid} is still alive")
        # A respawn forks the coordinator again: it must still be CUDA-free.
        _check_fork_safe(torch.device(self.spec["device"]))
        # Fresh command/report queues: a worker SIGKILLed while blocked in
        # ``cmd_q.get()`` — where an idle worker always sits — dies holding
        # the queue's reader lock, poisoning it for any future reader.
        # Both queues touch only the coordinator and the dead incarnation,
        # so they are safely replaceable (the spec holds these same lists;
        # the replacement inherits the new objects at fork).  Peer-written
        # inbox lanes cannot be swapped — live survivors hold fork-inherited
        # references — but their locks are only held inside non-blocking
        # ``get_nowait`` windows, never across a wait.
        for old in (self.cmd_queues[wid], self.report_queues[wid]):
            old.close()
            old.cancel_join_thread()
        self.cmd_queues[wid] = self._ctx.Queue()
        self.report_queues[wid] = self._ctx.Queue()
        for w in range(self.num_workers):
            if w != wid:
                self._drain(self.inboxes[wid][w])
                self._drain(self.inboxes[w][wid])
        in_names: Optional[list] = None
        out_names: Optional[list] = None
        if self._shm_lane_bytes and any(
            r is not None for row in self.rings for r in row
        ):
            uid = uuid.uuid4().hex[:8]
            try:
                for w in range(self.num_workers):
                    if w == wid:
                        continue
                    for r, s in ((wid, w), (w, wid)):
                        old = self.rings[r][s]
                        if old is not None:
                            old.close()
                        self.rings[r][s] = shmx.ShmRing.create(
                            f"{shmx.SEGMENT_PREFIX}_{os.getpid()}"
                            f"_{uid}_{s}to{r}",
                            self._shm_lane_bytes,
                        )
            except OSError:  # pragma: no cover - /dev/shm exhausted
                for w in range(self.num_workers):
                    for r, s in ((wid, w), (w, wid)):
                        ring = self.rings[r][s]
                        if ring is not None:
                            ring.unlink()
                            ring.close()
                            self.rings[r][s] = None
            else:
                in_names = [
                    self.rings[w][wid].shm.name if w != wid else None
                    for w in range(self.num_workers)
                ]
                out_names = [
                    self.rings[wid][w].shm.name if w != wid else None
                    for w in range(self.num_workers)
                ]
        # Same Event object (survivors hold fork-inherited references):
        # clear, don't replace.  Safe because the caller quiesced the pool —
        # every survivor finished its final sweep of the dead incarnation.
        self.dead_events[wid].clear()
        self.sent_counts[wid] = 0
        self.spawns[wid] += 1
        proc = self._ctx.Process(
            target=_worker_main, args=(wid, self.spec), daemon=True
        )
        proc.start()
        self.processes[wid] = proc
        return in_names, out_names

    def shutdown(self) -> None:
        # Graceful first (SIGTERM lets queue feeder threads flush), then
        # escalate to SIGKILL on timeout, then *check* — the join result
        # used to be ignored, so an ignore-everything worker leaked.
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + self._GRACE_S
        for p in self.processes:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        leaked = [p for p in self.processes if p.is_alive()]
        for p in leaked:
            p.kill()
        for p in leaked:
            p.join(timeout=self._GRACE_S)
        still = [p.pid for p in self.processes if p.is_alive()]
        for q in (
            *self.cmd_queues,
            *self.report_queues,
            *(q for row in self.inboxes for q in row if q is not None),
        ):
            q.close()
            q.cancel_join_thread()
        self._destroy_rings()
        if still:  # pragma: no cover - SIGKILL cannot be ignored
            raise RuntimeError(f"leaked worker processes after SIGKILL: {still}")


class ClusterEngine:
    """Coordinator for the multi-worker runtime; Engine-compatible surface.

    Drives a :class:`WorkerPool` in lockstep (``push_source`` / ``tick`` —
    the conformance shape, bit-identical to single-process) or pipelined
    (:meth:`run_stream` — the throughput shape, no per-tick coordinator
    barrier).  Implements the ``StateMover`` protocol, so
    ``repro_torch.core.migration.execute_plan`` migrates key groups *between live
    worker processes* exactly as it does between logical nodes.
    """

    def __init__(
        self,
        topology: Topology,
        num_nodes: int,
        *,
        config: Optional[ExecutionConfig] = None,
        initial_alloc: Optional[np.ndarray] = None,
        capacity: Optional[np.ndarray] = None,
        service_rate: float = 1_000.0,
        ser_cost: float = 0.25,
        seed: int = 0,
        collect_sinks: bool = True,
        timeout: float = DEFAULT_TIMEOUT,
        faults: Optional[FaultPlan] = None,
        device="cuda",
    ) -> None:
        if config is None:
            config = ExecutionConfig.workers(2)
        if config.num_workers < 2:
            raise ValueError("ClusterEngine needs ExecutionConfig.workers(n >= 2)")
        if "fork" not in multiprocessing.get_all_start_methods():
            raise RuntimeError(
                "the multi-worker runtime requires the 'fork' start method "
                "(operator closures are inherited, not pickled)"
            )
        # The workers' device, resolved by each worker (resolve_device makes
        # CUDA calls, which this process must never make).
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {str(device)!r} (use 'cuda' or 'cpu')")
        _check_fork_safe(self.device)
        if self.device.type == "cuda":
            # nvcc in subprocesses, no CUDA call; each worker loads them.
            from repro_torch.kernels import _build

            _build.build(ROUTING_KERNELS)
        topology.validate()
        self.topology = topology
        self.num_nodes = num_nodes
        self.config = config
        self.num_workers = config.num_workers
        self.service_rate = service_rate
        self.ser_cost = ser_cost
        self.seed = seed
        self.collect_sinks = collect_sinks
        self.capacity = (
            np.ones(num_nodes) if capacity is None else np.asarray(capacity)
        )
        g = topology.num_keygroups
        rng = np.random.default_rng(seed)  # Engine's exact alloc draw
        if initial_alloc is None:
            initial_alloc = rng.integers(0, num_nodes, size=g)
        self._initial_alloc = np.asarray(initial_alloc, dtype=np.int64).copy()
        self.router = Router(g, self._initial_alloc)
        self.node_worker = contiguous_node_worker(num_nodes, self.num_workers)
        self.alive = np.ones(num_nodes, dtype=bool)
        self.metrics = EngineMetrics()
        self.store = KeyedStore(g)  # populated at finalize()
        self.backpressure = CreditController(
            num_nodes, high_wm=50 * service_rate
        )
        self.ingest_rng = np.random.default_rng(
            [np.uint32(seed), np.uint32(0xC1)]
        )
        self._kg_op = topology.kg_operator()
        self._downstream = topology.downstream()
        self._op_schema = [
            o.schema if config.use_schema else None for o in topology.operators
        ]
        self._worker_config = config.replace(
            num_workers=1, checkpoint=None, supervision=None
        )
        self._timeout = timeout
        worker_cfg = self._worker_config
        self.pool = WorkerPool(
            self.num_workers,
            dict(
                topology=topology,
                num_nodes=num_nodes,
                config=worker_cfg,
                initial_alloc=self._initial_alloc,
                capacity=self.capacity,
                service_rate=service_rate,
                ser_cost=ser_cost,
                seed=seed,
                collect_sinks=collect_sinks,
                node_worker=self.node_worker,
                device=str(self.device),
            ),
            timeout,
            shm_lane_bytes=config.shm_lane_bytes,
        )
        #: Folded per-worker exchange counters (populated at finalize):
        #: encode/decode seconds, shm vs queue message counts, bytes copied.
        self.exchange_stats: dict[str, float] = dict.fromkeys(
            _EXCHANGE_STAT_FIELDS, 0
        )
        #: Kernel launches folded from every worker lifetime (populated at
        #: finalize): the wrappers' counts, made in the worker processes.
        self.kernel_launches: dict[str, int] = dict.fromkeys(KERNELS, 0)
        #: One entry per worker lifetime, folded exactly once: a dead
        #: incarnation's last heartbeat at its death, the live ones' gather
        #: at finalize — ``{"worker", "incarnation", "died", "metrics",
        #: "per_op", "launches", "exchange"}``.
        self.worker_stats: list[dict] = []
        #: Queueing latency, read from the workers (the Controller's
        #: ``engine.latency.summary()``).
        self.latency = _WorkerLatency(self)
        self._dead_workers: set[int] = set()
        self._worst = np.zeros(self.num_workers)
        self._tick_no = 0
        self._ticks_this_period = 0
        self._mig_src: dict[int, int] = {}
        # Pipelined-mode report reassembly: (tick → {wid: (worst, sinks)}).
        self._tick_reports: dict[int, dict[int, tuple]] = {}
        self._merged_through = -1
        self._pending_ticks: list[int] = []
        self._stashed_acks: dict[tuple[int, str], object] = {}
        self._queue_costs: Optional[list[float]] = None
        self._closed = False
        self._finalized = False
        # ---- self-healing state (heartbeats, checkpoints, recovery) ----
        self.faults = faults
        #: Source admissions since start — the checkpoint cut point and the
        #: replay buffer's ordering key.
        self.ingest_cursor = 0
        self._period_no = 0
        # Post-checkpoint admissions buffered coordinator-side, as
        # (cursor, oid, converted batch): after a global rewind to the last
        # checkpoint they are re-shipped in admission order.  Only kept when
        # both checkpoints and respawn are configured; pruned at each commit.
        self._buffer_replay = (
            config.checkpoint is not None
            and config.supervision is not None
            and config.supervision.respawn
        )
        self._replay: list[tuple[int, int, tuple]] = []
        #: Latest heartbeat per worker: (commands done, cumulative counters).
        #: A dead worker's entry goes to :attr:`worker_stats` exactly once
        #: (its gather payload is gone; the replacement counts from zero),
        #: so finalize stays conservation-exact across respawns.
        self._last_hb: dict[int, tuple[int, dict]] = {}
        self._death_ts: dict[int, float] = {}
        self._needs_recovery: list[int] = []
        self._in_recovery = False
        #: One RecoveryReport per recovery attempt (see engine/supervisor.py).
        self.recoveries: list = []
        # Window statistics restored from a checkpoint, folded into the next
        # end_period exactly once (the periodic fold must see the partial
        # window the original run had at the cut).
        self._window_base: Optional[dict] = None
        self._window_resources: tuple = ("cpu", "network", "memory")
        self.supervisor = None
        if config.supervision is not None or config.checkpoint is not None:
            # Lazy import: the supervisor pulls in the checkpoint stack,
            # which plain cluster runs never need.
            from repro_torch.engine.supervisor import Supervisor

            self.supervisor = Supervisor(self)

    # ------------------------------------------------------------- plumbing
    def _alive_workers(self) -> list[int]:
        return [
            w for w in range(self.num_workers) if w not in self._dead_workers
        ]

    def worker_of_node(self, node: int) -> int:
        return int(self.node_worker[node])

    def _recv(self):
        """One report message (any worker), with death detection and deadline.

        Polls every worker's report queue — including a dead worker's, whose
        already-flushed reports are still deliverable — in worker-id order.
        """
        deadline = time.monotonic() + self._timeout
        readers = [q._reader for q in self.pool.report_queues]
        while True:
            for w in range(self.num_workers):
                try:
                    msg = self.pool.report_queues[w].get_nowait()
                except _queue_mod.Empty:
                    continue
                if msg[0] == "error":
                    raise RuntimeError(
                        f"worker {msg[1]} crashed:\n{msg[2]}"
                    )
                if msg[0] == "hb":
                    # Liveness + counters only — never surfaced to callers.
                    self._note_hb(msg)
                    continue
                if msg[0] == "hb_wait":
                    # Worker blocked in the exchange on a peer: pure
                    # liveness, no counters (see recv_exchange).
                    if self.supervisor is not None:
                        self.supervisor.note_activity(msg[1])
                    continue
                if self.supervisor is not None:
                    self.supervisor.note_activity(
                        msg[2] if msg[0] == "tick" else msg[1]
                    )
                return msg
            for w in self._alive_workers():
                if not self.pool.alive(w):
                    self._on_worker_death(w)
                    return None
            if self.supervisor is not None and self.supervisor.escalate_wedged():
                continue  # SIGKILLed a wedged worker; re-run death detection
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "cluster coordinator: wait on worker reports timed "
                    "out (wedged pool?)"
                )
            mp_connection.wait(readers, timeout=0.05)

    def _handle_tick_report(self, msg) -> None:
        _, t, wid, worst, sinks = msg
        self._worst[wid] = worst
        self._tick_reports.setdefault(t, {})[wid] = (worst, sinks)
        self._merge_ready_ticks()

    def _merge_ready_ticks(self) -> None:
        """Fold completed ticks' sink deltas in (tick, worker) order."""
        while self._pending_ticks:
            t = self._pending_ticks[0]
            reports = self._tick_reports.get(t, {})
            expected = [
                w for w in range(self.num_workers)
                if w not in self._dead_workers or w in reports
            ]
            if not all(w in reports for w in expected):
                return
            for w in sorted(reports):
                _, sinks = reports[w]
                if sinks:
                    self.metrics.sink_outputs.extend(sinks)
            # pop, not del: with every expected reporter dead the tick
            # merges empty and may have no reports entry at all.
            self._tick_reports.pop(t, None)
            self._pending_ticks.pop(0)
            self._merged_through = t

    def _await_acks(self, wids: list[int], tag: str):
        """Collect one tagged ack per worker; returns {wid: payload}.

        The stash is re-checked every iteration, not just on entry: a
        worker-death detour (``_on_worker_death`` → ``node_down`` ack wait)
        nested inside this wait consumes the report stream and stashes this
        tag's acks — entry-only checking would then wait forever for a
        message already consumed.
        """
        out = {}
        while True:
            for w in wids:
                key = (w, tag)
                if w not in out and key in self._stashed_acks:
                    out[w] = self._stashed_acks.pop(key)
            if len(out) >= len(
                [w for w in wids if w not in self._dead_workers]
            ):
                return out
            msg = self._recv()
            if msg is None:  # a worker died; re-evaluate expectations
                continue
            if msg[0] == "tick":
                self._handle_tick_report(msg)
                continue
            _, wid, mtag, payload = msg
            if mtag == tag and wid in wids:
                out[wid] = payload
            else:
                self._stashed_acks[(wid, mtag)] = payload

    def _command_all(self, msg, tag: str):
        wids = self._alive_workers()
        for w in wids:
            self.pool.send(w, msg)
        return self._await_acks(wids, tag)

    def _command_one(self, wid: int, msg, tag: str):
        if wid in self._dead_workers:
            raise RuntimeError(f"worker {wid} is dead")
        self.pool.send(wid, msg)
        return self._await_acks([wid], tag)[wid]

    def _on_worker_death(self, wid: int) -> None:
        """A worker vanished: unwedge peers, mark its nodes failed.

        Survivors stuck in the current tick's exchange see the dead
        worker's Event and drain with an empty contribution; future ticks
        skip it via ``peer_dead``.  The dead worker's queued work and
        un-reported tick output are lost — exactly a node crash
        (``fail_node`` semantics); recovery reinstalls its key groups from
        checkpoint envelopes via :meth:`import_keygroup` (see
        tests/test_cluster_faults.py).
        """
        if wid in self._dead_workers:
            return
        self._dead_workers.add(wid)
        self._death_ts[wid] = time.monotonic()
        # Drain reports the dead worker already flushed — the final
        # heartbeat rides the same pipe as the last ack and may not have
        # been polled yet — then fold its counters exactly once.
        while True:
            try:
                msg = self.pool.report_queues[wid].get_nowait()
            except (_queue_mod.Empty, OSError):
                break
            if msg[0] == "hb":
                self._note_hb(msg)
            elif msg[0] == "tick":
                self._handle_tick_report(msg)
            elif msg[0] == "ack":
                self._stashed_acks[(msg[1], msg[2])] = msg[3]
            elif msg[0] == "error":
                # It crashed rather than being killed (a card it could not
                # reach, a fault in its engine): never carry on without it.
                raise RuntimeError(f"worker {msg[1]} crashed:\n{msg[2]}")
        last = self._last_hb.pop(wid, None)
        if last is not None:
            self._note_lifetime(wid, last[1], died=True)
        dead_nodes = np.flatnonzero(self.node_worker == wid)
        self.alive[dead_nodes] = False
        # Coordinator-owned shm cleanup: a SIGKILLed worker can't unlink
        # its own lanes, so its segments are released here (names only —
        # survivors' mappings stay valid for the final drain).
        self.pool.release_worker_lanes(wid)
        # Unblock survivors stuck on the dead worker's exchange: the Event
        # is coordinator-owned, so no channel the dead process might have
        # wedged is involved (see WorkerPool).
        self.pool.dead_events[wid].set()
        survivors = self._alive_workers()
        for w in survivors:
            self.pool.send(w, ("peer_dead", wid))
        self._command_all(("node_down", dead_nodes.tolist()), "node_down")
        self._merge_ready_ticks()
        if (
            self.config.supervision is not None
            and self.config.supervision.respawn
        ):
            # Recovery runs at the next safe point (between supersteps),
            # not here: death is detected deep inside report waits.
            self._needs_recovery.append(wid)

    def _note_lifetime(self, wid: int, counters: dict, *, died: bool) -> None:
        self.worker_stats.append(
            {
                "worker": wid,
                "incarnation": self.pool.spawns[wid],
                "died": died,
                **{k: counters[k] for k in ("metrics", "per_op", "launches", "exchange")},
            }
        )

    # ------------------------------------------------------------ self-healing
    def _note_hb(self, msg) -> None:
        _, wid, done, counters = msg
        self._last_hb[wid] = (done, counters)
        if self.supervisor is not None:
            self.supervisor.note_hb(wid, done)

    def _maybe_recover(self) -> None:
        """Run pending recoveries at a safe point (no tick in flight)."""
        if self._in_recovery or not self._needs_recovery:
            return
        self._in_recovery = True
        try:
            while self._needs_recovery:
                self.supervisor.recover(self._needs_recovery.pop(0))
        finally:
            self._in_recovery = False

    def _apply_faults(self, *, tick=None, period=None) -> None:
        """Apply scheduled FaultPlan events at this deterministic point."""
        if self.faults is None:
            return
        events = (
            self.faults.at_tick(tick)
            if tick is not None
            else self.faults.at_period(period)
        )
        for ev in events:
            w = ev.worker
            if w >= self.num_workers or w in self._dead_workers:
                continue
            if self.supervisor is not None:
                self.supervisor.note_fault(w, ev)
            if ev.kind == "kill":
                self.fail_worker(w)
            else:
                # No ack: from outside, a hang/delay is a worker stuck
                # mid-command — which is exactly what it should look like.
                self.pool.send(
                    w, ("fault", ev.kind, ev.seconds, ev.ignore_term)
                )

    # ------------------------------------------------------------------ feed
    def source_credits(self, *, refresh: bool = True) -> int:
        """Global credits from the worst per-worker queue depth.

        ``refresh=True`` (the lockstep default) round-trips to the workers
        for the exact instantaneous depths; ``refresh=False`` uses the
        latest tick reports (the pipelined mode's credit loop).
        """
        return self.backpressure.credits_from_worst(
            self.worst_queue_cost(refresh=refresh)
        )

    def worst_queue_cost(self, *, refresh: bool = True) -> float:
        """Deepest queue across alive workers (drives credits; drain loops
        poll it to detect quiescence without a full gather)."""
        if refresh:
            for w, worst in self._command_all(("costs",), "costs").items():
                self._worst[w] = worst
        return max(
            (float(self._worst[w]) for w in self._alive_workers()), default=0.0
        )

    def push_source(self, op, keys, values, ts, *, refresh: bool = True) -> int:
        self._maybe_recover()
        oid = self.topology._resolve(op)
        spec = self.topology.operators[oid]
        if not spec.is_source:
            raise ValueError(f"{spec.name!r} is not a source")
        credits = self.source_credits(refresh=refresh)
        n = min(len(keys), credits)
        if n < len(keys):
            self.metrics.dropped_credits += len(keys) - n
        if n == 0:
            return 0
        self._split_and_push(oid, keys, values, ts, n)
        return n

    def _split_and_push(self, oid, keys, values, ts, n: int) -> None:
        """Schema-convert the admitted slice and ship per-worker splits."""
        schema = self._op_schema[oid]
        if schema is not None:
            tv = schema.typed_values(values[:n] if len(values) != n else values)
            if isinstance(values, np.ndarray) and np.shares_memory(tv, values):
                tv = tv.copy()
            batch = (
                np.array(keys[:n], dtype=schema.key),
                tv,
                np.asarray(ts[:n], dtype=np.float64),
            )
        else:
            batch = make_batch(keys[:n], values[:n], ts[:n])
        self.ingest_cursor += 1
        if self._buffer_replay:
            self._replay.append((self.ingest_cursor, oid, batch))
        self._ship_batch(oid, batch)

    def _ship_batch(self, oid: int, batch) -> None:
        """Partition one admitted batch by owning worker and ship the slices
        (the replay path re-enters here, bypassing admission)."""
        bk, bv, bt = batch
        kgs = self.topology.keygroups_of(oid, bk, bv)
        owners = self.node_worker[self.router.table[kgs]]
        for w in np.unique(owners):
            w = int(w)
            if w in self._dead_workers:
                continue  # tuples to dead nodes are lost, as on fail_node
            mask = owners == w
            if mask.all():
                sub = batch
            else:
                sub = (bk[mask], bv[mask], bt[mask])
            self.pool.send(w, ("push", oid, *sub))

    # ------------------------------------------------------------------ tick
    def tick(self) -> None:
        """Lockstep BSP tick: command all workers, await all reports."""
        self._apply_faults(tick=self._tick_no)
        t = self._tick_no
        self._tick_no += 1
        self._pending_ticks.append(t)
        for w in self._alive_workers():
            self.pool.send(w, ("tick", t))
        self._wait_tick(t)
        self.metrics.ticks += 1
        self._ticks_this_period += 1
        self._maybe_recover()

    def _wait_tick(self, t: int) -> None:
        while self._merged_through < t:
            msg = self._recv()
            if msg is None:
                continue
            if msg[0] == "tick":
                self._handle_tick_report(msg)
            else:
                _, wid, mtag, payload = msg
                self._stashed_acks[(wid, mtag)] = payload

    def run_stream(self, op, batches, *, window: int = 4,
                   shuffle: bool = False) -> int:
        """Pipelined throughput mode: stream (push, tick) pairs without a
        per-tick coordinator barrier.

        ``batches`` is an iterable of ``(keys, values, ts)`` source batches,
        one tick each; at most ``window`` ticks run ahead of the last
        merged report, and credits come from the latest reports (the
        asynchronous credit loop).  ``shuffle=True`` permutes batch order
        with the seed-derived ingestion RNG (reproducible from
        ``Engine(seed=...)`` alone).  Returns tuples accepted.
        """
        oid = self.topology._resolve(op)
        batches = list(batches)
        if shuffle:
            batches = [batches[i] for i in self.ingest_rng.permutation(len(batches))]
        accepted = 0
        for keys, values, ts in batches:
            self._maybe_recover()
            while self._tick_no - self._merged_through - 1 >= window:
                msg = self._recv()
                if msg is None:
                    continue
                if msg[0] == "tick":
                    self._handle_tick_report(msg)
            credits = self.source_credits(refresh=False)
            n = min(len(keys), credits)
            if n < len(keys):
                self.metrics.dropped_credits += len(keys) - n
            if n:
                self._split_and_push(oid, keys, values, ts, n)
                accepted += n
            self._apply_faults(tick=self._tick_no)
            t = self._tick_no
            self._tick_no += 1
            self._pending_ticks.append(t)
            for w in self._alive_workers():
                self.pool.send(w, ("tick", t))
        if self._tick_no:
            self._wait_tick(self._tick_no - 1)
        self.metrics.ticks += len(batches)
        self._ticks_this_period += len(batches)
        self._maybe_recover()
        return accepted

    # ------------------------------------------------------- SPL statistics
    def end_period(self) -> ClusterState:
        """Fold every worker's SPL window into one ClusterState snapshot."""
        self._maybe_recover()
        payloads = self._command_all(("end_period",), "end_period")
        g = self.topology.num_keygroups
        order = sorted(payloads)
        usage = {
            r: np.zeros(g)
            for r in (payloads[order[0]]["usage"] if order else {"cpu": None})
        }
        arrivals = np.zeros(g)
        psrc, pdst, prate = [], [], []
        state_bytes = np.full(g, 64.0)
        owner_of_kg = self.node_worker[self.router.table]
        for w in order:
            p = payloads[w]
            for r, u in p["usage"].items():
                usage[r] += u
            arrivals += p["arrivals"]
            s, d, r_ = p["pairs"]
            psrc.append(s)
            pdst.append(d)
            prate.append(r_)
            mine = owner_of_kg == w
            state_bytes[mine] = p["state_bytes"][mine]
        if self._window_base is not None:
            # Window statistics carried out of the checkpoint a recovery
            # restored from — the fold must see the partial window the
            # original run had accumulated at the cut.  Folded once.
            base, self._window_base = self._window_base, None
            for r, u in base["usage"].items():
                if r in usage:
                    usage[r] += u
            arrivals += base["arrivals"]
            s, d, r_ = base["pairs"]
            if len(s):
                psrc.append(s)
                pdst.append(d)
                prate.append(r_)
        self._window_resources = tuple(usage)
        totals = {r: float(u.sum()) for r, u in usage.items()}
        resource = max(totals, key=totals.get)
        ticks = max(self._ticks_this_period, 1)
        scale = 100.0 / (ticks * self.service_rate)
        if psrc and sum(len(s) for s in psrc):
            src = np.concatenate(psrc)
            dst = np.concatenate(pdst)
            rate = np.concatenate(prate)
            pairs = PairRates.from_codes(src * g + dst, rate, g)
        else:
            pairs = PairRates.empty(g)
        state = ClusterState.create(
            self.num_nodes,
            self._kg_op,
            usage[resource] * scale,
            self.router.table.copy(),
            kg_state_bytes=state_bytes,
            out_rates=pairs,
            downstream=self._downstream,
            capacity=self.capacity.copy(),
            kg_tuple_rate=arrivals / ticks,
        )
        state.alive = self.alive.copy()
        # Hot-key observability over the cross-worker fold: the gauge sees
        # the same totals a single-process run of the same traffic would,
        # because `arrivals` is the sum of every worker's partial counts.
        self.metrics.hot_keygroups, self.metrics.max_kg_share = hot_key_summary(
            arrivals
        )
        self._ticks_this_period = 0
        self._period_no += 1
        if self.supervisor is not None:
            self.supervisor.note_period(state)
        # Period faults land *after* the fold and any checkpoint — a kill
        # here is a crash between periods, the canonical recovery scenario.
        self._apply_faults(period=self._period_no)
        self._maybe_recover()
        return state

    # ------------------------------------------------- direct state migration
    # StateMover protocol — migrations now move state between live worker
    # processes, through the versioned serde envelopes.
    def redirect(self, keygroup: int, dst: int) -> None:
        src_worker = self.worker_of_node(self.router.node_of(keygroup))
        self.router.redirect(keygroup, dst)
        self._mig_src[keygroup] = src_worker
        self._command_all(("redirect", keygroup, dst), "redirect")

    def serialize(self, keygroup: int) -> bytes:
        w = self._mig_src.pop(
            keygroup, self.worker_of_node(self.router.node_of(keygroup))
        )
        return self._command_one(w, ("serialize", keygroup), "serialize")

    def install(self, keygroup: int, dst: int, blob: bytes) -> None:
        w_dst = self.worker_of_node(dst)
        if w_dst in self._dead_workers:
            raise RuntimeError(
                f"cannot install key group {keygroup}: node {dst}'s worker "
                f"{w_dst} is dead"
            )
        wids = self._alive_workers()
        for w in wids:
            if w == w_dst:
                self.pool.send(w, ("install", keygroup, dst, blob))
            else:
                self.pool.send(w, ("complete", keygroup))
        self._await_acks(
            [w for w in wids if w != w_dst], "complete"
        )
        if w_dst not in self._dead_workers:
            self._await_acks([w_dst], "install")
        self.router.complete(keygroup)

    def export_keygroup(self, keygroup: int) -> serde.Envelope:
        w = self.worker_of_node(self.router.node_of(keygroup))
        blob = self._command_one(w, ("export", keygroup), "export")
        return serde.Envelope(keygroup, blob)

    def import_keygroup(
        self, envelope: serde.Envelope, dst: Optional[int] = None
    ) -> None:
        if dst is None:
            dst = self.router.node_of(envelope.keygroup)
        if int(self.router.table[envelope.keygroup]) != dst:
            self.set_alloc([envelope.keygroup], dst)
        self.install(envelope.keygroup, dst, envelope.blob)

    def set_alloc(self, keygroups, dst: int) -> None:
        """Point key groups at ``dst`` on every replica table (no in-flight
        semantics — the recovery path's table rewrite)."""
        self.router.table[np.asarray(keygroups, dtype=np.int64)] = dst
        self.router.version += 1
        self._command_all(("set_alloc", list(keygroups), dst), "set_alloc")

    # --------------------------------------------------------------- elastic
    def add_nodes(self, count: int, capacity: float = 1.0) -> None:
        """Append nodes, owned by the last worker (keeps the node → worker
        map monotone, which the determinism contract requires)."""
        owner = max(self._alive_workers())
        self.num_nodes += count
        self.capacity = np.concatenate([self.capacity, np.full(count, capacity)])
        self.alive = np.concatenate([self.alive, np.ones(count, dtype=bool)])
        self.node_worker = np.concatenate(
            [self.node_worker, np.full(count, owner, dtype=np.int64)]
        )
        self.backpressure.num_nodes = self.num_nodes
        self._command_all(("add_nodes", count, capacity, owner), "add_nodes")

    def fail_worker(self, wid: int) -> np.ndarray:
        """Kill a worker process outright (fault injection).

        Returns the orphaned key groups; their queued work and state on the
        dead worker are gone — reinstall from checkpoints via
        :meth:`import_keygroup` (see tests/test_cluster_faults.py).
        """
        dead_nodes = np.flatnonzero(self.node_worker == wid)
        orphans = np.flatnonzero(np.isin(self.router.table, dead_nodes))
        self.pool.kill(wid)
        self._on_worker_death(wid)
        return orphans

    # ------------------------------------------------------------- inspection
    def queue_costs(self) -> list[float]:
        if self._queue_costs is not None:
            return self._queue_costs
        costs = [0.0] * self.num_nodes
        for w, payload in self._command_all(("gather",), "gather").items():
            for node, c in payload["queue_costs"].items():
                costs[node] = c
        return costs

    def finalize(self) -> None:
        """Gather worker-side results onto the coordinator and stop the pool.

        After this, ``metrics`` (counters + merged sink outputs), ``store``
        (every key group's state, taken from its owning worker) and
        ``queue_costs()`` read exactly like a single-process engine's.
        """
        if self._finalized:
            return
        payloads = self._command_all(("gather",), "gather")
        costs = [0.0] * self.num_nodes
        for w in sorted(payloads):
            p = payloads[w]
            for kg, state in p["states"].items():
                if state:
                    self.store.put(kg, state)
            for node, c in p["queue_costs"].items():
                costs[node] = c
            self._note_lifetime(w, p, died=False)
        # Every lifetime's counters, folded exactly once: the live gather
        # above and the dead incarnations' final heartbeats (a respawned
        # worker counts from zero).
        for life in self.worker_stats:
            _fold_counters(self.metrics, self.kernel_launches, life)
            for f in _EXCHANGE_STAT_FIELDS:
                self.exchange_stats[f] += life["exchange"].get(f, 0)
        self._queue_costs = costs
        self._finalized = True
        self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            for w in self._alive_workers():
                self.pool.send(w, ("stop",))
            self._await_acks(self._alive_workers(), "stop")
        except Exception:
            pass
        self.pool.shutdown()

    def __enter__(self) -> "ClusterEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - belt and braces
        try:
            if not getattr(self, "_closed", True):
                self.pool.shutdown()
        except Exception:
            pass


class _WorkerLatency:
    """``ClusterEngine.latency``: the workers' queueing-latency samples,
    read on demand (the Controller reads ``engine.latency.summary()`` after
    the period's migrations, whose installs record samples too).  Samples
    concatenate in worker order; every node's samples come from its own
    worker in the single-process engine's order, so percentiles and the
    maximum equal the single-process engine's, the mean to summation
    order."""

    def __init__(self, cluster: ClusterEngine) -> None:
        self._cluster = cluster

    @property
    def samples(self) -> list[tuple[float, int]]:
        c = self._cluster
        acks = c._command_all(("latency",), "latency")
        return [s for w in sorted(acks) for s in acks[w]]

    def summary(self) -> dict[str, float]:
        return LatencyTracker(self.samples).summary()

    def reset(self) -> None:
        self._cluster._command_all(("latency_reset",), "latency_reset")
