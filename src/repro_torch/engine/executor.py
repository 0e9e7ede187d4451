"""The engine: executes a topology over logical nodes, measuring everything
the controller needs (paper §3 "Statistics", §5 metrics).

The port of ``repro.engine.executor`` (the classic tick).  The data plane is
array-native end to end: tuples move as
:class:`~repro_torch.engine.topology.Batch` triples (key/value/ts parallel
numpy arrays), work queues are structure-of-arrays segments, operators run
their per-run ``fn`` or segment-vectorized ``fn_seg`` bodies on the host,
SPL statistics are recorded as arrays, and direct state migration ships
σ_k plus its queued backlog in the reference's envelope format.  See the
reference module's docstring for the authoring contract of ``fn_seg``; it
holds here unchanged.

What the port moves to the card (``Engine(device="cuda")``, the default)
is routing, the per-tick work that is shaped for a device:

* **hash partition + arrival histogram** — for every routed batch whose
  partition key is an integer array (identity ``key_fn`` over integer keys,
  as in the reference's kernel test at ``Engine._partition``, or a
  ``key_by_value_col`` field expression over a schema-typed batch, which
  the reference hashes with the same mix on the host), the keys go to the
  card once and the ``keygroup_partition`` CUDA kernel computes each
  tuple's key-group id and the operator's per-key-group arrival histogram,
  which feeds the SPL window directly;
* **composite sort** — whenever a batch spans more than one key group, the
  ``(destination node, key group)`` composite is built on the card (node
  lookup through a device copy of the routing table, refreshed when
  ``Router.version`` moves) and stably sorted by the ``radix_sort`` CUDA
  kernel — int16 codes when ``num_nodes × nkg`` fits, int32 otherwise.

Only the ids, the histogram and the order come back to the host, which
builds the run index lists and the queue segments exactly as the reference
does.  ``EngineMetrics.host_device_copies``/``host_device_bytes`` count
every host↔device copy routing makes (the cost later slices cut), and the
per-operator ``routed_batches``/``partition_kernel_batches``/
``sort_kernel_batches`` show which hops went through the kernels.
Host seconds are counted at the engine's layer boundaries as well, and
``Engine.spans`` records them as spans on request
(:mod:`repro_torch.engine.tracing` names both).

The compiled tier (``ExecutionConfig.jit()``: ``OperatorSpec.fn_jit`` +
a declared ``StateSchema``) moves operator state to the card as well:
contiguous whole-budget segments of a jit operator defer into one batched
call per operator per tick over device state columns
(:mod:`repro_torch.engine.jitexec`; placeholder cells keep output order
identical to inline execution, and per-run fallbacks force-flush the
deferred batch first so state updates stay in drain order), exactly as in
the reference's executor.

The fused superstep (``ExecutionConfig.superstep()``,
:mod:`repro_torch.engine.superstep`) goes further for a linear chain of
``jit_fusible`` operators: each tick runs every operator and routes its
outputs on the card (one read per tick), and :meth:`Engine.run_supersteps`
runs K ticks as one loop, captured into a CUDA graph on the card (one read
per K ticks).

``device="cpu"`` runs the identical path with the kernels' plain PyTorch
versions on CPU tensors; it is bit-identical to the reference's numpy
engine, which the conformance tests pin (the compiled tier within the
reference's documented float tolerance).  A :class:`~repro_torch.engine.
config.CheckpointPolicy` commits a checkpoint every ``every``-th
``end_period`` (:mod:`repro_torch.engine.checkpointing`), and
``ExecutionConfig.workers(n)`` shards the engine over worker processes
(:mod:`repro_torch.engine.cluster`, through ``make_engine``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.stats import ClusterState, PairBlocks, SPLWindow
from repro_torch.device import declared_sync, resolve_device
from repro_torch.engine import serde
from repro_torch.engine.backpressure import CreditController, LatencyTracker
from repro_torch.engine.config import ExecutionConfig
from repro_torch.engine.permute import permute_columns, takes_view
from repro_torch.engine.router import Router, concat_batches
from repro_torch.engine.state import KeyedStore
from repro_torch.engine.topology import (
    Batch,
    Schema,
    Topology,
    _identity_key,
    make_batch,
)
from repro_torch.engine.workqueue import _S_CUR, QUEUE_IMPLS, SoAWorkQueue
from repro_torch.kernels import bucket_argsort, keygroup_partition


@dataclasses.dataclass
class EngineMetrics:
    ticks: int = 0
    processed_tuples: int = 0
    emitted_tuples: int = 0
    cross_node_tuples: int = 0
    intra_node_tuples: int = 0
    dropped_credits: int = 0
    sink_tuples: int = 0
    # Segment-vectorized protocol usage: calls to an operator's fn_seg and
    # tuples processed through it (0 on the deque oracle / use_fn_seg=False).
    seg_calls: int = 0
    seg_tuples: int = 0
    # Batches routed to a schema-declared operator as native-dtype arrays
    # (0 with use_schema=False — the all-object oracle configuration).
    typed_batches: int = 0
    # Compiled-tier usage: fn_jit segment executions, tuples through them,
    # distinct (operator, padding bucket) first calls — the reference's
    # compile count — and host↔device boundaries: one per jit call.
    jit_calls: int = 0
    jit_tuples: int = 0
    jit_compiles: int = 0
    jit_host_syncs: int = 0
    # Routing on the card, per destination operator id: batches routed, and
    # of those the ones partitioned by the keygroup_partition kernel and
    # sorted by the radix_sort kernel (a single-key-group batch needs no
    # sort).  Counted on either device; on the CPU the plain versions run.
    routed_batches: dict = dataclasses.field(default_factory=dict)
    partition_kernel_batches: dict = dataclasses.field(default_factory=dict)
    sort_kernel_batches: dict = dataclasses.field(default_factory=dict)
    # Host↔device copies routing made (keys and composites up; ids,
    # histograms and orders down; the routing table on each change) and
    # their bytes.  Counted on either device (no-op views on the CPU).
    host_device_copies: int = 0
    host_device_bytes: int = 0
    # Host wall seconds of those device round trips (upload, kernels,
    # download — the downloads synchronize), to set against tick time.
    device_route_seconds: float = 0.0
    # Host wall seconds at the engine's layer boundaries, each the sum of
    # its spans' durations (repro_torch.engine.tracing names them) or, for
    # admit_seconds and op_seconds, their self time.  route_seconds and
    # op_seconds are per operator id; route_seconds holds
    # device_route_seconds, gather_seconds and stats_seconds, and no other
    # interval is counted twice.
    admit_seconds: float = 0.0
    route_seconds: dict = dataclasses.field(default_factory=dict)
    op_seconds: dict = dataclasses.field(default_factory=dict)
    jit_seconds: float = 0.0
    jit_put_seconds: float = 0.0
    jit_call_seconds: float = 0.0
    jit_fetch_seconds: float = 0.0
    flush_seconds: float = 0.0
    # Routing's gather after the composite sort: its host seconds (the
    # route.gather spans' self time, without their device round trip), and
    # the columns it took through a fixed-width view or by fancy indexing
    # (object dtype or strided; repro_torch.engine.permute).
    gather_seconds: float = 0.0
    gather_view_columns: int = 0
    gather_object_columns: int = 0
    # Routing's send statistics: the route.stats spans' seconds (the send
    # pairs counted, compaction included, and the cross-node charges), and
    # the send-pair entries the window's dense blocks and its sparse path
    # took (repro_torch.core.stats.SPLWindow).
    stats_seconds: float = 0.0
    pair_dense_entries: int = 0
    pair_sparse_entries: int = 0
    # Multi-worker shards only, per destination operator id: batches
    # partitioned a first time to split them by owning worker (each is
    # partitioned again when the merged batch routes, as in the reference),
    # so partition_kernel_batches counts both.
    exchange_split_batches: dict = dataclasses.field(default_factory=dict)
    # Materialized sink tuples; only populated when the engine was built with
    # ``collect_sinks=True`` (unbounded growth otherwise — benchmarks disable
    # it so they measure the data plane, not list appends).
    sink_outputs: list = dataclasses.field(default_factory=list)
    # Hot-key observability, refreshed each end_period(): the top-k key
    # groups by per-period arrival count as (keygroup, tuples) pairs, and
    # the hottest key group's share of the period's arrivals.
    hot_keygroups: list = dataclasses.field(default_factory=list)
    max_kg_share: float = 0.0


#: Size of the EngineMetrics.hot_keygroups top-k gauge.
HOT_TOPK = 8


def hot_key_summary(
    arrivals: np.ndarray, topk: int = HOT_TOPK
) -> tuple[list[tuple[int, float]], float]:
    """Top-k (keygroup, tuples) by arrival count, plus the hottest share.

    Deterministic under ties (stable sort on descending counts — the lowest
    key-group id wins), zero-arrival entries dropped.  Shared by
    ``Engine.end_period`` and the cluster coordinator's fold.
    """
    total = float(arrivals.sum())
    if total <= 0.0:
        return [], 0.0
    order = np.argsort(-arrivals, kind="stable")[:topk]
    top = [(int(i), float(arrivals[i])) for i in order if arrivals[i] > 0]
    return top, float(arrivals[order[0]]) / total


def _as_batch(outputs) -> Optional[Batch]:
    """Normalize operator output to a Batch.

    A 3-tuple whose first element is an ndarray is the array-native protocol
    (keys array, values/ts arrays or sequences) — the ndarray requirement
    keeps a classic-protocol output that happens to hold exactly three
    (k, v, t) triples unambiguous.  Anything else iterable is the classic
    per-tuple protocol, transposed once.
    """
    if outputs is None:
        return None
    if (
        isinstance(outputs, tuple)
        and len(outputs) == 3
        and isinstance(outputs[0], np.ndarray)
    ):
        keys, values, ts = outputs
        if isinstance(values, np.ndarray) and isinstance(ts, np.ndarray):
            return outputs
        return make_batch(keys, values, ts)
    if not outputs:
        return None
    keys, values, ts = zip(*outputs)
    return make_batch(keys, values, ts)


class Engine:
    """Single-process execution of a Topology over ``num_nodes`` logical nodes,
    with routing on ``device`` (``"cuda"`` by default; ``"cpu"`` runs the
    kernels' plain PyTorch versions).

    How the topology executes — queue layout, operator protocol — is one
    value: ``Engine(topology, num_nodes, config=ExecutionConfig.<preset>())``
    (see :mod:`repro_torch.engine.config`).
    """

    def __init__(
        self,
        topology: Topology,
        num_nodes: int,
        *,
        config: Optional[ExecutionConfig] = None,
        initial_alloc: Optional[np.ndarray] = None,
        capacity: Optional[np.ndarray] = None,
        service_rate: float = 1_000.0,  # cost-units a reference node serves per tick
        ser_cost: float = 0.25,  # cost-units per cross-node tuple (each side)
        seed: int = 0,
        collect_sinks: bool = True,
        device="cuda",
    ) -> None:
        if config is None:
            config = ExecutionConfig()
        if config.num_workers > 1:
            raise ValueError(
                "ExecutionConfig.workers(n) selects the multi-worker runtime: "
                "construct repro_torch.engine.cluster.ClusterEngine (or use "
                "repro_torch.engine.make_engine) instead of Engine"
            )
        self.config = config
        self.device = resolve_device(device)
        queue_impl = config.queue_impl
        use_fn_seg = config.use_fn_seg
        use_schema = config.use_schema
        topology.validate()
        self.topology = topology
        self.num_nodes = num_nodes
        self.capacity = np.ones(num_nodes) if capacity is None else np.asarray(capacity)
        self.service_rate = service_rate
        self.ser_cost = ser_cost
        self.seed = seed
        g = topology.num_keygroups
        # Hot-key splitting reserves extra key-group slots: replicas live in
        # the extended id space [g, g + reserve) and behave as ordinary key
        # groups everywhere downstream of routing (queues, statistics,
        # allocation, migration) once a split assigns them to an operator.
        reserve = config.split_reserve if config.split_degree else 0
        self._g_base = g
        g_eff = g + reserve
        rng = np.random.default_rng(seed)
        if initial_alloc is None:
            initial_alloc = rng.integers(0, num_nodes, size=g)
        initial_alloc = np.asarray(initial_alloc, dtype=np.int64)
        if reserve and len(initial_alloc) == g:
            # Reserved slots park on node 0 until a split places them.
            initial_alloc = np.concatenate(
                [initial_alloc, np.zeros(reserve, dtype=np.int64)]
            )
        self.store = KeyedStore(g_eff)
        self.router = Router(g_eff, initial_alloc)
        # The send pairs of topology edges are counted in dense blocks;
        # replica slots take the window's sparse path.
        self.window = SPLWindow(
            g_eff,
            layout=PairBlocks(
                topology.kg_base_table()[:-1],
                [o.num_keygroups for o in topology.operators],
                topology.downstream(),
                g_eff,
            ),
        )
        self.metrics = EngineMetrics()
        # Set to a list to record (name, start, end) spans on the
        # perf_counter clock (repro_torch.engine.tracing); the caller owns
        # and empties it.  None records none; the counters run either way.
        self.spans: Optional[list] = None
        self._op_names = [o.name for o in topology.operators]
        self.latency = LatencyTracker()
        self.backpressure = CreditController(num_nodes, high_wm=50 * service_rate)
        self.collect_sinks = collect_sinks
        if queue_impl not in QUEUE_IMPLS:
            raise ValueError(f"unknown queue_impl {queue_impl!r}")
        self.queue_impl = queue_impl
        queue_cls = QUEUE_IMPLS[queue_impl]
        self._queues = [queue_cls() for _ in range(num_nodes)]
        # Outputs accumulated during the current tick's drain, flushed as one
        # routed batch per downstream operator: op -> [(batch, src_kg, src_node)].
        self._out_pending: dict[int, list[tuple[Batch, int, int]]] = {}
        self._kg_op = topology.kg_operator()
        if reserve:
            # Free replica slots carry operator 0 (zero load, zero pair
            # rates — inert to the allocators) until a split assigns them.
            self._kg_op = np.concatenate(
                [self._kg_op, np.zeros(reserve, dtype=np.int64)]
            )
        self._cost_per_tuple = [o.cost_per_tuple for o in topology.operators]
        self._op_fn = [o.fn for o in topology.operators]
        # use_fn_seg=False strips the segment protocol: every run takes the
        # per-run fn, giving the oracle data path on the SoA queue.
        self.use_fn_seg = use_fn_seg
        self._op_fn_seg = [o.fn_seg if use_fn_seg else None for o in topology.operators]
        # use_schema=False strips declared schemas: every edge carries the
        # object-array representation (the untyped oracle data path).
        self.use_schema = use_schema
        self._op_schema: list[Optional[Schema]] = [
            o.schema if use_schema else None for o in topology.operators
        ]
        # use_fn_jit=True enables the compiled tier: operators declaring
        # fn_jit execute their contiguous whole-budget segments through
        # repro_torch.engine.jitexec (state in device columns); everything
        # else — and every fallback path — behaves exactly as without it.
        self._op_fn_jit = [
            o.fn_jit if config.use_fn_jit else None for o in topology.operators
        ]
        self._jit = None  # JitRuntime, built on first fn_jit execution
        self._jit_on = any(f is not None for f in self._op_fn_jit)
        # ExecutionConfig.superstep() fuses whole ticks of an eligible linear
        # fn_jit chain on the device (repro_torch.engine.superstep).  With
        # zero fn_jit operators the flag degrades to a no-op: the engine
        # never imports the jit tier or the superstep runtime.
        self.superstep = config.use_superstep and self._jit_on
        self._superstep = None  # SuperstepRuntime, built on first tick
        # Deferred jit segments of the current tick: the drain collects them
        # (accounting immediately, placeholder cells hold output order) and
        # one batched call per operator executes at end of tick — the BSP
        # superstep makes the deferral invisible (outputs only route at
        # _flush_outputs), and a per-run fallback on a jit operator
        # force-flushes first so state updates stay in drain order.
        self._jit_batch: list = []
        self._had_sink_cells = False
        self._sink_tail_base = 0
        # Device copy of the routing table for the on-card node lookup,
        # refreshed whenever Router.version moves.
        self._table_dev: Optional[torch.Tensor] = None
        self._table_version = -1
        # Queued backlog extracted at redirect time, shipped inside the
        # serialize() envelope (raw buffer slices for schema-typed batches).
        self._backlog: dict[int, list[Batch]] = {}
        self._op_nkg = [o.num_keygroups for o in topology.operators]
        self._op_base = [topology.kg_base(i) for i in range(topology.num_operators)]
        # Hot-key splitting bookkeeping: parent → replica slots, slot →
        # parent, per-parent round-robin cursors, the free reserve, and the
        # per-operator extended routing tables (rebuilt on split/unsplit;
        # empty dicts keep the unsplit hot path untouched).
        self._split_map: dict[int, list[int]] = {}
        self._split_parent: dict[int, int] = {}
        self._split_rr: dict[int, int] = {}
        self._free_slots: list[int] = list(range(g, g_eff))
        self._split_ops: dict[int, dict[int, np.ndarray]] = {}
        self._op_ext: dict[int, tuple[np.ndarray, np.ndarray, int]] = {}
        self._op_terminal = [
            o.is_sink or not topology.downstream()[i]
            for i, o in enumerate(topology.operators)
        ]
        # SPLWindow's usage arrays are zeroed in place on reset, so these rows
        # can be cached for the per-tick charges.
        self._cpu_usage = self.window.kg_usage["cpu"]
        self._arrivals = self.window.kg_arrivals
        self._downstream = topology.downstream()
        self._capacity_list = self.capacity.tolist()
        self._ticks_this_period = 0
        self.alive = np.ones(num_nodes, dtype=bool)
        # Source batches admitted so far — the checkpoint/replay cursor
        # (counts _admit_source calls).
        self.ingest_cursor = 0
        # Periodic checkpoints (config.checkpoint) of the single-process
        # engine; the multi-worker coordinator checkpoints through its
        # supervisor instead.
        self._checkpointer = None
        if config.checkpoint is not None and config.num_workers == 1:
            from repro_torch.engine.checkpointing import EngineCheckpointer

            self._checkpointer = EngineCheckpointer(config.checkpoint)

    # ------------------------------------------------------------------ feed
    def source_credits(self) -> int:
        worst = max(q.cost for q in self._queues) if self._queues else 0.0
        return self.backpressure.credits_from_worst(worst)

    def push_source(self, op: str | int, keys, values, ts) -> int:
        """Feed tuples into a source operator; returns tuples accepted."""
        t0 = time.perf_counter()
        oid = self.topology._resolve(op)
        spec = self.topology.operators[oid]
        if not spec.is_source:
            raise ValueError(f"{spec.name!r} is not a source")
        credits = self.source_credits()
        n = min(len(keys), credits)
        if n < len(keys):
            self.metrics.dropped_credits += len(keys) - n
        routed = self._admit_source(oid, keys, values, ts, n) if n else 0.0
        t1 = time.perf_counter()
        self.metrics.admit_seconds += t1 - t0 - routed
        if self.spans is not None:
            self.spans.append(("admit", t0, t1))
        return n

    def _admit_source(self, oid: int, keys, values, ts, n: int) -> float:
        """Convert and route ``n`` already-admitted source tuples; returns
        the routing's seconds.

        Split from :meth:`push_source` so the multi-worker runtime can admit
        coordinator-approved slices without re-running the credit gate
        (cross-worker backpressure is decided once, at the coordinator).
        """
        schema = self._op_schema[oid]
        if schema is not None:
            # Ingestion is the one edge where boxed records still exist:
            # convert once, here, and the batch stays native end to end.
            # (Copy when the conversion aliased the caller's buffer — queued
            # batches must survive the caller refilling it, like make_batch.)
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
        return self._route_batch(oid, batch, src_kgs=None, src_nodes=None)

    # ----------------------------------------------------- device transfers
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One host→device copy (counted, a declared synchronization)."""
        m = self.metrics
        m.host_device_copies += 1
        m.host_device_bytes += arr.nbytes
        with declared_sync(self.device):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _download(self, t: torch.Tensor) -> np.ndarray:
        """One device→host copy (counted, a declared synchronization)."""
        m = self.metrics
        m.host_device_copies += 1
        m.host_device_bytes += t.numel() * t.element_size()
        with declared_sync(self.device):
            return t.cpu().numpy()

    def _device_table(self) -> torch.Tensor:
        """The routing table on the device, re-uploaded on a version change."""
        router = self.router
        if self._table_version != router.version or self._table_dev is None:
            self._table_dev = self._upload(router.table)
            self._table_version = router.version
        return self._table_dev

    # --------------------------------------------------------------- routing
    def _partition_keys(self, op: int, keys, values) -> Optional[np.ndarray]:
        """The batch's integer partition keys when the partition kernel can
        hash them (None → ``Topology.keygroups_of`` on the host).

        Identity ``key_fn`` over integer keys — the reference's kernel test
        (its ``Engine._partition``) — or a ``key_by_value_col`` expression
        over a schema-typed batch that yields one integer per tuple, which
        ``keygroups_of`` hashes with the same mix (its first branch).
        """
        spec = self.topology.operators[op]
        if spec.key_by_value_col is not None:
            if isinstance(values, np.ndarray) and values.dtype.names is not None:
                part = spec.key_by_value_col(values)
                if (
                    isinstance(part, np.ndarray)
                    and part.shape == (len(keys),)
                    and part.dtype.kind in "iu"
                ):
                    return part
            return None
        if (
            spec.key_by_value is None
            and spec.key_fn is _identity_key
            and isinstance(keys, np.ndarray)
            and np.issubdtype(keys.dtype, np.integer)
        ):
            return keys
        return None

    def _partition(self, op: int, keys, values) -> tuple[
        np.ndarray,
        Optional[np.ndarray],
        Optional[torch.Tensor],
    ]:
        """Key-group id per tuple, the arrival histogram when the kernel
        computed it (None → the caller scatters run counts), and the ids on
        the device for the composite sort (None when hashed on the host)."""
        part = self._partition_keys(op, keys, values)
        if part is None:
            return self.topology.keygroups_of(op, keys, values), None, None
        if part.dtype not in (np.dtype(np.int64), np.dtype(np.int32)):
            # Same two's-complement bits the reference's fold sees.
            part = part.astype(np.int64)
        t0 = time.perf_counter()
        ids_dev, hist_dev = keygroup_partition(
            self._upload(part), self._op_nkg[op], base=self._op_base[op]
        )
        kgs, hist = self._download(ids_dev), self._download(hist_dev)
        self._device_routed(op, t0)
        m = self.metrics
        m.partition_kernel_batches[op] = m.partition_kernel_batches.get(op, 0) + 1
        return kgs, hist, ids_dev

    def _device_routed(self, op: int, t0: float) -> None:
        """Count one of routing's device round trips, begun at ``t0``."""
        t1 = time.perf_counter()
        self.metrics.device_route_seconds += t1 - t0
        if self.spans is not None:
            self.spans.append((f"route.device:{self._op_names[op]}", t0, t1))

    def _route_batch(
        self,
        op: int,
        batch: Batch,
        *,
        src_kgs: Optional[np.ndarray],
        src_nodes: Optional[np.ndarray],
    ) -> float:
        """Partition a batch by the operator's key groups and enqueue;
        returns the seconds it took (``route_seconds``, span ``route:<op>``).

        One batched hash + one stable argsort; the sorted arrays are shared by
        every destination node's segment (runs are views, nothing is copied).
        ``src_kgs``/``src_nodes`` carry per-tuple source attribution (None for
        source-feed batches) so send statistics and serialization charges are
        exact yet fully scattered.
        """
        t0 = time.perf_counter()
        self._route(op, batch, src_kgs, src_nodes)
        t1 = time.perf_counter()
        per_op = self.metrics.route_seconds
        per_op[op] = per_op.get(op, 0.0) + (t1 - t0)
        if self.spans is not None:
            self.spans.append((f"route:{self._op_names[op]}", t0, t1))
        return t1 - t0

    def _route(self, op: int, batch: Batch, src_kgs, src_nodes) -> None:
        keys, values, ts = batch
        n = len(keys)
        if n == 0:
            return
        if self._op_schema[op] is not None:
            # Schema-typed edge: callers conform batches before routing, so
            # the object-dtype fallback never allocates on this path.
            if values.dtype.kind == "O" or keys.dtype.kind == "O":
                raise AssertionError(
                    f"object-dtype batch routed to schema-typed operator "
                    f"{self.topology.operators[op].name!r}"
                )
            self.metrics.typed_batches += 1
        m = self.metrics
        m.routed_batches[op] = m.routed_batches.get(op, 0) + 1
        kgs, hist, kgs_dev = self._partition(op, keys, values)
        split = self._split_ops.get(op) if self._split_ops else None
        window = self.window
        base = self._op_base[op]
        if split is None:
            nkg = self._op_nkg[op]
            local = kgs - base
            glob_of = None
        else:
            # Hot-key splitting: fan split parents' tuples round-robin over
            # their replica families, then run the same composite sort over
            # the operator's extended (base + replica) local id space.
            kgs = self._fan_out(kgs, split)
            hist = None
            kgs_dev = None
            local_of, glob_of, nkg = self._op_ext[op]
            local = local_of[kgs]
        spans = self.spans
        tup_nodes = self.router.nodes_of(kgs)
        if src_kgs is not None:
            t = time.perf_counter()
            dense = window.record_send_pairs(src_kgs, kgs)
            m.pair_dense_entries += dense
            m.pair_sparse_entries += n - dense
            cross = tup_nodes != src_nodes
            cs_src = src_kgs[cross]
            n_cross = len(cs_src)
            if n_cross:
                # Cross-node: serialization at src, deserialization at dst,
                # plus network bytes on both (paper §4.3.2 rationale) — one
                # histogram per side, then vector adds on the usage rows.
                g = len(self._arrivals)
                both = np.bincount(cs_src, minlength=g)
                both += np.bincount(kgs[cross], minlength=g)
                self._cpu_usage += both * self.ser_cost
                window.kg_usage["network"] += both
            m.cross_node_tuples += n_cross
            m.intra_node_tuples += n - n_cross
            t1 = time.perf_counter()
            m.stats_seconds += t1 - t
            if spans is not None:
                spans.append((f"route.stats:{self._op_names[op]}", t, t1))
        # Sort tuples by the (destination node, key group) composite so each
        # node's work is ONE contiguous slice of the sorted arrays and runs
        # are adjacent within it — segments can then be drained with whole-
        # slice operations.  The run index lists come from the host's
        # composite histogram; the permutation comes from the card.
        comp = tup_nodes * nkg + local
        chist = np.bincount(comp)
        nz = np.flatnonzero(chist)  # one entry per (node, kg) == per kg
        counts = chist[nz]
        ends = np.cumsum(counts)
        starts = ends - counts
        run_nodes = nz // nkg
        uniq = nz % nkg + base if glob_of is None else glob_of[nz % nkg]
        if hist is None:
            np.add.at(self._arrivals, uniq, counts)
        else:
            window.kg_arrivals[base : base + nkg] += hist
        if len(uniq) == 1:  # common fast case: no permutation needed
            skeys, svalues, sts = keys, values, ts
        else:
            t = time.perf_counter()
            dev0 = m.device_route_seconds
            order = self._sort_composite(op, comp, kgs_dev, nkg, base)
            cols = (keys, values, ts)
            skeys, svalues, sts = permute_columns(order, *cols)
            t1 = time.perf_counter()
            m.gather_seconds += t1 - t - (m.device_route_seconds - dev0)
            n_view = sum(map(takes_view, cols))
            m.gather_view_columns += n_view
            m.gather_object_columns += len(cols) - n_view
            if spans is not None:
                spans.append((f"route.gather:{self._op_names[op]}", t, t1))
        t = time.perf_counter()
        self._enqueue(op, skeys, svalues, sts, uniq, starts, ends, counts, run_nodes)
        if spans is not None:
            spans.append((f"route.enqueue:{self._op_names[op]}", t, time.perf_counter()))

    def _enqueue(self, op, skeys, svalues, sts, uniq, starts, ends, counts, run_nodes) -> None:
        """Push the routed batch's runs onto their nodes' queues; runs of
        key groups whose migration is in flight divert to the router."""
        costs = counts * self._cost_per_tuple[op]
        # Runs for key groups whose migration is in flight divert to the
        # router's buffer; the rest flow to their nodes.  Removal can break
        # run adjacency, so those pushes are marked non-contiguous.
        contig = True
        if self.router.has_in_flight():
            infl = self.router.in_flight_mask(uniq)
            if infl.any():
                sl, el = starts.tolist(), ends.tolist()
                for j in np.flatnonzero(infl).tolist():
                    a, z = sl[j], el[j]
                    self.router.buffer(
                        int(uniq[j]),
                        (skeys[a:z], svalues[a:z], sts[a:z]),
                    )
                keep = ~infl
                uniq, starts, ends = uniq[keep], starts[keep], ends[keep]
                counts, costs = counts[keep], costs[keep]
                run_nodes = run_nodes[keep]
                contig = False
                if len(uniq) == 0:
                    return
        queues = self._queues
        service_rate = self.service_rate
        caps = self._capacity_list
        lat_append = self.latency.samples.append
        if len(uniq) == 1:  # single-run fast path
            node = int(run_nodes[0])
            q = queues[node]
            q.push_runs(
                op,
                skeys,
                svalues,
                sts,
                uniq.tolist(),
                starts.tolist(),
                ends.tolist(),
                costs.tolist(),
                contig=True,
            )
            self._record_admission(node, int(counts[0]))
            return
        # Runs arrive sorted by node: node groups are contiguous slices of
        # the run arrays (and of the tuple arrays — that is the point).
        gstarts = np.flatnonzero(
            np.concatenate(([True], run_nodes[1:] != run_nodes[:-1]))
        )
        unodes = run_nodes[gstarts].tolist()
        gends = np.append(gstarts[1:], len(run_nodes))
        kg_l = uniq.tolist()
        st_l = starts.tolist()
        en_l = ends.tolist()
        co_l = costs.tolist()
        node_counts = np.add.reduceat(counts, gstarts).tolist()
        gsl, gel = gstarts.tolist(), gends.tolist()
        for j in range(len(unodes)):
            a, z = gsl[j], gel[j]
            node = unodes[j]
            q = queues[node]
            q.push_runs(
                op,
                skeys,
                svalues,
                sts,
                kg_l[a:z],
                st_l[a:z],
                en_l[a:z],
                co_l[a:z],
                contig=contig,
            )
            admitted = node_counts[j]
            lat_append(
                (
                    q.cost / max(service_rate * caps[node], 1e-9),
                    admitted if admitted < 16 else 16,
                )
            )

    def _sort_composite(
        self,
        op: int,
        comp: np.ndarray,
        kgs_dev: Optional[torch.Tensor],
        nkg: int,
        base: int,
    ) -> np.ndarray:
        """Stable order of the ``(node, key group)`` composite, sorted by the
        radix_sort kernel: int16 codes when ``num_nodes × nkg`` fits (as the
        reference's numpy sort), int32 otherwise.  The composite is built on
        the card from the partition kernel's ids when they are there (no
        upload), else uploaded from the host."""
        nb = self.num_nodes * nkg
        small = nb <= 32767
        t0 = time.perf_counter()
        if kgs_dev is not None:
            comp_dev = self._device_table()[kgs_dev] * nkg + (kgs_dev - base)
            comp_dev = comp_dev.to(torch.int16 if small else torch.int32)
        else:
            comp_dev = self._upload(comp.astype(np.int16 if small else np.int32))
        order = self._download(bucket_argsort(comp_dev, nb))
        self._device_routed(op, t0)
        m = self.metrics
        m.sort_kernel_batches[op] = m.sort_kernel_batches.get(op, 0) + 1
        return order

    def _superstep_rt(self):
        """The fused-superstep runtime, built on first use."""
        rt = self._superstep
        if rt is None:
            from repro_torch.engine.superstep import SuperstepRuntime

            rt = self._superstep = SuperstepRuntime(self)
        return rt

    def run_supersteps(self, batches) -> int:
        """Run K source batches as K fused supersteps with one host read.

        Steady-state throughput mode (on the card, one CUDA graph replay
        for all K ticks); requires ``ExecutionConfig.superstep()`` and
        drained queues — see :meth:`repro_torch.engine.superstep.
        SuperstepRuntime.run_supersteps` for the exact contract and which
        statistics it records.
        """
        if not self.superstep:
            raise RuntimeError(
                "run_supersteps requires an engine built with "
                "ExecutionConfig.superstep() (superstep=True)"
            )
        return self._superstep_rt().run_supersteps(batches)

    def _record_admission(self, node: int, admitted: int) -> None:
        """Queueing-latency estimate at admission: work ahead / service speed."""
        budget = self.service_rate * self._capacity_list[node]
        self.latency.record(self._queues[node].cost / max(budget, 1e-9), admitted)

    # ------------------------------------------------------------------ tick
    def tick(self) -> None:
        """One BSP superstep: drain every node's queue, then deliver outputs.

        Operator outputs accumulate in ``_out_pending`` during the drain and
        are routed once per downstream operator at the end of the tick, so
        each (op, key group) receives at most one segment push per tick.  CPU
        charges for the drained runs are scattered once, at the end.

        Under ``ExecutionConfig.superstep()`` the fused runtime first tries
        to run the whole tick on the device; any tick it cannot express
        falls back here after materializing its device-pending columns.
        """
        t0 = time.perf_counter()
        self._tick()
        if self.spans is not None:
            self.spans.append(("tick", t0, time.perf_counter()))

    def _tick(self) -> None:
        if self.superstep:
            rt = self._superstep_rt()
            if rt.try_fused_tick():
                return
            rt.flush_to_host()
        self.metrics.ticks += 1
        self._ticks_this_period += 1
        drained_kgs: list[int] = []
        drained_costs: list[float] = []
        service_rate = self.service_rate
        caps = self._capacity_list
        alive = self.alive.tolist()
        jit_on = self._jit_on
        if jit_on:
            self._sink_tail_base = len(self.metrics.sink_outputs)
        for node, q in enumerate(self._queues):
            if not q or not alive[node]:
                continue
            budget = service_rate * caps[node]
            if q.__class__ is SoAWorkQueue:
                self._drain_soa(node, q, budget, drained_kgs, drained_costs)
            else:
                q.drain(budget, self._process, node, drained_kgs, drained_costs)
        if jit_on:
            if self._jit_batch:
                self._flush_jit_batch()
            if self._had_sink_cells:
                self._expand_sink_cells()
        if drained_kgs:
            np.add.at(self._cpu_usage, drained_kgs, drained_costs)
        self._flush_outputs()

    def _drain_soa(
        self, node: int, q, budget: float, out_kgs: list, out_costs: list
    ) -> None:
        """SoA drain with the per-run processing fused into the walk.

        Semantically identical to ``q.drain(budget, self._process, ...)`` —
        the fusion exists to hoist every per-run attribute lookup out of the
        loop (at ~32-tuple runs the data plane is bounded by per-run Python
        overhead, not array math).
        """
        segs = q._segs
        qcost = q.cost
        op_fn = self._op_fn
        terminal = self._op_terminal
        downstream = self._downstream
        store = self.store.raw()
        pending = self._out_pending
        collect = self.collect_sinks
        metrics = self.metrics
        sink_outputs = metrics.sink_outputs
        processed = emitted = sink_n = 0
        seg_calls = seg_tuples = 0
        kg_append, cost_append = out_kgs.append, out_costs.append
        op_fn_seg = self._op_fn_seg
        op_fn_jit = self._op_fn_jit
        while segs and budget > 0:
            seg = segs[0]
            keys, values, ts, op, kgs, starts, ends, costs, cur, contig = seg
            fn = op_fn[op]
            fjit = op_fn_jit[op]
            term = terminal[op]
            downs = downstream[op]
            nruns = len(kgs)
            rem_cost = sum(costs[cur:])
            if budget >= rem_cost:
                # Whole segment fits the budget (the common case): consume
                # its accounting in bulk, then run the per-key-group state
                # transitions without per-run budget bookkeeping.  Budget and
                # queue cost are still subtracted run by run so the float
                # trajectory is bit-identical to the per-run (deque-oracle)
                # path even for non-dyadic operator costs.
                out_kgs.extend(kgs[cur:])
                out_costs.extend(costs[cur:])
                for c in costs[cur:]:
                    budget -= c
                    qcost -= c
                fseg = op_fn_seg[op]
                if contig and (fn is None or fseg is not None or fjit is not None):
                    # Contiguous segment: the runs tile one slice [A:Z) of
                    # the shared arrays, so the whole segment moves with a
                    # handful of array ops — pass-through forwards the slice
                    # as-is; fn_seg ops transform it in one vectorized call;
                    # fn_jit ops defer to the compiled tier's batched
                    # end-of-tick call (placeholder cells keep output order).
                    rk, rs, re_ = kgs[cur:], starts[cur:], ends[cur:]
                    a0, zn = rs[0], re_[-1]
                    n_seg = zn - a0
                    processed += n_seg
                    if fjit is not None and fn is not None:
                        rel_s = [a - a0 for a in rs] if a0 else rs
                        rel_e = [z - a0 for z in re_] if a0 else re_
                        if term:
                            cell = None
                            if collect:
                                cell = []
                                sink_outputs.append(cell)
                                self._had_sink_cells = True
                        else:
                            cell = []
                            for dop in downs:
                                try:
                                    pending[dop].append(cell)
                                except KeyError:
                                    pending[dop] = [cell]
                        self._jit_batch.append(
                            (
                                op,
                                rk,
                                rel_s,
                                rel_e,
                                keys[a0:zn],
                                values[a0:zn],
                                ts[a0:zn],
                                cell,
                                term,
                                node,
                            )
                        )
                        segs.popleft()
                        if budget <= 0:
                            break
                        continue
                    if fn is None:
                        outputs = (keys[a0:zn], values[a0:zn], ts[a0:zn])
                        out_lens = None
                    else:
                        rel_s = [a - a0 for a in rs] if a0 else rs
                        rel_e = [z - a0 for z in re_] if a0 else re_
                        t_op, jit0 = time.perf_counter(), metrics.jit_seconds
                        outputs, out_lens = fseg(
                            store, rk, rel_s, rel_e,
                            keys[a0:zn], values[a0:zn], ts[a0:zn],
                        )
                        self._op_ran(op, t_op, jit0)
                        seg_calls += 1
                        seg_tuples += n_seg
                    if outputs is not None:
                        n_out = len(outputs[0])
                        if n_out:
                            emitted += n_out
                            if term:
                                sink_n += n_out
                                if collect:
                                    sink_outputs.extend(
                                        zip(
                                            outputs[0].tolist(),
                                            outputs[1].tolist(),
                                            outputs[2].tolist(),
                                        )
                                    )
                            else:
                                if out_lens is None:
                                    lens = np.subtract(re_, rs)
                                else:
                                    lens = np.asarray(out_lens, dtype=np.int64)
                                    if len(lens) != len(rk) or lens.sum() != n_out:
                                        raise ValueError(
                                            f"fn_seg of operator {op} returned "
                                            f"out_counts {out_lens!r} inconsistent "
                                            f"with its {n_out}-tuple output over "
                                            f"{len(rk)} runs"
                                        )
                                kg_arr = np.repeat(
                                    np.asarray(rk, dtype=np.int64), lens
                                )
                                item = (outputs, kg_arr, node)
                                for dop in downs:
                                    try:
                                        pending[dop].append(item)
                                    except KeyError:
                                        pending[dop] = [item]
                    segs.popleft()
                    if budget <= 0:
                        break
                    continue
                # Single-downstream fast path: bind the output list once.
                if not term and len(downs) == 1:
                    plist = pending.get(downs[0])
                    if plist is None:
                        plist = pending[downs[0]] = []
                    emit = plist.append
                else:
                    emit = None
                t_op, jit0 = time.perf_counter(), metrics.jit_seconds
                for kg, a, z in zip(kgs[cur:], starts[cur:], ends[cur:]):
                    k, v, t = keys[a:z], values[a:z], ts[a:z]
                    processed += z - a
                    if fn is None:
                        out = (k, v, t)
                    else:
                        if fjit is not None:
                            # Per-run fallback on a jit-tier operator: apply
                            # deferred jit segments first (state updates stay
                            # in drain order), then pull the key group's
                            # device columns into the dict.
                            self._jit_fallback(kg)
                        state = store[kg]
                        state, outputs = fn(state, k, v, t)
                        store[kg] = state
                        if (
                            type(outputs) is tuple
                            and len(outputs) == 3
                            and isinstance(outputs[0], np.ndarray)
                            and isinstance(outputs[1], np.ndarray)
                            and isinstance(outputs[2], np.ndarray)
                        ):
                            out = outputs  # array-native fast protocol
                        else:
                            out = _as_batch(outputs)
                            if out is None:
                                continue
                    ok = out[0]
                    n_out = len(ok)
                    if n_out:
                        emitted += n_out
                        if emit is not None:
                            emit((out, kg, node))
                        elif term:
                            sink_n += n_out
                            if collect:
                                sink_outputs.extend(
                                    zip(ok.tolist(), out[1].tolist(), out[2].tolist())
                                )
                        else:
                            item = (out, kg, node)
                            for dop in downs:
                                try:
                                    pending[dop].append(item)
                                except KeyError:
                                    pending[dop] = [item]
                if fn is not None:
                    self._op_ran(op, t_op, jit0)
                segs.popleft()
                if budget <= 0:
                    break
                continue
            t_op, jit0 = time.perf_counter(), metrics.jit_seconds
            for kg, a, z, c in zip(kgs[cur:], starts[cur:], ends[cur:], costs[cur:]):
                cur += 1
                budget -= c
                qcost -= c
                kg_append(kg)
                cost_append(c)
                k, v, t = keys[a:z], values[a:z], ts[a:z]
                processed += z - a
                if fn is None:  # source pass-through: forward the batch as-is
                    out = (k, v, t)
                else:
                    if fjit is not None:
                        self._jit_fallback(kg)
                    state = store[kg]
                    state, outputs = fn(state, k, v, t)
                    store[kg] = state
                    if (
                        type(outputs) is tuple
                        and len(outputs) == 3
                        and isinstance(outputs[0], np.ndarray)
                        and isinstance(outputs[1], np.ndarray)
                        and isinstance(outputs[2], np.ndarray)
                    ):
                        out = outputs  # array-native fast protocol
                    else:
                        out = _as_batch(outputs)
                        if out is None:
                            if budget <= 0:
                                break
                            continue
                ok = out[0]
                n_out = len(ok)
                if n_out:
                    emitted += n_out
                    if term:
                        sink_n += n_out
                        if collect:
                            sink_outputs.extend(
                                zip(ok.tolist(), out[1].tolist(), out[2].tolist())
                            )
                    else:
                        item = (out, kg, node)
                        for dop in downs:
                            try:
                                pending[dop].append(item)
                            except KeyError:
                                pending[dop] = [item]
                if budget <= 0:
                    break
            if fn is not None:
                self._op_ran(op, t_op, jit0)
            if cur < nruns:
                seg[_S_CUR] = cur
                break
            segs.popleft()
        q.cost = qcost
        metrics.processed_tuples += processed
        metrics.emitted_tuples += emitted
        metrics.sink_tuples += sink_n
        metrics.seg_calls += seg_calls
        metrics.seg_tuples += seg_tuples

    def _op_ran(self, op: int, t0: float, jit0: float) -> None:
        """Count an operator body's run begun at ``t0``, less the compiled
        tier's flushes it forced (``jit_seconds`` read ``jit0`` at ``t0``)."""
        t1 = time.perf_counter()
        m = self.metrics
        per_op = m.op_seconds
        per_op[op] = per_op.get(op, 0.0) + (t1 - t0) - (m.jit_seconds - jit0)
        if self.spans is not None:
            self.spans.append((f"op:{self._op_names[op]}", t0, t1))

    def _jit_fallback(self, kg: int) -> None:
        """Before a per-run ``fn`` on a jit-tier operator's key group: run
        the tick's deferred jit segments, then make the key group's dict
        authoritative."""
        if self._jit_batch:
            self._flush_jit_batch()
        if self._jit is not None:
            self._jit.ensure_dict(kg)

    def _flush_jit_batch(self) -> None:
        """Execute the tick's deferred jit segments, one call per operator.

        Segments collected across nodes concatenate into a single padded
        call per operator (runs stay in drain order; key groups are
        node-disjoint, so state updates commute across the concat), and the
        results are split back into the placeholder cells the drain left in
        ``_out_pending`` / ``sink_outputs`` — output order is therefore
        exactly what per-segment inline execution would have produced.
        """
        t0 = time.perf_counter()
        batch, self._jit_batch = self._jit_batch, []
        by_op: dict[int, list] = {}
        for entry in batch:
            by_op.setdefault(entry[0], []).append(entry)
        metrics = self.metrics
        for op, entries in by_op.items():
            if len(entries) == 1:
                (_, rk, rs, re_, keys, values, ts, *_rest) = entries[0]
                outputs, out_lens = self._jit_exec(op, rk, rs, re_, keys, values, ts)
                parts = [(entries[0], outputs, out_lens)]
            else:
                cat_k = np.concatenate([e[4] for e in entries])
                cat_v = np.concatenate([e[5] for e in entries])
                cat_t = np.concatenate([e[6] for e in entries])
                rk, rs, re_ = [], [], []
                off = 0
                bounds = []
                for e in entries:
                    rk.extend(e[1])
                    rs.extend(a + off for a in e[2])
                    re_.extend(z + off for z in e[3])
                    bounds.append((len(e[1]), len(e[4])))
                    off += len(e[4])
                outputs, out_lens = self._jit_exec(op, rk, rs, re_, cat_k, cat_v, cat_t)
                # Split the concatenated output back per source segment.
                parts = []
                run0 = 0
                pos = 0
                for e, (nrun, n_in) in zip(entries, bounds):
                    if outputs is None:
                        parts.append((e, None, None))
                    elif out_lens is None:
                        parts.append((e, tuple(o[pos : pos + n_in] for o in outputs), None))
                        pos += n_in
                    else:
                        lens_e = out_lens[run0 : run0 + nrun]
                        n_out = int(sum(lens_e))
                        parts.append((e, tuple(o[pos : pos + n_out] for o in outputs), lens_e))
                        pos += n_out
                    run0 += nrun
            for e, outputs, out_lens in parts:
                (_, rk, rs, re_, _, _, _, cell, term, node) = e
                if outputs is None:
                    continue
                n_out = len(outputs[0])
                if n_out == 0:
                    continue
                metrics.emitted_tuples += n_out
                if term:
                    metrics.sink_tuples += n_out
                    if cell is not None:
                        cell.extend(
                            zip(outputs[0].tolist(), outputs[1].tolist(), outputs[2].tolist())
                        )
                else:
                    if out_lens is None:
                        lens = np.subtract(re_, rs)
                    else:
                        lens = np.asarray(out_lens, dtype=np.int64)
                    kg_arr = np.repeat(np.asarray(rk, dtype=np.int64), lens)
                    cell.append((outputs, kg_arr, node))
        t1 = time.perf_counter()
        metrics.jit_seconds += t1 - t0
        if self.spans is not None:
            self.spans.append(("jit", t0, t1))

    def _expand_sink_cells(self) -> None:
        """Flatten this tick's sink placeholder cells in place (cells were
        appended in drain order; only the tick's tail is rebuilt)."""
        self._had_sink_cells = False
        outs = self.metrics.sink_outputs
        base = self._sink_tail_base
        tail = outs[base:]
        del outs[base:]
        for item in tail:
            if type(item) is list:
                outs.extend(item)
            else:
                outs.append(item)

    def _jit_runtime(self):
        """The compiled tier's runtime, built on the first fn_jit execution."""
        jrt = self._jit
        if jrt is None:
            from repro_torch.engine.jitexec import JitRuntime

            jrt = self._jit = JitRuntime(self)
        return jrt

    def _jit_exec(self, op, kgs, starts, ends, keys, values, ts):
        """Hand one contiguous segment to the compiled tier."""
        return self._jit_runtime().execute(op, kgs, starts, ends, keys, values, ts)

    def _process(self, node: int, op: int, kg: int, keys, values, ts) -> None:
        metrics = self.metrics
        metrics.processed_tuples += len(keys)
        fn = self._op_fn[op]
        if fn is None:  # source pass-through: forward the batch as-is
            out_batch: Optional[Batch] = (keys, values, ts)
        else:
            state = self.store.get(kg)
            state, outputs = fn(state, keys, values, ts)
            self.store.put(kg, state)
            out_batch = _as_batch(outputs)
        if out_batch is None:
            return
        ok = out_batch[0]
        n_out = len(ok)
        if n_out == 0:
            return
        metrics.emitted_tuples += n_out
        if self._op_terminal[op]:
            metrics.sink_tuples += n_out
            if self.collect_sinks:
                metrics.sink_outputs.extend(
                    zip(ok.tolist(), out_batch[1].tolist(), out_batch[2].tolist())
                )
            return
        item = (out_batch, kg, node)
        pending = self._out_pending
        for dop in self._downstream[op]:
            try:
                pending[dop].append(item)
            except KeyError:
                pending[dop] = [item]

    def _conform_batch(self, batch: Batch, schema: Optional[Schema]) -> Batch:
        """Fit a batch to the destination operator's declared edge layout.

        Typed target: object batches (fn-oracle outputs, gradual-typing
        boundaries) are promoted into the structured layout in one C-level
        conversion; native batches pass through untouched.  Untyped target:
        structured batches decay to the object representation — the tuples an
        undeclared operator's ``fn`` iterates are then identical whether the
        producer ran columnar or boxed.
        """
        keys, values, ts = batch
        if schema is None:
            if isinstance(values, np.ndarray) and values.dtype.names is not None:
                obj = np.empty(len(values), dtype=object)
                obj[:] = values.tolist()
                return keys, obj, ts
            return batch
        if keys.dtype != schema.key:
            keys = np.asarray(keys, dtype=schema.key)
        if not (isinstance(values, np.ndarray) and values.dtype == schema.value):
            values = schema.typed_values(values)
        return keys, values, ts

    def _flush_outputs(self) -> None:
        """Route this tick's accumulated outputs, one batch per operator.

        An item's source-kg attribution is a scalar (one run) or an array
        (a contiguous segment spanning several key groups).  Each item is
        conformed to the destination's declared schema (or decayed to the
        object path) before batches are concatenated.

        Destinations flush in operator-id order, NOT dict-insertion order:
        the drain paths create ``_out_pending`` keys at different moments
        (the per-run fast path pre-binds its downstream list before any
        emission; the segment path only on first emission), and insertion-
        order flushing would let the same tick push identical segments to a
        node's queue in different FIFO order across execution paths —
        divergent drain trajectories under a binding budget.
        """
        if not self._out_pending:
            return
        pending, self._out_pending = self._out_pending, {}
        op_schema = self._op_schema
        jit_on = self._jit_on
        metrics, spans = self.metrics, self.spans
        for dop in sorted(pending):
            t0 = time.perf_counter()
            items = pending[dop]
            if jit_on:
                # Expand jit placeholder cells (a cell is a list holding the
                # segment's delivered item, empty when it emitted nothing).
                items = [x for it in items for x in (it if type(it) is list else (it,))]
            if not items:  # list pre-bound by the drain fast path, unused
                continue
            schema = op_schema[dop]
            if len(items) == 1:
                batch, src_kg, src_node = items[0]
                batch = self._conform_batch(batch, schema)
                n = len(batch[0])
                if type(src_kg) is np.ndarray:
                    src_kgs = src_kg
                else:
                    src_kgs = np.full(n, src_kg, dtype=np.int64)
                src_nodes = np.full(n, src_node, dtype=np.int64)
            else:
                batches, kg_t, nd_t = zip(*items)
                batch = concat_batches(
                    [self._conform_batch(b, schema) for b in batches]
                )
                m = len(items)
                lens = np.fromiter((len(b[0]) for b in batches), np.int64, count=m)
                if any(type(k) is np.ndarray for k in kg_t):
                    src_kgs = np.concatenate(
                        [
                            k
                            if type(k) is np.ndarray
                            else np.full(int(ln), k, dtype=np.int64)
                            for k, ln in zip(kg_t, lens)
                        ]
                    )
                else:
                    src_kgs = np.repeat(np.fromiter(kg_t, np.int64, count=m), lens)
                src_nodes = np.repeat(np.fromiter(nd_t, np.int64, count=m), lens)
            t1 = time.perf_counter()
            metrics.flush_seconds += t1 - t0
            if spans is not None:
                spans.append((f"flush:{self._op_names[dop]}", t0, t1))
            self._dispatch_batch(dop, batch, src_kgs, src_nodes)

    def _dispatch_batch(self, dop, batch, src_kgs, src_nodes) -> None:
        """Deliver one gathered per-operator batch (the flush → route seam).

        The multi-worker shard engine overrides this to split the batch by
        owning worker and exchange the remote slices before routing — the
        single-process path routes directly.
        """
        self._route_batch(dop, batch, src_kgs=src_kgs, src_nodes=src_nodes)

    # ------------------------------------------------------- SPL statistics
    def end_period(self) -> ClusterState:
        """Fold the SPL window into a ClusterState snapshot and reset it."""
        if self._jit is not None:
            # Statistics (and any external reader of the store) see dicts:
            # refresh every column-authoritative key group before |σ_k| is
            # re-measured below.
            self._jit.sync_store()
        ticks = max(self._ticks_this_period, 1)
        scale = 100.0 / (ticks * self.service_rate)  # → % of a reference node
        t0 = time.perf_counter()
        kg_load, out_pairs, _resource = self.window.fold(scale_to_percent=scale)
        if self.spans is not None:
            self.spans.append(("fold.pairs", t0, time.perf_counter()))
        state = ClusterState.create(
            self.num_nodes,
            self._kg_op,
            kg_load,
            self.router.table.copy(),
            kg_state_bytes=self.store.state_bytes(refresh=True),
            out_rates=out_pairs,
            downstream=self._downstream,
            capacity=self.capacity.copy(),
            kg_tuple_rate=self.window.kg_arrivals / ticks,
        )
        state.alive = self.alive.copy()
        self.metrics.hot_keygroups, self.metrics.max_kg_share = hot_key_summary(
            self.window.kg_arrivals
        )
        self.window.reset()
        self._ticks_this_period = 0
        if self._checkpointer is not None:
            # Cadence hook: every policy.every-th period commits a snapshot
            # (post-fold — the checkpointed window is the new, empty one).
            self._checkpointer.note_period(self)
        return state

    # ------------------------------------------------- direct state migration
    # StateMover protocol (repro_torch.core.migration).
    def redirect(self, keygroup: int, dst: int) -> None:
        """Flip routing for the key group and pull its queued work along.

        The key group's pending runs are masked out of its current node's
        queue into the migration backlog; ``serialize`` ships that backlog
        inside the σ_k envelope (raw buffer slices on schema-typed edges —
        see :mod:`repro_torch.engine.serde`) and ``install`` replays it ahead of
        anything the router buffered during the migration, so the key
        group's outstanding tuples resume at the destination in FIFO order.
        """
        if self._superstep is not None:
            # Shadow segments hold no arrays to extract: materialize the
            # fused runtime's device pendings before touching the queues.
            self._superstep.flush_to_host()
        src = self.router.node_of(keygroup)
        self.router.redirect(keygroup, dst)
        batches, _removed = self._queues[src].extract_keygroup(keygroup)
        if batches:
            self._backlog.setdefault(keygroup, []).extend(batches)

    def serialize(self, keygroup: int) -> bytes:
        if self._superstep is not None:
            # The key group's backlog may reference device-pending columns;
            # flushing first keeps the envelope byte-identical to the
            # classic engine's at any superstep boundary.
            self._superstep.flush_to_host()
        if self._jit is not None:
            # σ_k may live in jit-tier device columns: materialize the dict
            # (insertion order included) so the blob is the oracle's pickle.
            self._jit.ensure_dict(keygroup)
        backlog = self._backlog.pop(keygroup, [])
        return serde.encode_migration(self.store.serialize(keygroup), backlog)

    def install(self, keygroup: int, dst: int, blob: bytes) -> None:
        state_blob, backlog = serde.decode_migration(blob)
        self.store.deserialize(keygroup, state_blob)
        if self._jit is not None:
            # The installed dict is now authoritative; stale device columns
            # will be re-pushed on the key group's next jit execution.
            self._jit.invalidate(keygroup)
        op = int(self._kg_op[keygroup])
        # Any backlog still parked engine-side replays too: a blob that did
        # not come from serialize() (bare checkpoint pickles in failure
        # recovery) must not strand the tuples redirect extracted.  The two
        # backlog sources are mutually exclusive — serialize() pops the
        # engine-side list into the blob — so nothing replays twice.
        replay = backlog + self._backlog.pop(keygroup, []) + self.router.complete(
            keygroup
        )
        if replay:
            # Replay the shipped backlog plus everything buffered during the
            # migration as one batch, in FIFO order.
            batch = concat_batches(replay)
            cost = self._cost_per_tuple[op] * len(batch[0])
            self._queues[dst].push_batch(op, keygroup, batch, cost)
            self._record_admission(dst, len(batch[0]))

    def export_keygroup(self, keygroup: int) -> serde.Envelope:
        """The documented migration export: σ_k + parked backlog as a
        versioned :class:`~repro_torch.engine.serde.Envelope`.

        For a live migration call this after :meth:`redirect` (the redirect
        parks the key group's queued runs into the backlog the envelope
        carries); called standalone it snapshots state plus whatever backlog
        is parked, leaving still-queued runs in place (the checkpoint
        shape).  The bytes are the reference engine's for the same state.
        """
        return serde.Envelope(keygroup, self.serialize(keygroup))

    def import_keygroup(
        self, envelope: serde.Envelope, dst: Optional[int] = None
    ) -> None:
        """Install an exported envelope; ``dst`` defaults to the key group's
        current routed node (i.e. the post-``redirect`` destination)."""
        if dst is None:
            dst = self.router.node_of(envelope.keygroup)
        self.install(envelope.keygroup, dst, envelope.blob)

    def load_reference_state(self, table, blobs: dict[int, bytes]) -> None:
        """Continue from another engine's state: adopt its routing table and
        install one envelope per key group (under ``.jit()`` each installed
        key group's dict becomes authoritative, and its next call rebuilds
        its device columns from it).

        ``table`` is the routing table (key group → node) and ``blobs`` maps
        key groups to migration envelopes — the reference engine's
        ``export_keygroup(kg).blob`` (or this engine's).  In-flight
        migrations and parked backlogs of this engine are dropped; each
        envelope's shipped backlog replays into its key group's queue at the
        node the table names, so both engines continue from the same state
        when the exporter's queues were drained.  Classes the reference
        pickled under ``repro.*`` resolve to the port's copies
        (:func:`repro_torch.engine.serde.loads`).
        """
        table = np.asarray(table, dtype=np.int64)
        if table.shape != self.router.table.shape:
            raise ValueError(
                f"routing table has shape {table.shape}, this engine's "
                f"{self.router.table.shape}"
            )
        if table.size and not (0 <= table.min() and table.max() < self.num_nodes):
            raise ValueError(f"routing table names nodes outside [0, {self.num_nodes})")
        self.router.reset(table)
        self._backlog.clear()
        for kg, blob in blobs.items():
            kg = int(kg)
            self.install(kg, self.router.node_of(kg), blob)

    # ----------------------------------------------------- hot-key splitting
    def _fan_out(
        self, kgs: np.ndarray, split: dict[int, np.ndarray]
    ) -> np.ndarray:
        """Remap split parents' tuples round-robin over their families.

        Round-robin with a cursor persisted across batches — not a key
        sub-hash — because the point of partial-key-grouping is that even a
        *single* hot key spreads across the replicas; per-key affinity would
        pin it to one.  The operator's ``merge_state`` contract (commutative
        monoid state, delta emission) is exactly the license for the
        reordering this introduces.
        """
        if not kgs.flags.writeable:
            kgs = kgs.copy()
        for parent, family in split.items():
            idx = np.flatnonzero(kgs == parent)
            hits = len(idx)
            if not hits:
                continue
            cur = self._split_rr[parent]
            d = len(family)
            kgs[idx] = family[(cur + np.arange(hits)) % d]
            self._split_rr[parent] = (cur + hits) % d
        return kgs

    def split_keygroup(
        self,
        keygroup: int,
        degree: Optional[int] = None,
        nodes: Optional[list[int]] = None,
    ) -> list[int]:
        """Split a hot key group across replicas (partial key grouping).

        Assigns ``degree - 1`` reserved replica key groups to the parent's
        operator and fans the parent's future tuples round-robin across the
        family.  Each replica is an ordinary key group downstream of
        routing — its own partial σ, node placement, queue runs, SPL
        statistics rows (``kg_tuple_rate`` included) — so the allocators
        and the migration machinery balance replicas individually without
        knowing about splitting.  ``nodes`` places the replicas explicitly
        (default: round-robin over the nodes after the parent's).  Returns
        the assigned replica slot ids.

        Requires ``ExecutionConfig(split_degree=...)`` and an operator that
        declares :attr:`~repro_torch.engine.topology.OperatorSpec.merge_state`;
        splitting a non-mergeable operator would silently change its
        semantics, so it is an error instead.
        """
        if not self.config.split_degree:
            raise ValueError(
                "hot-key splitting is disabled: construct the engine with "
                "ExecutionConfig(split_degree=...) — e.g. "
                "ExecutionConfig.split(2)"
            )
        kg = int(keygroup)
        if kg in self._split_parent:
            raise ValueError(
                f"key group {kg} is a replica slot; split its parent "
                f"{self._split_parent[kg]} instead"
            )
        if not 0 <= kg < self._g_base:
            raise ValueError(f"key group {kg} out of range [0, {self._g_base})")
        if kg in self._split_map:
            raise ValueError(f"key group {kg} is already split")
        if self.router.is_in_flight(kg):
            raise ValueError(
                f"key group {kg} has a migration in flight; split it after "
                "the period's migration plan completes"
            )
        op = int(self._kg_op[kg])
        spec = self.topology.operators[op]
        if spec.fn is None:
            raise ValueError(f"cannot split source operator {spec.name!r}")
        if spec.merge_state is None:
            raise ValueError(
                f"operator {spec.name!r} is not split-mergeable: splitting "
                "fans one key group's tuples across replicas with "
                "independent partial states, which is only sound for "
                "commutative/associative delta-emitting operators — declare "
                "OperatorSpec.merge_state to opt in (see docs/workloads.md)"
            )
        d = int(degree) if degree is not None else self.config.split_degree
        if d < 2:
            raise ValueError("split degree must be >= 2")
        if len(self._free_slots) < d - 1:
            raise ValueError(
                f"split reserve exhausted: need {d - 1} replica slots, "
                f"{len(self._free_slots)} free — raise "
                "ExecutionConfig.split_reserve or unsplit a family"
            )
        slots = [self._free_slots.pop(0) for _ in range(d - 1)]
        home = self.router.node_of(kg)
        if nodes is None:
            nodes = [(home + 1 + j) % self.num_nodes for j in range(d - 1)]
        self._kg_op[slots] = op
        # Direct table writes, not Router.redirect: the slots carried no
        # traffic yet, so there is nothing in flight to buffer.
        for slot, node in zip(slots, nodes):
            self.router.table[slot] = int(node)
        self.router.version += 1
        self._split_map[kg] = slots
        for slot in slots:
            self._split_parent[slot] = kg
        self._split_rr[kg] = 0
        self._rebuild_split_tables()
        return slots

    def unsplit_keygroup(self, keygroup: int) -> None:
        """Fold a split family back into its parent.

        Replica partial states merge into the parent's σ through the
        operator's ``merge_state``; queued replica runs re-enqueue under the
        parent at its node; the slots return to the free reserve (operator
        0, node 0 — the inert parked configuration).
        """
        kg = int(keygroup)
        slots = self._split_map.get(kg)
        if slots is None:
            raise ValueError(f"key group {kg} is not split")
        if self.router.is_in_flight(kg) or any(
            self.router.is_in_flight(s) for s in slots
        ):
            raise ValueError(
                f"key group {kg}'s family has a migration in flight; "
                "unsplit after it completes"
            )
        del self._split_map[kg]
        op = int(self._kg_op[kg])
        merge = self.topology.operators[op].merge_state
        home = self.router.node_of(kg)
        cost_per_tuple = self._cost_per_tuple[op]
        for slot in slots:
            node = self.router.node_of(slot)
            batches, _removed = self._queues[node].extract_keygroup(slot)
            backlog = self._backlog.pop(slot, [])
            if backlog or batches:
                batch = concat_batches(backlog + batches)
                self._queues[home].push_batch(
                    op, kg, batch, cost_per_tuple * len(batch[0])
                )
            self.store.put(kg, merge(self.store.get(kg), self.store.get(slot)))
            self.store.put(slot, {})
            self._kg_op[slot] = 0
            self.router.table[slot] = 0
            del self._split_parent[slot]
        self.router.version += 1
        del self._split_rr[kg]
        self._free_slots.extend(slots)
        self._free_slots.sort()
        self._rebuild_split_tables()

    def split_families(self) -> dict[int, list[int]]:
        """Active splits: parent key group → replica slot ids (copies)."""
        return {k: list(v) for k, v in self._split_map.items()}

    @property
    def split_slots_free(self) -> int:
        """Unassigned replica slots remaining in the reserve."""
        return len(self._free_slots)

    def split_eligible(self) -> np.ndarray:
        """Boolean mask over key groups whose operator can split (declares
        ``merge_state`` and is not a source) — the splitter policy's input,
        so it never proposes a split the engine would reject.  Free replica
        slots are ineligible (they park on operator 0, a source)."""
        op_ok = np.array(
            [
                o.merge_state is not None and o.fn is not None
                for o in self.topology.operators
            ],
            dtype=bool,
        )
        mask = op_ok[self._kg_op]
        if self._split_parent:
            mask[sorted(self._split_parent)] = False  # replicas split via parent
        return mask

    def _rebuild_split_tables(self) -> None:
        """Recompute the per-operator fan-out dicts and extended routing
        tables (global id ↔ extended local index) after a split/unsplit."""
        by_op: dict[int, dict[int, np.ndarray]] = {}
        slots_of_op: dict[int, list[int]] = {}
        for parent in sorted(self._split_map):
            op = int(self._kg_op[parent])
            family = [parent] + self._split_map[parent]
            by_op.setdefault(op, {})[parent] = np.asarray(family, dtype=np.int64)
            slots_of_op.setdefault(op, []).extend(self._split_map[parent])
        op_ext: dict[int, tuple[np.ndarray, np.ndarray, int]] = {}
        g_eff = len(self._kg_op)
        for op, slots in slots_of_op.items():
            base, nkg = self._op_base[op], self._op_nkg[op]
            glob_of = np.concatenate(
                [
                    np.arange(base, base + nkg, dtype=np.int64),
                    np.asarray(sorted(slots), dtype=np.int64),
                ]
            )
            local_of = np.full(g_eff, -1, dtype=np.int64)
            local_of[glob_of] = np.arange(len(glob_of))
            op_ext[op] = (local_of, glob_of, len(glob_of))
        self._op_ext = op_ext
        self._split_ops = by_op

    # --------------------------------------------------------------- elastic
    def add_nodes(self, count: int, capacity: float = 1.0) -> None:
        self.num_nodes += count
        self.capacity = np.concatenate([self.capacity, np.full(count, capacity)])
        self.alive = np.concatenate([self.alive, np.ones(count, dtype=bool)])
        queue_cls = QUEUE_IMPLS[self.queue_impl]
        self._queues.extend(queue_cls() for _ in range(count))
        self._capacity_list = self.capacity.tolist()
        self.backpressure.num_nodes = self.num_nodes

    def fail_node(self, node: int) -> np.ndarray:
        """Simulate a node crash: queue lost, key groups orphaned.

        Returns the orphaned key groups; the controller reallocates them.
        """
        if self._superstep is not None:
            # clear() below must see real segments, and surviving nodes'
            # shadow segments must not dangle on dropped device pendings.
            self._superstep.flush_to_host()
        self.alive[node] = False
        self._queues[node].clear()
        return self.router.keygroups_on(node)

    # ------------------------------------------------------------- inspection
    def queue_costs(self) -> list[float]:
        """Per-node queued work in cost-units (index = node id)."""
        return [q.cost for q in self._queues]

    def finalize(self) -> None:
        """Release execution resources; results stay readable.

        A no-op for the single-process engine, kept so drivers can call it
        unconditionally as on the reference's engines.
        """

