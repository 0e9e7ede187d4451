"""Cluster model and SPL statistics (paper §3).

The controller maintains, per *statistics period* (SPL), the load of every key
group (``gLoad_k``), the load of every node (``load_i``), and the pairwise
communication rates ``out(g_i, g_j)``.  All of the paper's algorithms consume
exactly this state, so it is factored into one dataclass,
:class:`ClusterState`, shared by the MILP, ALBIC, the baselines and the
engine's controller.

Pairwise rates are stored *sparse* (:class:`PairRates` — COO triples over the
(G, G) pair space): a stream job's communication graph has O(G) hot pairs,
not G², and the dense matrix is 11 MB at the paper's 1200 key groups and
quadratically worse beyond.  ``ClusterState.out_rates`` still materializes
the dense matrix on demand (cached) so existing dense consumers keep working,
while ALBIC / COLA / the collocation metrics walk the sparse triples.

Loads are percentage points of the bottleneck resource in ``[0, 100]`` as in
the paper.  Heterogeneity (paper §3) is carried as a per-node ``capacity``
weight: a node with capacity 2.0 exhibits half the load for the same work.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


class PairRates:
    """Sparse ``out(g_i, g_j)``: COO triples, sorted by (src, dst).

    Immutable once built; row access (``rows_csr``) and symmetric edge
    extraction (``symmetric_edges``) are the two shapes the optimizers need.
    """

    __slots__ = ("src", "dst", "rate", "num_keygroups", "_indptr")

    def __init__(
        self, src: np.ndarray, dst: np.ndarray, rate: np.ndarray, num_keygroups: int
    ) -> None:
        self.src = np.asarray(src, dtype=np.int64)
        self.dst = np.asarray(dst, dtype=np.int64)
        self.rate = np.asarray(rate, dtype=np.float64)
        self.num_keygroups = int(num_keygroups)
        self._indptr: np.ndarray | None = None

    # -- constructors --------------------------------------------------------
    @classmethod
    def empty(cls, num_keygroups: int) -> "PairRates":
        z = np.empty(0, dtype=np.int64)
        return cls(z, z, np.empty(0), num_keygroups)

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "PairRates":
        dense = np.asarray(dense)
        g = dense.shape[0]
        src, dst = np.nonzero(dense)
        return cls(src, dst, dense[src, dst], g)

    @classmethod
    def from_codes(
        cls, codes: np.ndarray, weights: np.ndarray, num_keygroups: int
    ) -> "PairRates":
        """Build from ``src * G + dst`` pair codes with per-entry weights.

        Codes need not be unique; duplicate pairs are summed.  ``np.unique``
        returns sorted codes, which is exactly the (src, dst)-lexicographic
        order the class guarantees.
        """
        if len(codes) == 0:
            return cls.empty(num_keygroups)
        uniq, inv = np.unique(codes, return_inverse=True)
        rate = np.bincount(inv, weights=weights, minlength=len(uniq))
        return cls(uniq // num_keygroups, uniq % num_keygroups, rate, num_keygroups)

    # -- views ----------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return len(self.rate)

    def total(self) -> float:
        return float(self.rate.sum())

    def to_dense(self) -> np.ndarray:
        g = self.num_keygroups
        dense = np.zeros((g, g))
        dense[self.src, self.dst] = self.rate
        return dense

    def rows_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR view: (indptr, dst, rate) with rows sorted by src (invariant)."""
        if self._indptr is None:
            counts = np.bincount(self.src, minlength=self.num_keygroups)
            self._indptr = np.concatenate([[0], np.cumsum(counts)])
        return self._indptr, self.dst, self.rate

    def intra_rate(self, alloc: np.ndarray) -> float:
        """Total rate of pairs whose endpoints share a node under ``alloc``."""
        if self.nnz == 0:
            return 0.0
        same = alloc[self.src] == alloc[self.dst]
        return float(self.rate[same].sum())

    def symmetric_edges(
        self, index_map: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Undirected positive-weight edges (u < v, lexicographic order).

        Edge weight is ``out[u, v] + out[v, u]`` — the symmetrized rate the
        graph partitioners cut.  ``index_map`` (len G, −1 = excluded)
        restricts to a vertex subset and relabels into its local index space;
        self-loops are dropped either way.
        """
        if index_map is None:
            u, v, m = self.src, self.dst, self.num_keygroups
        else:
            u = index_map[self.src]
            v = index_map[self.dst]
            keep = (u >= 0) & (v >= 0)
            u, v = u[keep], v[keep]
            m = int(index_map.max()) + 1 if len(index_map) else 0
        if len(u) == 0:
            z = np.empty(0, dtype=np.int64)
            return z, z, np.empty(0)
        rate = self.rate if index_map is None else self.rate[keep]
        off = (u != v)
        lo = np.minimum(u[off], v[off])
        hi = np.maximum(u[off], v[off])
        codes = lo * m + hi
        uniq, inv = np.unique(codes, return_inverse=True)
        w = np.bincount(inv, weights=rate[off], minlength=len(uniq))
        return uniq // m, uniq % m, w

    def copy(self) -> "PairRates":
        return PairRates(
            self.src.copy(), self.dst.copy(), self.rate.copy(), self.num_keygroups
        )


def _as_pairs(out_rates, g: int) -> PairRates:
    if out_rates is None:
        return PairRates.empty(g)
    if isinstance(out_rates, PairRates):
        return out_rates
    return PairRates.from_dense(np.asarray(out_rates))


@dataclasses.dataclass
class ClusterState:
    """Allocation + statistics snapshot consumed by the optimizers.

    Attributes:
      num_nodes: |N|.
      capacity: (num_nodes,) relative node capacities (1.0 == reference node).
      kill: (num_nodes,) bool — marked for removal by the scaling algorithm
        (the paper's set ``B``; ``A`` is the complement).
      alive: (num_nodes,) bool — False once a node failed or was terminated.
      kg_operator: (G,) int — operator that owns each key group.
      kg_load: (G,) float — ``gLoad_k`` over the last SPL.
      kg_state_bytes: (G,) float — |σ_k|, the serialized state size.
      alloc: (G,) int — current node of each key group (``q_{i,k}``).
      out_pairs: sparse ``out(g_i, g_j)`` tuple rates over the SPL
        (:class:`PairRates`); the dense (G, G) matrix is available on demand
        through the :attr:`out_rates` property.
      kg_tuple_rate: (G,) float — per-key-group arrival rate (tuples/tick)
        over the SPL, or None when not measured.
      downstream: operator adjacency — downstream[o] = list of operator ids.
    """

    num_nodes: int
    capacity: np.ndarray
    kill: np.ndarray
    alive: np.ndarray
    kg_operator: np.ndarray
    kg_load: np.ndarray
    kg_state_bytes: np.ndarray
    alloc: np.ndarray
    out_pairs: PairRates
    downstream: dict[int, list[int]]
    kg_tuple_rate: np.ndarray | None = None

    @property
    def out_rates(self) -> np.ndarray:
        """Dense (G, G) ``out(g_i, g_j)`` view, materialized lazily (cached)."""
        cached = getattr(self, "_out_dense", None)
        if cached is None:
            cached = self.out_pairs.to_dense()
            object.__setattr__(self, "_out_dense", cached)
        return cached

    # -- constructors --------------------------------------------------------
    @staticmethod
    def create(
        num_nodes: int,
        kg_operator: np.ndarray,
        kg_load: np.ndarray,
        alloc: np.ndarray,
        *,
        kg_state_bytes: np.ndarray | None = None,
        out_rates=None,
        downstream: dict[int, list[int]] | None = None,
        capacity: np.ndarray | None = None,
        kg_tuple_rate: np.ndarray | None = None,
    ) -> "ClusterState":
        g = len(kg_load)
        return ClusterState(
            num_nodes=num_nodes,
            capacity=(
                np.ones(num_nodes) if capacity is None else np.asarray(
                    capacity,
                    dtype=np.float64,
                )
            ),
            kill=np.zeros(num_nodes, dtype=bool),
            alive=np.ones(num_nodes, dtype=bool),
            kg_operator=np.asarray(kg_operator, dtype=np.int64),
            kg_load=np.asarray(kg_load, dtype=np.float64),
            kg_state_bytes=(
                np.full(g, 1.0)
                if kg_state_bytes is None
                else np.asarray(kg_state_bytes, dtype=np.float64)
            ),
            alloc=np.asarray(alloc, dtype=np.int64),
            out_pairs=_as_pairs(out_rates, g),
            downstream=dict(downstream or {}),
            kg_tuple_rate=kg_tuple_rate,
        )

    # -- derived quantities (paper Table 1 / §4.3.1) --------------------------
    @property
    def num_keygroups(self) -> int:
        return int(self.kg_load.shape[0])

    @property
    def nodes_a(self) -> np.ndarray:
        """A = nodes not marked for removal (and alive)."""
        return np.where(~self.kill & self.alive)[0]

    @property
    def nodes_b(self) -> np.ndarray:
        """B = nodes marked for removal (still alive, draining)."""
        return np.where(self.kill & self.alive)[0]

    def node_loads(self, alloc: np.ndarray | None = None) -> np.ndarray:
        """load_i: capacity-normalized sum of gLoad over key groups on i."""
        alloc = self.alloc if alloc is None else alloc
        raw = np.bincount(alloc, weights=self.kg_load, minlength=self.num_nodes)
        return raw / self.capacity

    def mean_load(self) -> float:
        """Paper: mean = ceil( (1/|A|) · Σ_{n_i ∈ N} load_i )."""
        a = self.nodes_a
        if len(a) == 0:
            return 0.0
        total = float(self.node_loads()[self.alive].sum())
        return math.ceil(total / len(a))

    def load_distance(self, alloc: np.ndarray | None = None) -> float:
        """max_{n_i ∈ A} |load_i − mean| for the given (or current) alloc."""
        loads = self.node_loads(alloc)
        a = self.nodes_a
        if len(a) == 0:
            return 0.0
        return float(np.max(np.abs(loads[a] - self.mean_load())))

    def migration_costs(self, alpha: float = 1.0) -> np.ndarray:
        """mc_k = α · |σ_k| (paper §4.3.1 cost model)."""
        return alpha * self.kg_state_bytes

    # -- communication metrics (ALBIC §4.3.2, experiments §5) -----------------
    def collocation_factor(self, alloc: np.ndarray | None = None) -> float:
        """Fraction of inter-key-group traffic that stays intra-node, in %.

        Real Job 2's "perfect collocation" (all communicating pairs on one
        node) measures 100; a worst-case allocation measures ~0.
        """
        alloc = self.alloc if alloc is None else alloc
        total = self.out_pairs.total()
        if total <= 0:
            return 0.0
        return 100.0 * self.out_pairs.intra_rate(alloc) / total

    def cross_node_rate(self, alloc: np.ndarray | None = None) -> float:
        """Total tuple rate crossing node boundaries (drives the load index)."""
        alloc = self.alloc if alloc is None else alloc
        return self.out_pairs.total() - self.out_pairs.intra_rate(alloc)

    def system_load(
        self, alloc: np.ndarray | None = None, ser_cost: float = 0.0
    ) -> float:
        """Average node load including serialization cost of cross-node sends.

        ``ser_cost`` is load points charged per unit of cross-node rate (it
        models CPU serialization + deserialization in the paper; ICI/bytes on
        TPU).  The *load index* metric divides this by its value at t0.
        """
        alloc = self.alloc if alloc is None else alloc
        base = float(self.kg_load.sum())
        comm = ser_cost * self.cross_node_rate(alloc)
        a = self.nodes_a
        return (base + comm) / max(len(a), 1)

    def copy(self) -> "ClusterState":
        return ClusterState(
            num_nodes=self.num_nodes,
            capacity=self.capacity.copy(),
            kill=self.kill.copy(),
            alive=self.alive.copy(),
            kg_operator=self.kg_operator.copy(),
            kg_load=self.kg_load.copy(),
            kg_state_bytes=self.kg_state_bytes.copy(),
            alloc=self.alloc.copy(),
            out_pairs=self.out_pairs.copy(),
            downstream={k: list(v) for k, v in self.downstream.items()},
            kg_tuple_rate=(
                None if self.kg_tuple_rate is None else self.kg_tuple_rate.copy()
            ),
        )


@dataclasses.dataclass
class SPLWindow:
    """Accumulates raw statistics over one statistics period (SPL).

    The engine's controller feeds tuple counts / resource samples in; at the
    end of the window it folds them into a :class:`ClusterState` snapshot.
    Resources are tracked separately so the *bottleneck resource* (the one
    with greatest total usage — paper §3) can be selected per window.

    Pair rates accumulate sparsely: each recorded batch appends its
    ``src * G + dst`` codes, and :meth:`fold` reduces them to unique
    (src, dst, count) triples — O(recorded tuples) memory with periodic
    compaction, never a (G, G) matrix.  Per-key-group arrival histograms
    (``kg_arrivals``) come either from per-run counts on the host or
    straight from the ``keygroup_partition`` kernel's histogram output — the
    two are validated bit-identical.
    """

    num_keygroups: int
    resources: tuple[str, ...] = ("cpu", "network", "memory")
    compact_threshold: int = 1 << 21  # pending pair entries before compaction

    def __post_init__(self) -> None:
        g = self.num_keygroups
        self.kg_usage = {r: np.zeros(g) for r in self.resources}
        self.kg_arrivals = np.zeros(g)
        # Pair sends accumulate as raw (src, dst[, weight]) array refs — the
        # record path is two list appends; codes are computed at compaction.
        self._pair_src: list[np.ndarray] = []
        self._pair_dst: list[np.ndarray] = []
        self._pair_weights: list[np.ndarray | None] = []  # None → all-ones
        self._compacted: tuple[np.ndarray, np.ndarray] | None = None
        self._pair_entries = 0
        self.samples = 0

    def record_processing(self, resource: str, kg: int, usage: float) -> None:
        self.kg_usage[resource][kg] += usage

    def record_send(self, src_kg: int, dst_kg: int, tuples: float) -> None:
        self._pair_src.append(np.array([src_kg], dtype=np.int64))
        self._pair_dst.append(np.array([dst_kg], dtype=np.int64))
        self._pair_weights.append(np.array([tuples]))
        self._pair_entries += 1
        if self._pair_entries > self.compact_threshold:
            self._compact_pairs()

    def record_processing_many(
        self, resource: str, kgs: np.ndarray, usage: np.ndarray
    ) -> None:
        """Batched :meth:`record_processing` (kgs need not be unique)."""
        np.add.at(self.kg_usage[resource], kgs, usage)

    def record_send_pairs(self, src_kgs: np.ndarray, dst_kgs: np.ndarray) -> None:
        """Batched :meth:`record_send`: one tuple per (src, dst) pair entry.

        Holds references to the arrays (callers pass freshly built
        attribution arrays, never mutated afterwards).
        """
        self._pair_src.append(src_kgs)
        self._pair_dst.append(dst_kgs)
        self._pair_weights.append(None)
        self._pair_entries += len(src_kgs)
        if self._pair_entries > self.compact_threshold:
            self._compact_pairs()

    def record_send_counts(
        self, src_kgs: np.ndarray, dst_kgs: np.ndarray, counts: np.ndarray
    ) -> None:
        """Batched :meth:`record_send` with explicit per-pair tuple counts.

        Equivalent to :meth:`record_send_pairs` over ``counts[j]`` repeats of
        each ``(src_kgs[j], dst_kgs[j])`` pair — the compaction sums weights,
        and integer counts sum exactly in float64 — without materializing the
        per-tuple attribution arrays (the fused superstep path only ever
        knows per-edge counts).
        """
        self._pair_src.append(np.asarray(src_kgs, dtype=np.int64))
        self._pair_dst.append(np.asarray(dst_kgs, dtype=np.int64))
        self._pair_weights.append(np.asarray(counts, dtype=np.float64))
        self._pair_entries += len(src_kgs)
        if self._pair_entries > self.compact_threshold:
            self._compact_pairs()

    def record_arrivals(self, base: int, hist: np.ndarray) -> None:
        """Add one operator's per-key-group tuple histogram (kernel output)."""
        self.kg_arrivals[base : base + len(hist)] += hist

    def pair_counts(self) -> "PairRates":
        """Reduce the accumulated pair sends into sparse rates."""
        self._compact_pairs()
        if self._compacted is None:
            return PairRates.empty(self.num_keygroups)
        codes, weights = self._compacted
        g = self.num_keygroups
        return PairRates(codes // g, codes % g, weights, g)

    def _compact_pairs(self) -> None:
        if not self._pair_src and self._compacted is None:
            return
        g = self.num_keygroups
        parts_c = [] if self._compacted is None else [self._compacted[0]]
        parts_w = [] if self._compacted is None else [self._compacted[1]]
        if self._pair_src:
            src = np.concatenate(self._pair_src)
            dst = np.concatenate(self._pair_dst)
            parts_c.append(src * g + dst)
            parts_w.append(
                np.concatenate(
                    [
                        np.ones(len(s)) if w is None else w
                        for s, w in zip(self._pair_src, self._pair_weights)
                    ]
                )
            )
        codes = np.concatenate(parts_c) if len(parts_c) > 1 else parts_c[0]
        weights = np.concatenate(parts_w) if len(parts_w) > 1 else parts_w[0]
        uniq, inv = np.unique(codes, return_inverse=True)
        summed = np.bincount(inv, weights=weights, minlength=len(uniq))
        self._compacted = (uniq, summed)
        self._pair_src = []
        self._pair_dst = []
        self._pair_weights = []
        self._pair_entries = len(uniq)

    def bottleneck_resource(self) -> str:
        totals = {r: float(u.sum()) for r, u in self.kg_usage.items()}
        return max(totals, key=totals.get)  # type: ignore[arg-type]

    def fold(self, scale_to_percent: float = 1.0) -> tuple[
        np.ndarray,
        "PairRates",
        str,
    ]:
        """Return (gLoad vector on bottleneck resource, pair rates, resource)."""
        r = self.bottleneck_resource()
        return self.kg_usage[r] * scale_to_percent, self.pair_counts(), r

    def reset(self) -> None:
        for r in self.resources:
            self.kg_usage[r][:] = 0
        self.kg_arrivals[:] = 0
        self._pair_src = []
        self._pair_dst = []
        self._pair_weights = []
        self._compacted = None
        self._pair_entries = 0
        self.samples = 0
