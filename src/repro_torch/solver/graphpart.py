"""Balanced graph partitioning (METIS stand-in).

ALBIC (Algorithm 2, step 2) and the COLA baseline both need *balanced graph
partitioning*: split a weighted graph into ``nparts`` parts with (approximately)
equal total vertex weight while minimizing the weight of cut edges.  The paper
uses METIS v5.1 [20]; this module implements the same multilevel scheme in
numpy:

1. **Coarsening** — heavy-edge matching collapses matched vertex pairs until
   the graph is small (or matching stalls).
2. **Initial partitioning** — greedy region growing over the coarsest graph,
   seeded by heaviest vertices, targeting equal part weights.
3. **Uncoarsening + refinement** — project labels back up and run
   Fiduccia–Mattheyses-style boundary refinement: move border vertices to the
   neighbouring part with maximal cut gain subject to the balance constraint.

The implementation favours clarity and determinism (seeded RNG) over raw
speed; the graphs ALBIC feeds it are collocation sets (tens to a few hundred
key groups), and COLA's largest benchmark graph is 1,200 vertices.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """Undirected weighted graph in COO triplet form (each edge stored once)."""

    num_vertices: int
    edge_u: np.ndarray  # (e,) int
    edge_v: np.ndarray  # (e,) int
    edge_w: np.ndarray  # (e,) float
    vertex_w: np.ndarray  # (n,) float

    def __post_init__(self) -> None:
        self.edge_u = np.asarray(self.edge_u, dtype=np.int64)
        self.edge_v = np.asarray(self.edge_v, dtype=np.int64)
        self.edge_w = np.asarray(self.edge_w, dtype=np.float64)
        self.vertex_w = np.asarray(self.vertex_w, dtype=np.float64)
        if (
            self.edge_u.shape != self.edge_v.shape
            or self.edge_u.shape != self.edge_w.shape
        ):
            raise ValueError("edge arrays must share a shape")
        if self.vertex_w.shape != (self.num_vertices,):
            raise ValueError("vertex_w must have shape (num_vertices,)")

    @property
    def num_edges(self) -> int:
        return int(self.edge_u.shape[0])

    def adjacency(self) -> list[dict[int, float]]:
        adj: list[dict[int, float]] = [dict() for _ in range(self.num_vertices)]
        for u, v, w in zip(self.edge_u, self.edge_v, self.edge_w):
            if u == v:
                continue
            u, v = int(u), int(v)
            adj[u][v] = adj[u].get(v, 0.0) + float(w)
            adj[v][u] = adj[v].get(u, 0.0) + float(w)
        return adj


def cut_weight(graph: Graph, labels: np.ndarray) -> float:
    """Total weight of edges whose endpoints live in different parts."""
    mask = labels[graph.edge_u] != labels[graph.edge_v]
    return float(graph.edge_w[mask].sum())


def part_weights(graph: Graph, labels: np.ndarray, nparts: int) -> np.ndarray:
    return np.bincount(labels, weights=graph.vertex_w, minlength=nparts)


# ---------------------------------------------------------------------------
# Coarsening
# ---------------------------------------------------------------------------


def _heavy_edge_matching(graph: Graph, rng: np.random.Generator) -> np.ndarray:
    """Return match[i] = partner vertex (or i itself when unmatched)."""
    adj = graph.adjacency()
    match = np.arange(graph.num_vertices)
    visited = np.zeros(graph.num_vertices, dtype=bool)
    order = rng.permutation(graph.num_vertices)
    for u in order:
        if visited[u]:
            continue
        best_v, best_w = -1, -1.0
        for v, w in adj[u].items():
            if not visited[v] and v != u and w > best_w:
                best_v, best_w = v, w
        if best_v >= 0:
            match[u], match[best_v] = best_v, u
            visited[best_v] = True
        visited[u] = True
    return match


def _coarsen(graph: Graph, match: np.ndarray) -> tuple[Graph, np.ndarray]:
    """Collapse matched pairs; return (coarse graph, fine->coarse map)."""
    n = graph.num_vertices
    cmap = -np.ones(n, dtype=np.int64)
    nxt = 0
    for u in range(n):
        if cmap[u] >= 0:
            continue
        v = int(match[u])
        cmap[u] = nxt
        if v != u and cmap[v] < 0:
            cmap[v] = nxt
        nxt += 1
    cvw = np.zeros(nxt)
    np.add.at(cvw, cmap, graph.vertex_w)
    cu, cv = cmap[graph.edge_u], cmap[graph.edge_v]
    keep = cu != cv
    cu, cv, cw = cu[keep], cv[keep], graph.edge_w[keep]
    # Merge parallel edges.
    lo, hi = np.minimum(cu, cv), np.maximum(cu, cv)
    key = lo * nxt + hi
    order = np.argsort(key, kind="stable")
    key, lo, hi, cw = key[order], lo[order], hi[order], cw[order]
    if key.size:
        uniq, start = np.unique(key, return_index=True)
        sums = np.add.reduceat(cw, start)
        eu, ev, ew = lo[start], hi[start], sums
    else:
        eu = ev = np.zeros(0, dtype=np.int64)
        ew = np.zeros(0)
    return Graph(nxt, eu, ev, ew, cvw), cmap


# ---------------------------------------------------------------------------
# Initial partitioning
# ---------------------------------------------------------------------------


def _greedy_grow(graph: Graph, nparts: int, rng: np.random.Generator) -> np.ndarray:
    """Region-growing initial partition targeting equal part weights."""
    n = graph.num_vertices
    target = graph.vertex_w.sum() / nparts
    adj = graph.adjacency()
    labels = -np.ones(n, dtype=np.int64)
    weights = np.zeros(nparts)
    # Seed parts spread apart: first the heaviest vertex, then repeatedly the
    # vertex least connected to any existing seed (uniform weights would
    # otherwise place every seed inside one dense cluster).
    conn = np.zeros(n)
    seeds = [int(np.argmax(graph.vertex_w + rng.uniform(0, 1e-6, n)))]
    for _ in range(nparts - 1):
        for v, w in adj[seeds[-1]].items():
            conn[v] += w
        conn[seeds[-1]] = np.inf
        cand = np.where(np.isfinite(conn))[0]
        seeds.append(int(cand[np.argmin(conn[cand])]))
    frontier: list[list[int]] = [[] for _ in range(nparts)]
    for p, s in enumerate(seeds):
        if labels[s] < 0:
            labels[s] = p
            weights[p] += graph.vertex_w[s]
            frontier[p] = [int(s)]
    # Grow the lightest part by its best-connected frontier vertex.
    unassigned = set(int(i) for i in range(n) if labels[i] < 0)
    while unassigned:
        p = int(np.argmin(weights))
        # Candidate = unassigned neighbour of part p with max connectivity.
        best_u, best_gain = -1, -1.0
        for f in frontier[p]:
            for v, w in adj[f].items():
                if labels[v] < 0 and w > best_gain:
                    best_u, best_gain = v, w
        if best_u < 0:  # disconnected: pull an arbitrary unassigned vertex
            best_u = next(iter(unassigned))
        labels[best_u] = p
        weights[p] += graph.vertex_w[best_u]
        frontier[p].append(best_u)
        unassigned.discard(best_u)
        if weights[p] > target * 1.5:
            frontier[p] = []  # stop growing an overweight part actively
    return labels


# ---------------------------------------------------------------------------
# Refinement
# ---------------------------------------------------------------------------


def _fm_refine(
    graph: Graph,
    labels: np.ndarray,
    nparts: int,
    *,
    balance_tol: float,
    max_passes: int = 8,
) -> np.ndarray:
    """FM-style boundary refinement under a balance constraint."""
    labels = labels.copy()
    adj = graph.adjacency()
    total = graph.vertex_w.sum()
    max_part = (total / nparts) * (1.0 + balance_tol)
    weights = part_weights(graph, labels, nparts)
    for _ in range(max_passes):
        moved = 0
        for u in range(graph.num_vertices):
            lu = labels[u]
            # Connectivity of u to each part.
            conn = np.zeros(nparts)
            for v, w in adj[u].items():
                conn[labels[v]] += w
            internal = conn[lu]
            # Best external part by gain, respecting balance.
            best_p, best_gain = -1, 0.0
            for p in range(nparts):
                if p == lu:
                    continue
                if weights[p] + graph.vertex_w[u] > max_part:
                    continue
                gain = conn[p] - internal
                # Also allow zero-gain moves that improve balance.
                improves_balance = (
                    gain == 0.0
                    and weights[lu] - graph.vertex_w[u] > weights[p]
                    and weights[lu] > total / nparts
                )
                if gain > best_gain or (improves_balance and best_p < 0):
                    best_p, best_gain = p, gain
            if best_p >= 0:
                weights[lu] -= graph.vertex_w[u]
                weights[best_p] += graph.vertex_w[u]
                labels[u] = best_p
                moved += 1
        if moved == 0:
            break
    return labels


def _rebalance(
    graph: Graph, labels: np.ndarray, nparts: int, balance_tol: float
) -> np.ndarray:
    """Force part weights under the cap by evicting smallest-loss vertices."""
    labels = labels.copy()
    total = graph.vertex_w.sum()
    max_part = (total / nparts) * (1.0 + balance_tol)
    weights = part_weights(graph, labels, nparts)
    adj = graph.adjacency()
    for p in range(nparts):
        guard = 0
        while weights[p] > max_part and guard < graph.num_vertices:
            guard += 1
            members = np.where(labels == p)[0]
            if len(members) <= 1:
                break
            # Evict the member with least internal connectivity.
            best_u, best_cost = -1, np.inf
            for u in members:
                cost = sum(w for v, w in adj[u].items() if labels[v] == p)
                if cost < best_cost:
                    best_u, best_cost = int(u), cost
            q = int(np.argmin(weights))
            if q == p:
                break
            weights[p] -= graph.vertex_w[best_u]
            weights[q] += graph.vertex_w[best_u]
            labels[best_u] = q
    return labels


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def partition_graph(
    graph: Graph,
    nparts: int,
    *,
    balance_tol: float = 0.10,
    seed: int = 0,
    coarsen_to: int = 64,
) -> np.ndarray:
    """Partition ``graph`` into ``nparts`` balanced parts minimizing edge cut.

    Returns an int label array of shape (num_vertices,).
    """
    if nparts <= 0:
        raise ValueError("nparts must be positive")
    if nparts == 1:
        return np.zeros(graph.num_vertices, dtype=np.int64)
    if nparts >= graph.num_vertices:
        return np.arange(graph.num_vertices, dtype=np.int64) % nparts

    rng = np.random.default_rng(seed)

    # Multilevel V-cycle.
    levels: list[tuple[Graph, np.ndarray]] = []  # (finer graph, fine->coarse)
    g = graph
    while g.num_vertices > max(coarsen_to, 2 * nparts):
        match = _heavy_edge_matching(g, rng)
        coarse, cmap = _coarsen(g, match)
        if coarse.num_vertices >= g.num_vertices:  # matching stalled
            break
        levels.append((g, cmap))
        g = coarse

    labels = _greedy_grow(g, nparts, rng)
    labels = _fm_refine(g, labels, nparts, balance_tol=balance_tol)

    for finer, cmap in reversed(levels):
        labels = labels[cmap]
        labels = _fm_refine(finer, labels, nparts, balance_tol=balance_tol)

    labels = _rebalance(graph, labels, nparts, balance_tol)
    return labels


def graph_from_dense(weights: np.ndarray, vertex_w: np.ndarray) -> Graph:
    """Build a Graph from a dense symmetric (or to-be-symmetrized) matrix."""
    w = np.asarray(weights, dtype=np.float64)
    w = w + w.T  # symmetrize; diagonal ignored below
    iu, iv = np.triu_indices(w.shape[0], k=1)
    mask = w[iu, iv] > 0
    return Graph(
        num_vertices=w.shape[0],
        edge_u=iu[mask],
        edge_v=iv[mask],
        edge_w=w[iu, iv][mask],
        vertex_w=np.asarray(vertex_w, dtype=np.float64),
    )
