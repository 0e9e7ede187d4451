"""COLA [21] — balanced graph partitioning scheduler (paper §2.1, §5.3–5.4).

COLA optimizes load balance *and* cross-node communication by partitioning the
operator (here: key-group) graph into |A| balanced parts with minimum weighted
edge cut: it starts from one partition and keeps splitting until the load
balance constraint is met.  It is a *static* optimizer: invoked at runtime it
re-partitions from scratch, so the resulting allocation is near-optimal in
collocation but pays massive migrations (paper Fig. 12: ~200 key groups per
period vs ALBIC's 10) — which is precisely the behaviour the comparison needs.

Part→node mapping greedily maximizes overlap with the current allocation (the
most charitable choice for COLA; anything else would inflate its migration
count further).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.milp import AllocationPlan
from repro_torch.core.stats import ClusterState
from repro_torch.solver.graphpart import Graph, partition_graph


def cola_allocate(
    state: ClusterState,
    *,
    balance_tol: float = 0.10,
    seed: int = 0,
) -> AllocationPlan:
    live = state.nodes_a
    nparts = len(live)
    g = state.num_keygroups

    eu, ev, ew = state.out_pairs.symmetric_edges()
    graph = Graph(
        num_vertices=g,
        edge_u=eu,
        edge_v=ev,
        edge_w=ew,
        vertex_w=np.maximum(state.kg_load, 1e-9),
    )
    labels = partition_graph(graph, nparts, balance_tol=balance_tol, seed=seed)

    # Greedy max-overlap part→node mapping (minimizes COLA's migrations).
    overlap = np.zeros((nparts, nparts))  # parts × live nodes
    node_pos = {int(nd): j for j, nd in enumerate(live)}
    for k in range(g):
        cur = int(state.alloc[k])
        if cur in node_pos:
            overlap[labels[k], node_pos[cur]] += state.kg_load[k]
    part_to_node = -np.ones(nparts, dtype=np.int64)
    taken = np.zeros(nparts, dtype=bool)
    flat_order = np.argsort(-overlap, axis=None)
    order = np.dstack(np.unravel_index(flat_order, overlap.shape))[0]
    for p, j in order:
        if part_to_node[p] < 0 and not taken[j]:
            part_to_node[p] = live[j]
            taken[j] = True
    for p in range(nparts):  # any leftovers
        if part_to_node[p] < 0:
            part_to_node[p] = live[int(np.argmin(taken))]
            taken[int(np.argmin(taken))] = True

    alloc = part_to_node[labels]
    moved = np.where(alloc != state.alloc)[0]
    mc = state.migration_costs()
    return AllocationPlan(
        alloc=alloc,
        d=float("nan"),
        d_u=0.0,
        d_l=0.0,
        objective=float("nan"),
        status="heuristic",
        solve_seconds=0.0,
        load_distance=state.load_distance(alloc),
        migrations=[(int(k), int(state.alloc[k]), int(alloc[k])) for k in moved],
        migration_cost=float(mc[moved].sum()),
    )
