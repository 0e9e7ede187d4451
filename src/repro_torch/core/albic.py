"""ALBIC — Autonomic Load Balancing with Integrated Collocation (§4.3.2, Alg. 2).

ALBIC layers collocation on top of the MILP without making the program
quadratic:

  Step 1  score every communicating key-group pair: a pair (g_i, g_j)
          *contributes* when out(g_i, g_j) > avg(g_i) · sF.  Pairs already on
          the same node go to ``colGrps``; the rest to ``toBeColGrps``.
  Step 2  union existing collocated pairs into sets; split each set with
          balanced graph partitioning into migration *units* bounded by
          maxMigrCost (p1) and maxPL (p2).  Vertex weight is mc_i when the
          migration-cost ratio dominates, else gLoad_i; ties random.
  Step 3  pick one pair from toBeColGrps with maximal out(g_i, g_j) (random
          among ties) and pin it — and the partitions it touches — to a node
          per the three cases of the paper.  Node scoring for the target
          choice uses *rate-projected* loads when the caller supplies the
          previous period's ``kg_tuple_rate`` (mirroring the scalers'
          leading-load signal): a node whose key groups' arrivals are
          surging scores as already loaded, so migration targeting
          anticipates next period's load instead of only balancing the
          measured one.
  Step 4  solve the constrained MILP; if the achieved load distance exceeds
          maxLD, retry with maxPL reduced by stepPL (more, smaller units).
          At maxPL == 0 this degenerates to the pure MILP.  When step 3's
          pair alone breaks maxLD wherever it lands (``_pin_breaks_max_ld``),
          every back-off fails and is taken without a solve.

Defaults follow the paper: maxLD = 10, maxPL = 25, stepPL = 5, sF = 1.5.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.milp import AllocationPlan, solve_allocation
from repro_torch.core.scaling import projected_loads
from repro_torch.core.stats import ClusterState
from repro_torch.solver.graphpart import Graph, partition_graph


@dataclasses.dataclass
class AlbicParams:
    max_ld: float = 10.0  # maxLD — user-defined max load distance
    max_pl: float = 25.0  # maxPL — max partition load (initial)
    step_pl: float = 5.0  # stepPL
    score_factor: float = 1.5  # sF
    alpha: float = 1.0  # migration cost constant
    time_limit: float = 10.0
    seed: int = 0
    # Score step-3 target nodes on rate-projected loads (leading signal)
    # whenever the previous period's kg_tuple_rate is available.
    use_rate_signal: bool = True


@dataclasses.dataclass
class AlbicResult:
    plan: AllocationPlan
    units: list[list[int]]  # migration units (collocation partitions)
    pinned_pair: Optional[tuple[int, int]]
    retries: int  # number of maxPL back-offs taken
    col_grps: list[tuple[int, int]]  # realized collocated pairs (diagnostics)
    to_be_col: list[tuple[int, int]]  # candidate pairs not yet collocated
    # Every solve's plan in order, the back-offs' first; the last is ``plan``.
    solves: list[AllocationPlan] = dataclasses.field(default_factory=list)


def _score_pairs(
    state: ClusterState, score_factor: float
) -> tuple[list[tuple[int, int]], list[tuple[int, int]], np.ndarray]:
    """Algorithm 2 lines 2–12: (colGrps, toBeColGrps, toBeColGrps' rates).

    Walks the sparse pair triples (CSR rows) instead of dense (G, G) rows:
    a key group's candidate downstream partners are exactly its nonzero
    pairs, and the per-source average still divides by the *full* downstream
    key-group count (zero-rate partners dilute the average but can never be
    hot themselves).  An operator's rows are scored at once; each row's
    total is its own sum, as one row at a time would take it.  Pairs come
    in operator order, then by source key group, then in CSR order.
    """
    indptr, dsts, rates = state.out_pairs.rows_csr()
    kg_op = state.kg_operator
    op_sizes = np.bincount(kg_op, minlength=int(kg_op.max()) + 1 if len(kg_op) else 0)
    src_parts, dst_parts, rate_parts = [], [], []
    for op, downs in state.downstream.items():
        if not downs:
            continue
        n_down = int(op_sizes[downs].sum())
        if n_down == 0:
            continue
        op_kgs = np.where(kg_op == op)[0]
        if not len(op_kgs):
            continue
        lens = indptr[op_kgs + 1] - indptr[op_kgs]
        first = indptr[op_kgs] - np.cumsum(lens) + lens
        entry = np.repeat(first, lens) + np.arange(lens.sum())
        d, r = dsts[entry], rates[entry]
        m = np.isin(kg_op[d], np.asarray(downs))
        src, d, r = np.repeat(op_kgs, lens)[m], d[m], r[m]
        row = np.repeat(np.arange(len(op_kgs)), lens)[m]
        counts = np.bincount(row, minlength=len(op_kgs))
        segments = np.split(r, np.cumsum(counts)[:-1])
        totals = np.fromiter((seg.sum() for seg in segments), np.float64, len(op_kgs))
        row_total = np.repeat(totals, counts)
        sel = (row_total > 0) & (r > row_total / n_down * score_factor)
        src_parts.append(src[sel])
        dst_parts.append(d[sel])
        rate_parts.append(r[sel])
    empty = np.zeros(0, dtype=np.int64)
    src = np.concatenate(src_parts) if src_parts else empty
    dst = np.concatenate(dst_parts) if dst_parts else empty
    rate = np.concatenate(rate_parts) if rate_parts else np.zeros(0)
    same = state.alloc[src] == state.alloc[dst]
    col = list(zip(src[same].tolist(), dst[same].tolist()))
    tobe = list(zip(src[~same].tolist(), dst[~same].tolist()))
    return col, tobe, rate[~same]


def _pin_breaks_max_ld(
    state: ClusterState, pair: tuple[int, int], max_ld: float
) -> bool:
    """Whether every plan that honours step 3's pin of ``pair`` leaves a
    load distance above maxLD.

    The pin puts both key groups on one of their two nodes, whatever units
    step 2 builds, so that node's load is at least theirs.  When that alone
    lies more than maxLD above the mean on either node, each back-off's
    solve is infeasible or its plan breaks maxLD.
    """
    a = state.alive & ~state.kill
    pair_load = float(state.kg_load[list(pair)].sum())
    mean = state.mean_load()
    return all(
        a[n] and pair_load / state.capacity[n] - mean > max_ld * (1 + 1e-9) + 1e-9
        for n in {int(state.alloc[g]) for g in pair}
    )


def _union_sets(pairs: list[tuple[int, int]]) -> list[list[int]]:
    """Merge pairs into disjoint sets (union–find)."""
    parent: dict[int, int] = {}

    def find(x: int) -> int:
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    groups: dict[int, list[int]] = {}
    for x in parent:
        groups.setdefault(find(x), []).append(x)
    return [sorted(v) for v in groups.values() if len(v) > 1]


def _split_set(
    state: ClusterState,
    members: list[int],
    *,
    max_migr_cost: float,
    max_pl: float,
    alpha: float,
    rng: np.random.Generator,
) -> list[list[int]]:
    """Algorithm 2 lines 15–20: split one collocation set into partitions."""
    mc = state.migration_costs(alpha)
    set_mc = float(mc[members].sum())
    set_load = float(state.kg_load[members].sum())
    p1 = math.ceil(set_mc / max_migr_cost) if max_migr_cost > 0 else 1
    p2 = math.ceil(set_load / max_pl) if max_pl > 0 else len(members)
    nparts = max(p1, p2, 1)
    if nparts <= 1 or len(members) <= 1:
        return [list(members)]
    nparts = min(nparts, len(members))

    # Vertex weight: mc if the migration-cost ratio dominates, else gLoad.
    ratio_mc = set_mc / max_migr_cost if max_migr_cost > 0 else 0.0
    ratio_pl = set_load / max_pl if max_pl > 0 else float("inf")
    if ratio_mc > ratio_pl:
        vweights = mc[members]
    elif ratio_mc < ratio_pl:
        vweights = state.kg_load[members]
    else:  # tie broken randomly (paper)
        vweights = mc[members] if rng.random() < 0.5 else state.kg_load[members]

    idx = {g: i for i, g in enumerate(members)}
    index_map = np.full(state.num_keygroups, -1, dtype=np.int64)
    index_map[members] = np.arange(len(members))
    eu, ev, ew = state.out_pairs.symmetric_edges(index_map)
    graph = Graph(
        num_vertices=len(members),
        edge_u=eu,
        edge_v=ev,
        edge_w=ew,
        vertex_w=np.maximum(vweights, 1e-9),
    )
    labels = partition_graph(graph, nparts, seed=int(rng.integers(2**31)))

    parts: list[list[int]] = [[] for _ in range(nparts)]
    for g in members:
        parts[int(labels[idx[g]])].append(g)
    parts = [p for p in parts if p]

    # Re-split any partition still violating a constraint (paper: "may need
    # to be applied again").
    final: list[list[int]] = []
    for p in parts:
        pmc = float(mc[p].sum())
        pl = float(state.kg_load[p].sum())
        if len(p) > 1 and (
            (max_migr_cost > 0 and pmc > max_migr_cost) or (max_pl > 0 and pl > max_pl)
        ):
            final.extend(
                _split_set(
                    state,
                    p,
                    max_migr_cost=max_migr_cost,
                    max_pl=max_pl,
                    alpha=alpha,
                    rng=rng,
                )
            )
        else:
            final.append(p)
    return final


def albic(
    state: ClusterState,
    *,
    max_migr_cost: Optional[float] = None,
    max_migrations: Optional[int] = None,
    params: AlbicParams | None = None,
    prev_rate: Optional[np.ndarray] = None,
) -> AlbicResult:
    """One ALBIC invocation (Algorithm 2).

    ``prev_rate`` is the previous period's per-key-group arrival rates; when
    given (and ``params.use_rate_signal``), step 3 scores candidate target
    nodes on loads projected forward by rate growth, steering new
    collocations away from nodes that are merely *currently* balanced but
    about to absorb a surge.
    """
    params = params or AlbicParams()
    rng = np.random.default_rng(params.seed)
    budget = max_migr_cost if max_migr_cost is not None else float("inf")

    # Step 1 — calculate scores.
    col_pairs, tobe, tobe_rates = _score_pairs(state, params.score_factor)
    best = np.where(tobe_rates == tobe_rates.max())[0] if tobe else None

    # Leading-load node scores for step 3 (None → fall back to measured).
    proj_loads = (
        projected_loads(state, state.alloc, prev_rate)
        if params.use_rate_signal
        else None
    )

    max_pl = params.max_pl
    retries = 0
    solves: list[AllocationPlan] = []
    # Every back-off pins one of the pairs tied for the hottest.  If each of
    # them breaks maxLD wherever it lands, so does every back-off, and they
    # are taken without building or solving them (step 2's draws feed
    # nothing after them: at maxPL 0 no step runs).
    if (
        best is not None
        and max_pl > 0
        and params.step_pl > 0
        and all(_pin_breaks_max_ld(state, tobe[i], params.max_ld) for i in best)
    ):
        while max_pl > 0:
            max_pl = max(max_pl - params.step_pl, 0.0)
            retries += 1
    sets = _union_sets(col_pairs) if max_pl > 0 else []
    while True:
        # Step 2 — maintain collocation.
        units: list[list[int]] = []
        if max_pl > 0:
            for s in sets:
                units.extend(
                    _split_set(
                        state,
                        s,
                        max_migr_cost=budget if np.isfinite(budget) else 0.0,
                        max_pl=max_pl,
                        alpha=params.alpha,
                        rng=rng,
                    )
                )

        # Step 3 — improve collocation: one new pair, max out(), ties random.
        pins: dict[int, int] = {}
        pinned_pair: Optional[tuple[int, int]] = None
        if tobe and max_pl > 0:
            gi, gj = tobe[int(rng.choice(best))]
            pinned_pair = (gi, gj)
            n1, n2 = int(state.alloc[gi]), int(state.alloc[gj])
            loads = proj_loads if proj_loads is not None else state.node_loads()
            member_of = {g: u for u, p in enumerate(units) for g in p}
            ui, uj = member_of.get(gi), member_of.get(gj)
            if ui is None and uj is None:
                # Case 1: pin both key groups to the less-loaded node.
                target = n1 if loads[n1] <= loads[n2] else n2
                units.append([gi])
                units.append([gj])
                pins[len(units) - 2] = target
                pins[len(units) - 1] = target
            elif ui is not None and uj is None:
                # Case 2a: g_j joins g_i's node.
                units.append([gj])
                pins[ui] = n1
                pins[len(units) - 1] = n1
            elif ui is None and uj is not None:
                # Case 2b: g_i joins g_j's node.
                units.append([gi])
                pins[uj] = n2
                pins[len(units) - 1] = n2
            else:
                # Case 3: both partitions move to the less-loaded node.
                target = n1 if loads[n1] <= loads[n2] else n2
                pins[ui] = target
                if uj != ui:
                    pins[uj] = target

        # Step 4 — solve the constrained MILP.  The rate projection feeds
        # the balance objective itself here, not just step 3's target
        # scoring: a surging key group weighs as next period's load.
        plan = solve_allocation(
            state,
            max_migr_cost=max_migr_cost,
            max_migrations=max_migrations,
            units=units if units else None,
            pins=pins if pins else None,
            alpha=params.alpha,
            time_limit=params.time_limit,
            prev_rate=prev_rate if params.use_rate_signal else None,
        )
        solves.append(plan)
        ld_ok = plan.status != "infeasible" and plan.load_distance <= params.max_ld
        if ld_ok or max_pl <= 0:
            return AlbicResult(
                plan=plan,
                units=units,
                pinned_pair=pinned_pair,
                retries=retries,
                col_grps=col_pairs,
                to_be_col=tobe,
                solves=solves,
            )
        max_pl = max(max_pl - params.step_pl, 0.0)
        retries += 1
