"""The paper's Mixed-Integer Linear Program (§4.3.1, Table 2).

    min  w1·d − w2·(d_u + d_l)
    s.t. (1) ∀ g_k:  Σ_i x[i,k] = 1
         (2) Σ_{i,k} (1 − q[i,k]) · x[i,k] · mc_k  ≤  maxMigrCost
         (3) ∀ n_i ∈ N:            Σ_k x[i,k]·gLoad_k ≤ mean + (d − d_u)
         (4) ∀ n_i ∈ N, kill_i=0:  Σ_k x[i,k]·gLoad_k ≥ mean − (d − d_l)
         (5) mean − d ≥ 0

with w1 ≫ w2 so d is minimized first and d_u + d_l maximized second.

Generalizations carried from the paper text:

* **Migration units** — ALBIC migrates collocated partitions as indivisible
  units, so the program is built over *units* (sets of key groups); the pure
  MILP is the special case of singleton units.
* **Heterogeneity** — gLoad coefficients are divided by the node capacity
  (paper §3 / "Extending to Heterogeneous Nodes").
* **Pin constraints** — ALBIC step 3 pins a unit to a node; implemented by
  fixing the corresponding binary's bounds.
* **maxMigrations mode** — for the Flux comparison (§5.2.1) the budget counts
  migrated key groups instead of migration cost.
* **Multi-dimensional load** — optional extra per-resource capacity rows
  ("Extending to Multi-Dimensional Load").
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.stats import ClusterState
from repro_torch.solver.lp import MilpBuilder, solve_milp

# w1 >> w2 per the paper's objective discussion.
W1_DEFAULT = 1000.0
W2_DEFAULT = 1.0

# Dense binaries (units x live nodes) above which the scale levers engage.
SCALE_BINARIES = 20_000
# Binaries the movable units may take once they do: at 4,000 units on 16
# nodes about 66 units, enough for a budget of 10 migrations (a bound of
# 2,000 reached the same d, but ran into a 1.5-second limit in about a
# sixth of the periods).
MOVABLE_BINARIES = 600


@dataclasses.dataclass
class AllocationPlan:
    """Result of one key-group-allocation solve."""

    alloc: np.ndarray  # (G,) node per key group
    d: float
    d_u: float
    d_l: float
    objective: float
    status: str
    solve_seconds: float
    load_distance: float
    migrations: list[tuple[int, int, int]]  # (kg, src_node, dst_node)
    migration_cost: float
    # What the solve cost: its assignment binaries, the units given them,
    # perf_counter seconds at its start, building (the program and the
    # solver's matrix) and in HiGHS, and whether HiGHS returned a point.
    binaries: int = 0
    movable_units: int = 0
    started: float = 0.0
    build_seconds: float = 0.0
    highs_seconds: float = 0.0
    incumbent: bool = False

    @property
    def num_migrations(self) -> int:
        return len(self.migrations)


def _pad_units(
    unit_list: list[np.ndarray],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad ragged units to a (nu, max_size) member matrix.

    Returns (members, valid, sizes): ``members`` holds key-group ids (0-padded),
    ``valid`` masks real entries, ``sizes`` is the per-unit member count.  Lets
    per-unit reductions (loads, migration costs) run as one masked sum.
    """
    nu = len(unit_list)
    sizes = np.fromiter((len(m) for m in unit_list), dtype=np.int64, count=nu)
    maxm = int(sizes.max()) if nu else 1
    members = np.zeros((nu, maxm), dtype=np.int64)
    valid = np.arange(maxm)[None, :] < sizes[:, None]
    members[valid] = np.concatenate(unit_list) if nu else []
    return members, valid, sizes


def _units_or_singletons(
    num_keygroups: int, units: Optional[Sequence[Sequence[int]]]
) -> list[np.ndarray]:
    if units is None:
        return [np.array([k]) for k in range(num_keygroups)]
    covered = np.zeros(num_keygroups, dtype=bool)
    out: list[np.ndarray] = []
    for u in units:
        arr = np.asarray(list(u), dtype=np.int64)
        if covered[arr].any():
            raise ValueError("units overlap")
        covered[arr] = True
        out.append(arr)
    for k in np.where(~covered)[0]:
        out.append(np.array([k]))
    return out


def _movable_units(
    unit_load: np.ndarray,
    homes: np.ndarray,
    node_loads: np.ndarray,
    mean: float,
    state: ClusterState,
    pins: dict[int, int],
    limit: int,
) -> np.ndarray:
    """The units that keep binaries at scale, as a (nu,) mask.

    Always: pinned units, and units without one live home (members on
    several nodes, or on a dead one).  Then ``limit`` more, dealt round
    robin over the nodes marked for removal and the live nodes above the
    mean, those first and then from the most loaded down, each node's
    heaviest unit first.
    """
    homed = homes >= 0
    must = ~homed
    must[list(pins)] = True
    cand = np.nonzero(homed & ~must)[0]
    src = homes[cand]
    keep = state.kill[src] | (node_loads[src] > mean)
    cand, src = cand[keep], src[keep]
    if not len(cand):
        return must
    # Rank the source nodes (marked first, then by load), sort the units by
    # (node rank, unit load descending); a unit's rank inside its node then
    # orders the deal, ties by node rank.
    node_rank = np.argsort(np.lexsort((-node_loads, ~state.kill)))
    order = np.lexsort((-unit_load[cand], node_rank[src]))
    cand, nodes = cand[order], node_rank[src[order]]
    first = np.r_[0, np.nonzero(np.diff(nodes))[0] + 1]
    rank = np.arange(len(cand)) - np.repeat(first, np.diff(np.r_[first, len(cand)]))
    movable = must.copy()
    movable[cand[np.lexsort((nodes, rank))][:limit]] = True
    return movable


def solve_allocation(
    state: ClusterState,
    *,
    max_migr_cost: Optional[float] = None,
    max_migrations: Optional[int] = None,
    units: Optional[Sequence[Sequence[int]]] = None,
    pins: Optional[dict[int, int]] = None,
    alpha: float = 1.0,
    w1: float = W1_DEFAULT,
    w2: float = W2_DEFAULT,
    time_limit: float = 10.0,
    extra_resources: Optional[dict[str, tuple[np.ndarray, np.ndarray]]] = None,
    candidate_limit: Optional[int] = None,
    prev_rate: Optional[np.ndarray] = None,
) -> AllocationPlan:
    """Build and solve the Table-2 MILP; return the new allocation plan.

    Args:
      state: current cluster snapshot (q, gLoad, kill, capacities).
      prev_rate: previous period's per-key-group arrival rates.  When given
        (and the snapshot carries ``kg_tuple_rate``), the gLoad vector the
        balance objective optimizes is *projected one period ahead* by the
        clipped rate-growth ratios (``repro_torch.core.scaling.rate_growth``) —
        a key group whose arrivals are surging weighs as the load it is
        about to impose, so the solver rebalances one period before the
        measured loads would force it.  The reported ``load_distance`` stays
        measured (it scores the plan against today's loads).
      max_migr_cost: budget on Σ mc_k of migrated key groups (paper default).
      max_migrations: alternative budget on the *count* of migrated key
        groups (used for the Flux comparison, §5.2.1).  Exactly one of the two
        budgets may be set; with neither, rebalancing is unrestricted (§5.2.2).
      units: indivisible sets of key groups (ALBIC partitions).  Key groups
        not covered become singleton units.
      pins: {unit_index_in_`units`: node} collocation constraints (ALBIC
        step 3).  Indexes into the *expanded* unit list returned by
        `_units_or_singletons`, i.e. the order of `units` first.
      alpha: state-size → migration-cost constant (mc_k = α·|σ_k|).
      extra_resources: optional {name: (kg_usage (G,), node_cap (N,))} rows.
      candidate_limit: beyond-paper scalability lever — restrict each unit's
        binaries to {current node} ∪ pins ∪ the k least-loaded A-nodes.  The
        paper's CPLEX solved the dense 72k-binary instances; HiGHS needs the
        pruning to hit the same few-second solve times at 60×1200 scale.
        Auto-enabled (k = 8) above ``SCALE_BINARIES`` dense binaries
        (units × live nodes), together with movable units, a beyond-paper
        lever, its counterpart for units. Only a bounded set of
        units keeps binaries: the pinned ones, those without one live home
        (split over nodes, or on a dead node), then the heaviest units of the
        nodes marked for removal and of the live nodes above the mean, dealt
        round robin over those nodes (marked first, then from the most loaded
        down) until their binaries reach about ``MOVABLE_BINARIES``. Every
        other unit stays home: its load is a constant on the right-hand sides
        of rows (3)/(4), which then cover every live node. A budget of a few
        migrations moves a few units, and those that lower d sit on the nodes
        above the mean. At 4,000 units on 16 nodes (≈ 34,000 binaries after
        ``candidate_limit``) HiGHS 1.12's presolve alone outlasts a 1.5-second
        limit and returns no point; the pruned program (≈ 600) proves its
        optimum well inside it. Below the threshold the program is the
        paper's.

    The time spent building the program counts against ``time_limit``:
    HiGHS gets what is left.
    """
    if max_migr_cost is not None and max_migrations is not None:
        raise ValueError("set at most one of max_migr_cost / max_migrations")

    started = time.perf_counter()
    n, g = state.num_nodes, state.num_keygroups
    unit_list = _units_or_singletons(g, units)
    nu = len(unit_list)
    mc = state.migration_costs(alpha)
    # Effective gLoad: measured, or rate-projected when the leading signal
    # is available — the projection only ever raises loads, so it can move
    # a surge early but never hides one.
    kg_load = state.kg_load
    if prev_rate is not None:
        from repro_torch.core.scaling import rate_growth

        growth = rate_growth(state, prev_rate)
        if growth is not None:
            kg_load = kg_load * growth
    node_loads = (
        np.bincount(state.alloc, weights=kg_load, minlength=n) / state.capacity
    )
    a_live = np.where(state.alive & ~state.kill)[0]
    mean = (
        math.ceil(float(node_loads[state.alive].sum()) / len(a_live))
        if len(a_live)
        else 0.0
    )
    live = state.alive  # dead nodes take no variables at all
    pins = pins or {}

    scaled = nu * int(live.sum()) > SCALE_BINARIES
    if candidate_limit is None and scaled:
        candidate_limit = 8

    b = MilpBuilder()
    # Continuous deviation variables.  d ≤ mean encodes constraint (5).
    vd = b.add_var("d", obj=w1, lb=0.0, ub=max(mean, 0.0))
    vdu = b.add_var("d_u", obj=-w2, lb=0.0)
    vdl = b.add_var("d_l", obj=-w2, lb=0.0)

    members, valid, sizes = _pad_units(unit_list)
    mem_alloc = state.alloc[members]  # (nu, maxm); garbage where ~valid
    unit_load = (kg_load[members] * valid).sum(axis=1)
    first = mem_alloc[:, 0]
    homes = first  # a unit's one live node, -1 for none (at scale)
    movable = np.ones(nu, dtype=bool)
    if scaled:
        one_home = live[first] & ((mem_alloc == first[:, None]) | ~valid).all(axis=1)
        homes = np.where(one_home, first, -1)
        per_unit = min(candidate_limit, int(live.sum())) + 1
        movable = _movable_units(unit_load, homes, node_loads, mean, state, pins,
                                 max(MOVABLE_BINARIES // per_unit, 1))

    # Candidate mask (nu, n): which node each unit may be assigned to.  With
    # pruning: the k least-loaded A-nodes ∪ the unit's current homes ∪ pins.
    cand = np.zeros((nu, n), dtype=bool)
    live_nodes = np.where(live)[0]
    if candidate_limit is None:
        cand[:, live_nodes] = True
    else:
        loads = node_loads
        a_sorted = [i for i in np.argsort(loads) if live[i] and not state.kill[i]]
        cand[:, a_sorted[: max(candidate_limit, 1)]] = True
        home_ok = valid & live[mem_alloc]
        cand[np.nonzero(home_ok)[0], mem_alloc[home_ok]] = True
        for u, node in pins.items():
            cand[u, int(node)] = True
    cand[~movable] = False

    # Assignment binaries x[u, i] for every candidate pair, allocated as one
    # contiguous block and scattered into the (nu, n) variable map.
    u_idx, i_idx = np.nonzero(cand)
    nbin = len(u_idx)
    xstart = b.add_binaries(nbin)
    bin_ids = xstart + np.arange(nbin, dtype=np.int64)
    xvar = np.full((nu, n), -1, dtype=np.int64)
    xvar[u_idx, i_idx] = bin_ids

    for u, node in pins.items():
        if not live[node]:
            raise ValueError(f"pin to dead node {node}")
        for i in live_nodes:
            idx = int(xvar[u, i])
            if idx < 0:
                continue
            # Fix bounds: 1 on the pinned node, 0 elsewhere.
            fixed = 1.0 if i == node else 0.0
            b.set_var_bounds(idx, fixed, fixed)

    # (1) each movable unit on exactly one node — one block row per unit.
    urow = np.cumsum(movable) - 1
    b.add_rows(urow[u_idx], bin_ids, np.ones(nbin), num_rows=int(movable.sum()),
               lb=1.0, ub=1.0)

    # (2) migration budget.  Coefficient of x[u,i] is the cost of the members
    # of u that are not already on node i ((1−q)·mc summed over the unit).
    if max_migr_cost is not None or max_migrations is not None:
        moved = (mem_alloc[u_idx] != i_idx[:, None]) & valid[u_idx]
        if max_migrations is not None:
            cost = moved.sum(axis=1).astype(np.float64)
        else:
            cost = (mc[members][u_idx] * moved).sum(axis=1)
        budget = float(max_migrations if max_migrations is not None else max_migr_cost)
        nz = cost > 0
        if nz.any():
            b.add_row(bin_ids[nz], cost[nz], ub=budget)

    # (3)/(4) load bounds per node, assembled node-major from the candidate
    # mask transpose.  Heterogeneity: divide by capacity.  Nodes without any
    # candidate binary (pruned) cannot receive anything and need no bound,
    # unless units fixed at home load them: at scale every live node has its
    # rows, the fixed load moved to their right-hand sides.
    iT, uT = np.nonzero(cand.T)
    colsT = xvar[uT, iT]
    loadT = unit_load[uT] / state.capacity[iT]
    nodes3 = live_nodes if scaled else np.unique(iT)
    m3 = len(nodes3)
    fixed_units = np.nonzero(~movable)[0]

    def fixed_sum(usage: np.ndarray) -> np.ndarray:
        return np.bincount(homes[fixed_units], weights=usage[fixed_units], minlength=n)

    fixed_load = fixed_sum(unit_load) / state.capacity
    # (3): Σ load·x − d + d_u ≤ mean   (all live nodes, incl. B)
    b.add_rows(
        np.concatenate([np.searchsorted(nodes3, iT), np.arange(m3), np.arange(m3)]),
        np.concatenate([colsT, np.full(m3, vd), np.full(m3, vdu)]),
        np.concatenate([loadT, -np.ones(m3), np.ones(m3)]),
        num_rows=m3,
        ub=float(mean) - fixed_load[nodes3],
    )
    # (4): Σ load·x + d − d_l ≥ mean   (only nodes not marked for removal)
    keep = ~state.kill[iT]
    nodes4 = nodes3[~state.kill[nodes3]]
    m4 = len(nodes4)
    if m4:
        b.add_rows(
            np.concatenate(
                [np.searchsorted(nodes4, iT[keep]), np.arange(m4), np.arange(m4)]
            ),
            np.concatenate([colsT[keep], np.full(m4, vd), np.full(m4, vdl)]),
            np.concatenate([loadT[keep], np.ones(m4), -np.ones(m4)]),
            num_rows=m4,
            lb=float(mean) - fixed_load[nodes4],
        )

    # Multi-dimensional load extension: cap each extra resource per node.
    for _name, (usage, caps) in (extra_resources or {}).items():
        res_unit = (np.asarray(usage)[members] * valid).sum(axis=1)
        b.add_rows(
            np.searchsorted(nodes3, iT),
            colsT,
            res_unit[uT],
            num_rows=m3,
            ub=np.asarray(caps, dtype=np.float64)[nodes3] - fixed_sum(res_unit)[nodes3],
        )

    problem = b.build()
    # Warm start: keep every unit where its (first member) currently lives.
    warm = np.zeros(problem.num_vars)
    warm[0] = mean
    home_x = xvar[np.arange(nu), first]
    keep_home = live[first] & (home_x >= 0)
    warm[home_x[keep_home]] = 1.0
    built = time.perf_counter() - started
    result = solve_milp(problem, time_limit=time_limit - built, warm_start=warm)
    spent = dict(binaries=nbin, movable_units=int(movable.sum()), started=started,
                build_seconds=built + result.build_seconds,
                highs_seconds=result.solve_seconds, incumbent=result.incumbent)

    if not result.ok:
        # Infeasible (e.g. budget too tight for pins): fall back to identity.
        return AllocationPlan(
            alloc=state.alloc.copy(),
            d=float("nan"),
            d_u=0.0,
            d_l=0.0,
            objective=float("inf"),
            status=result.status,
            solve_seconds=result.solve_seconds,
            load_distance=state.load_distance(),
            migrations=[],
            migration_cost=0.0,
            **spent,
        )

    x = result.x
    alloc = state.alloc.copy()
    scores = np.full((nu, n), -1.0)
    scores[u_idx, i_idx] = x[bin_ids]
    best = np.where(movable, np.argmax(scores, axis=1), homes)
    alloc[members[valid]] = np.repeat(best, sizes)

    moved = np.where(alloc != state.alloc)[0]
    migrations = [(int(k), int(state.alloc[k]), int(alloc[k])) for k in moved]
    return AllocationPlan(
        alloc=alloc,
        d=float(x[vd]),
        d_u=float(x[vdu]),
        d_l=float(x[vdl]),
        objective=result.objective,
        status=result.status,
        solve_seconds=result.solve_seconds,
        load_distance=state.load_distance(alloc),
        migrations=migrations,
        migration_cost=float(mc[moved].sum()),
        **spent,
    )
