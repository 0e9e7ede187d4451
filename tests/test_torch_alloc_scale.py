"""The allocator's scale levers (``repro_torch.core.milp``): movable units
and the time limit charged with the build, forced at small sizes by
setting ``SCALE_BINARIES`` to 0; the program below the threshold against the paper's
dense Table-2 program built here; and the solve counters ALBIC and the
framework carry."""

import importlib
import math
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import AdaptationFramework, AlbicParams  # noqa: E402
from repro_torch.core.stats import ClusterState  # noqa: E402
from repro_torch.solver.lp import MilpResult, dense_rows  # noqa: E402

milp = importlib.import_module("repro_torch.core.milp")
albic_mod = importlib.import_module("repro_torch.core.albic")
lp = importlib.import_module("repro_torch.solver.lp")


@pytest.fixture
def forced(monkeypatch):
    """The scale path engaged at any size."""
    monkeypatch.setattr(milp, "SCALE_BINARIES", 0)


@pytest.fixture
def small_bound(forced, monkeypatch):
    """The scale path forced, its bound cut to 60 binaries, for instances
    of tens."""
    monkeypatch.setattr(milp, "MOVABLE_BINARIES", 60)


def cluster(seed: int, nodes: int = 6, kgs: int = 72, ops: int = 3) -> ClusterState:
    """Skewed loads over ``ops`` operators, a quarter of the key groups on
    node 0, one-to-one pairs between neighbouring operators (so ALBIC
    scores pairs to collocate)."""
    rng = np.random.default_rng(seed)
    per = kgs // ops
    alloc = rng.integers(0, nodes, kgs)
    alloc[: kgs // 4] = 0
    out = np.zeros((kgs, kgs))
    for op in range(ops - 1):
        for i in range(per // 2):
            out[op * per + i, (op + 1) * per + i] = rng.uniform(5, 15)
    return ClusterState.create(
        nodes, np.repeat(np.arange(ops), per), rng.uniform(0.5, 2.0, kgs), alloc,
        kg_state_bytes=rng.uniform(1, 10, kgs), out_rates=out,
        downstream={op: [op + 1] for op in range(ops - 1)} | {ops - 1: []})


def recomputed(state: ClusterState, alloc: np.ndarray) -> tuple[float, int, float]:
    """(load distance, migrations, migration cost) of ``alloc``, in NumPy;
    the mean is the snapshot's (the live nodes' load before the plan)."""

    def loads(where):
        return np.bincount(where, weights=state.kg_load, minlength=state.num_nodes) / \
            state.capacity

    a = state.alive & ~state.kill
    mean = math.ceil(loads(state.alloc)[state.alive].sum() / a.sum())
    moved = alloc != state.alloc
    return (float(np.abs(loads(alloc)[a] - mean).max()), int(moved.sum()),
            float(state.kg_state_bytes[moved].sum()))


CASES = {
    "singletons": dict(),
    "units and pins": dict(units=[[0, 1], [30, 31, 32], [50]], pins={1: 3, 2: 3}),
    "a node marked": dict(kill=4),
    "a dead node": dict(dead=5),
}


def case_state(seed: int, case: dict) -> ClusterState:
    state = cluster(seed)
    if "kill" in case:
        state.kill[case["kill"]] = True
    if "dead" in case:
        node = case["dead"]
        state.alive[node] = False
        state.kg_state_bytes[state.alloc == node] = 0.0
    return state


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_forced_scale_path_plans_feasibly(small_bound, seed, case):
    """One live node per unit, members together, the budget held, the pins
    honoured; the reported numbers are those of ``alloc``; no worse than
    staying put."""
    spec = CASES[case]
    state = case_state(seed, spec)
    units = spec.get("units")
    # Ten migrations, and every orphan of a dead node besides.
    budget = 10 + int(state.kg_state_bytes[state.alloc == spec.get("dead", -1)].size)
    plan = milp.solve_allocation(state, max_migrations=budget, units=units,
                                 pins=spec.get("pins"), time_limit=3.0)
    assert plan.incumbent and plan.status in ("optimal", "time_limit")
    nu = state.num_keygroups - sum(len(u) - 1 for u in units or [])
    live = int(state.alive.sum())
    assert plan.movable_units < nu and plan.binaries < nu * live
    alloc = plan.alloc
    assert alloc.shape == state.alloc.shape and state.alive[alloc].all()
    for u in units or []:
        assert len(set(alloc[u])) == 1, u
    for u, node in (spec.get("pins") or {}).items():
        assert (alloc[units[u]] == node).all()
    if "dead" in spec:
        assert not (alloc == spec["dead"]).any()
    ld, moves, cost = recomputed(state, alloc)
    assert moves <= budget
    assert plan.load_distance == pytest.approx(ld, abs=1e-9)
    assert (plan.num_migrations, plan.migration_cost) == (moves, pytest.approx(cost))
    assert sorted(plan.migrations) == [(int(k), int(state.alloc[k]), int(alloc[k]))
                                        for k in np.nonzero(alloc != state.alloc)[0]]
    if "dead" not in spec and "pins" not in spec:
        assert plan.load_distance <= state.load_distance() + 1e-9


def planted(hot_nodes: int) -> ClusterState:
    """Six nodes of ten unit-load key groups; each of the first
    ``hot_nodes`` also holds two key groups of load 5, and 20 of 0.05
    among the light ones.  With a budget of two migrations a hot node the
    optimum moves the heavy key groups: the units the scale path keeps."""
    nodes = 6
    load, alloc = [], []
    for i in range(nodes):
        load += [1.0] * 10
        alloc += [i] * 10
        if i < hot_nodes:
            load += [5.0, 5.0] + [0.05] * 20
            alloc += [i] * 22
    return ClusterState.create(nodes, np.zeros(len(load), dtype=np.int64), np.array(load),
                               np.array(alloc))


@pytest.mark.parametrize("hot_nodes", [1, 2])
def test_pruned_optimum_equals_the_dense_one(monkeypatch, hot_nodes):
    state = planted(hot_nodes)
    budget = 2 * hot_nodes
    dense = milp.solve_allocation(state, max_migrations=budget, time_limit=30.0)
    monkeypatch.setattr(milp, "MOVABLE_BINARIES", 8 * hot_nodes * 7)
    monkeypatch.setattr(milp, "SCALE_BINARIES", 0)
    pruned = milp.solve_allocation(state, max_migrations=budget, time_limit=30.0)
    assert dense.status == pruned.status == "optimal"
    assert pruned.movable_units < dense.movable_units == state.num_keygroups
    assert pruned.d == pytest.approx(dense.d, abs=1e-6)  # HiGHS's feasibility tolerance
    # Both stop within HiGHS's relative gap (1e-4) of the same optimum.
    assert pruned.objective == pytest.approx(dense.objective, rel=2e-4)
    assert pruned.load_distance < state.load_distance()


def test_solve_returns_inside_its_limit(forced):
    """Build and solve inside ``time_limit`` plus 0.5 s (HiGHS checks its
    clock between steps, and a test host is shared)."""
    state = cluster(0, nodes=8, kgs=600)
    for limit in (0.3, 1.0):
        t0 = time.perf_counter()
        plan = milp.solve_allocation(state, max_migrations=10, time_limit=limit)
        wall = time.perf_counter() - t0
        assert wall <= limit + 0.5, (limit, wall)
        assert plan.build_seconds + plan.highs_seconds <= wall
        assert t0 <= plan.started <= t0 + plan.build_seconds


def test_build_time_is_charged_against_the_limit(monkeypatch):
    seen = []
    real = lp._sopt.milp

    def spy(**kw):
        seen.append(kw["options"]["time_limit"])
        return real(**kw)

    monkeypatch.setattr(lp._sopt, "milp", spy)
    state = cluster(1)
    plan = milp.solve_allocation(state, max_migrations=6, time_limit=5.0)
    assert plan.build_seconds > 0
    assert seen[-1] == pytest.approx(5.0 - plan.build_seconds, abs=1e-9)
    # A limit the build used up leaves HiGHS its least time.
    milp.solve_allocation(state, max_migrations=6, time_limit=1e-9)
    assert seen[-1] == lp.MIN_HIGHS_SECONDS


def table2(state, units, pins, max_migrations=None, max_migr_cost=None):
    """The paper's dense Table-2 program over live nodes, as (A, row bounds,
    c, variable bounds, integrality): d, d_u, d_l, then x[u, i] unit-major."""
    live = np.nonzero(state.alive)[0]
    loads = np.bincount(state.alloc, weights=state.kg_load, minlength=state.num_nodes)
    loads = loads / state.capacity
    a = state.alive & ~state.kill
    mean = math.ceil(float(loads[state.alive].sum()) / a.sum())
    nu, nl = len(units), len(live)

    def col(u, j):
        return 3 + u * nl + j

    nv = 3 + nu * nl
    c = np.zeros(nv)
    c[:3] = [milp.W1_DEFAULT, -milp.W2_DEFAULT, -milp.W2_DEFAULT]
    vlb, vub = np.zeros(nv), np.ones(nv)
    vub[:3] = [mean, np.inf, np.inf]
    for u, node in pins.items():
        for j, i in enumerate(live):
            vlb[col(u, j)] = vub[col(u, j)] = float(i == node)
    rows, lbs, ubs = [], [], []

    def row(entries, lb, ub):
        r = np.zeros(nv)
        for k, v in entries:
            r[k] = v
        rows.append(r)
        lbs.append(lb)
        ubs.append(ub)

    for u in range(nu):
        row([(col(u, j), 1.0) for j in range(nl)], 1.0, 1.0)
    if max_migrations is not None or max_migr_cost is not None:
        entries = []
        for u, members in enumerate(units):
            for j, i in enumerate(live):
                away = [k for k in members if state.alloc[k] != i]
                v = (float(len(away)) if max_migrations is not None
                     else sum(state.kg_state_bytes[k] for k in away))
                if v > 0:
                    entries.append((col(u, j), v))
        row(entries, -np.inf, float(max_migrations if max_migrations is not None
                                    else max_migr_cost))
    unit_load = [sum(state.kg_load[k] for k in members) for members in units]
    for j, i in enumerate(live):
        row([(col(u, j), unit_load[u] / state.capacity[i]) for u in range(nu)]
            + [(0, -1.0), (1, 1.0)], -np.inf, float(mean))
    for j, i in enumerate(live):
        if not state.kill[i]:
            row([(col(u, j), unit_load[u] / state.capacity[i]) for u in range(nu)]
                + [(0, 1.0), (2, -1.0)], float(mean), np.inf)
    integrality = np.r_[[0, 0, 0], np.ones(nu * nl)]
    return np.array(rows), np.array(lbs), np.array(ubs), c, vlb, vub, integrality


def captured(monkeypatch):
    """Every problem handed to the solver; the solver itself not run."""
    problems = []

    def capture(problem, **kw):
        problems.append(problem)
        return MilpResult(x=np.zeros(problem.num_vars), objective=float("inf"),
                          status="infeasible", solve_seconds=0.0)

    monkeypatch.setattr(milp, "solve_milp", capture)
    return problems


@pytest.mark.parametrize("case", [
    dict(max_migrations=5),
    dict(units=[[0, 1], [30, 31, 32]], pins={0: 2, 1: 2}, max_migr_cost=40.0),
    dict(kill=4, max_migrations=3),
])
def test_below_the_threshold_the_program_is_the_papers(monkeypatch, case):
    case = dict(case)
    state = cluster(3)
    if "kill" in case:
        state.kill[case.pop("kill")] = True
    units = case.get("units") or []
    covered = {k for u in units for k in u}
    expanded = [list(u) for u in units] + [
        [k] for k in range(state.num_keygroups) if k not in covered]
    problems = captured(monkeypatch)
    milp.solve_allocation(state, **case)
    (p,) = problems
    a, lb, ub, c, vlb, vub, integ = table2(state, expanded, case.get("pins") or {},
                                          case.get("max_migrations"), case.get("max_migr_cost"))
    assert np.array_equal(dense_rows(p), a)
    assert np.array_equal(p.row_lb, lb) and np.array_equal(p.row_ub, ub)
    assert np.array_equal(p.c, c)
    assert np.array_equal(p.var_lb, vlb) and np.array_equal(p.var_ub, vub)
    assert np.array_equal(p.integrality, integ)


def test_threshold_is_the_dense_count(monkeypatch):
    """1,250 units on 16 nodes (20,000 dense binaries) keep the dense
    program; 1,251 engage both levers."""
    assert milp.SCALE_BINARIES == 20_000
    problems = captured(monkeypatch)
    plans = []
    for kgs in (1250, 1251):
        rng = np.random.default_rng(kgs)
        state = ClusterState.create(16, np.zeros(kgs, dtype=np.int64),
                                    rng.uniform(0.5, 2.0, kgs), rng.integers(0, 16, kgs))
        plans.append(milp.solve_allocation(state, max_migrations=10))
    below, above = plans
    assert below.binaries == 20_000 and below.movable_units == 1250
    assert problems[0].num_vars == 3 + 20_000
    assert above.movable_units < 1251
    assert above.binaries <= milp.MOVABLE_BINARIES
    assert not below.incumbent and below.status == "infeasible"


def test_albic_and_the_framework_carry_every_solve(monkeypatch):
    """maxLD 0 walks ALBIC through every back-off (maxPL 25, 20, ..., 0):
    six solves, each in ``solves`` in order, the last the plan."""
    calls = []
    real = albic_mod.solve_allocation

    def counting(state, **kw):
        plan = real(state, **kw)
        calls.append(plan)
        return plan

    monkeypatch.setattr(albic_mod, "solve_allocation", counting)
    state = cluster(4)
    params = AlbicParams(max_ld=0.0, time_limit=5.0)
    res = albic_mod.albic(state, max_migrations=6, params=params)
    assert res.retries == 5 and len(calls) == 6
    assert res.solves == calls and res.plan is calls[-1]
    calls.clear()
    out = AdaptationFramework(mode="albic", max_migrations=6, albic_params=params).adapt(state)
    assert out.solves == calls and len(calls) == 6 and out.plan is calls[-1]
    assert all(p.binaries == p.movable_units * 6 for p in out.solves)


def hot_pair(seed: int, loads: tuple[float, float]) -> ClusterState:
    """A small ``cluster(seed)`` with one pair made the hottest: key group 1
    of the first operator and key group 13 of the second, on nodes 1 and 2,
    of ``loads``, with the largest rate between them."""
    state = cluster(seed, nodes=4, kgs=36)
    state.alloc[[1, 13]] = [1, 2]
    state.kg_load[[1, 13]] = loads
    out = state.out_rates.copy()
    out[1, 13] = 100.0
    return ClusterState.create(
        state.num_nodes, state.kg_operator, state.kg_load, state.alloc,
        kg_state_bytes=state.kg_state_bytes, out_rates=out, downstream=state.downstream)


def albic_both_ways(monkeypatch, state, budget, max_ld):
    """ALBIC as it runs, and with every back-off built and solved; the
    bound's verdicts on the first."""
    verdicts = []
    real = albic_mod._pin_breaks_max_ld

    def spy(*args, **kw):
        verdicts.append(real(*args, **kw))
        return verdicts[-1]

    params = AlbicParams(max_ld=max_ld, time_limit=5.0)
    monkeypatch.setattr(albic_mod, "_pin_breaks_max_ld", spy)
    fast = albic_mod.albic(state, params=params, **budget)
    monkeypatch.setattr(albic_mod, "_pin_breaks_max_ld", lambda *a, **k: False)
    full = albic_mod.albic(state, params=params, **budget)
    monkeypatch.setattr(albic_mod, "_pin_breaks_max_ld", real)
    return fast, full, verdicts


BUDGETS = [dict(max_migrations=3), dict(max_migr_cost=12.0)]


@pytest.mark.parametrize("scale", ["dense", "scale path"])
@pytest.mark.parametrize("budget", range(len(BUDGETS)))
def test_back_offs_skipped_only_where_each_would_fail(monkeypatch, scale, budget):
    """Where the hottest pair alone breaks maxLD on either of its nodes,
    every back-off the full walk takes is infeasible or breaks maxLD, and
    ALBIC returns the same result with one solve; the bound fires on some
    of these instances and not on others."""
    if scale == "scale path":
        monkeypatch.setattr(milp, "SCALE_BINARIES", 0)
    max_ld = 5.0
    fired = held = 0
    for seed in range(4):
        for loads in ((2.0, 2.0), (8.0, 8.0), (14.0, 14.0), (0.5, 20.0), (0.5, 32.0)):
            state = hot_pair(seed, loads)
            fast, full, verdicts = albic_both_ways(monkeypatch, state, BUDGETS[budget],
                                                   max_ld)
            assert fast.plan.status == full.plan.status != "time_limit"
            assert np.array_equal(fast.plan.alloc, full.plan.alloc)
            assert (fast.retries, fast.units, fast.pinned_pair) == \
                (full.retries, full.units, full.pinned_pair)
            assert (fast.col_grps, fast.to_be_col) == (full.col_grps, full.to_be_col)
            if verdicts and all(verdicts):
                fired += 1
                assert all(p.status == "infeasible" or p.load_distance > max_ld
                           for p in full.solves[:-1])
                assert fast.solves == [fast.plan] and full.retries == 5
            else:
                held += 1
                assert len(fast.solves) == len(full.solves)
    assert fired and held, (fired, held)


def test_a_pair_that_fits_keeps_the_back_offs(monkeypatch):
    """A light hottest pair: the back-offs run as the paper has them, and
    one that meets maxLD ends the walk."""
    state = hot_pair(0, (1.0, 1.0))
    fast, full, verdicts = albic_both_ways(monkeypatch, state, dict(max_migrations=6), 10.0)
    assert verdicts == [False]
    assert len(fast.solves) == len(full.solves) == fast.retries + 1
    assert np.array_equal(fast.plan.alloc, full.plan.alloc)


def score_row_by_row(state, score_factor):
    """Algorithm 2 lines 2–12 one source key group at a time."""
    col, tobe = [], []
    indptr, dsts, rates = state.out_pairs.rows_csr()
    kg_op = state.kg_operator
    sizes = np.bincount(kg_op)
    for op, downs in state.downstream.items():
        n_down = int(sizes[downs].sum()) if downs else 0
        if n_down == 0:
            continue
        for gk in np.nonzero(kg_op == op)[0]:
            d = dsts[indptr[gk]:indptr[gk + 1]]
            r = rates[indptr[gk]:indptr[gk + 1]]
            m = np.isin(kg_op[d], downs)
            total = float(r[m].sum())
            if total <= 0:
                continue
            for gj, rate in zip(d[m], r[m]):
                if rate > total / n_down * score_factor:
                    pair = (int(gk), int(gj))
                    if state.alloc[gk] == state.alloc[gj]:
                        col.append(pair)
                    else:
                        tobe.append((*pair, float(rate)))
    return col, tobe


@pytest.mark.parametrize("seed", range(3))
def test_pair_scores_equal_one_row_at_a_time(seed):
    rng = np.random.default_rng(seed)
    for trial in range(20):
        kgs, nodes = int(rng.integers(3, 90)), int(rng.integers(1, 7))
        ops = int(rng.integers(1, 4))
        kg_op = np.sort(rng.integers(0, ops, kgs))
        out = np.zeros((kgs, kgs))
        nnz = int(rng.integers(0, 4 * kgs))
        out[rng.integers(0, kgs, nnz), rng.integers(0, kgs, nnz)] = (
            rng.choice([1.0, 2.0], nnz) if trial % 2 else rng.uniform(0.1, 9, nnz))
        state = ClusterState.create(
            nodes, kg_op, rng.uniform(0.5, 2, kgs), rng.integers(0, nodes, kgs),
            out_rates=out, downstream={op: [op + 1] if op + 1 < ops else [] for op in range(ops)})
        col, tobe, rates = albic_mod._score_pairs(state, 1.5)
        want_col, want_tobe = score_row_by_row(state, 1.5)
        assert col == want_col
        assert [(a, b, r) for (a, b), r in zip(tobe, rates.tolist())] == want_tobe
