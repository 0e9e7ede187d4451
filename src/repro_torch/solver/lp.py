"""Time-limited MILP solving.

The paper solves its Mixed-Integer Linear Program with CPLEX.  Here we expose
one neutral interface, :func:`solve_milp`, over a sparse standard form

    minimize    c @ z
    subject to  lb_row <= A @ z <= ub_row
                lo <= z <= hi
                z[integrality == 1] integer

backed by SciPy's HiGHS branch-and-bound when available.  HiGHS is an exact
solver of the same class as CPLEX; the paper's observation that "a few seconds
of solving already gives a near-optimal solution" carries over via the
``time_limit`` option (HiGHS returns its incumbent at the limit).

A pure-numpy fallback (`_greedy_repair`) exists so the core algorithms remain
runnable without scipy: it LP-relaxes nothing, it simply rounds a feasible
assignment greedily.  It is only used when scipy is missing and is clearly
marked in the result.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

try:  # scipy is an optional-but-expected dependency
    import scipy.optimize as _sopt
    import scipy.sparse as _ssp

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover - exercised only in scipy-less envs
    _HAVE_SCIPY = False

# The least time HiGHS is given, however much of the limit the build took.
MIN_HIGHS_SECONDS = 0.01


@dataclasses.dataclass
class MilpProblem:
    """A sparse MILP in row-bounded standard form."""

    c: np.ndarray  # (n,) objective
    a_rows: np.ndarray  # (nnz,) row indices of A
    a_cols: np.ndarray  # (nnz,) col indices of A
    a_vals: np.ndarray  # (nnz,) values of A
    row_lb: np.ndarray  # (m,)
    row_ub: np.ndarray  # (m,)
    var_lb: np.ndarray  # (n,)
    var_ub: np.ndarray  # (n,)
    integrality: np.ndarray  # (n,) 1 -> integer, 0 -> continuous

    @property
    def num_vars(self) -> int:
        return int(self.c.shape[0])

    @property
    def num_rows(self) -> int:
        return int(self.row_lb.shape[0])


@dataclasses.dataclass
class MilpResult:
    x: np.ndarray
    objective: float
    status: str  # "optimal" | "time_limit" | "infeasible" | "fallback"
    solve_seconds: float
    mip_gap: Optional[float] = None
    # Seconds spent handing the problem to the solver (its sparse matrix),
    # and whether the solver returned a point: "infeasible" is also the
    # status of a time limit that struck before the first incumbent.
    build_seconds: float = 0.0
    incumbent: bool = False

    @property
    def ok(self) -> bool:
        return self.status in ("optimal", "time_limit", "fallback")


def solve_milp(
    problem: MilpProblem,
    *,
    time_limit: float = 10.0,
    mip_rel_gap: float = 1e-4,
    warm_start: Optional[np.ndarray] = None,
) -> MilpResult:
    """Solve ``problem``; return the incumbent when the time limit strikes.

    ``time_limit`` covers the whole call: the time spent handing the
    problem to HiGHS is charged against it, and HiGHS gets what is left.
    ``warm_start`` is accepted for interface parity (HiGHS via scipy does not
    take MIP starts; the fallback uses it as its starting assignment).
    """
    if _HAVE_SCIPY:
        return _solve_scipy(problem, time_limit=time_limit, mip_rel_gap=mip_rel_gap)
    return _greedy_repair(problem, warm_start=warm_start)


def _solve_scipy(
    problem: MilpProblem, *, time_limit: float, mip_rel_gap: float
) -> MilpResult:
    t_build = time.perf_counter()
    n = problem.num_vars
    a = _ssp.csc_matrix(
        (problem.a_vals, (problem.a_rows, problem.a_cols)),
        shape=(problem.num_rows, n),
    )
    constraints = _sopt.LinearConstraint(a, problem.row_lb, problem.row_ub)
    bounds = _sopt.Bounds(problem.var_lb, problem.var_ub)
    t0 = time.perf_counter()
    build = t0 - t_build
    res = _sopt.milp(
        c=problem.c,
        constraints=constraints,
        bounds=bounds,
        integrality=problem.integrality,
        options={
            "time_limit": max(float(time_limit) - build, MIN_HIGHS_SECONDS),
            "mip_rel_gap": float(mip_rel_gap),
            "presolve": True,
        },
    )
    dt = time.perf_counter() - t0
    if res.x is None:
        return MilpResult(
            x=np.zeros(n),
            objective=float("inf"),
            status="infeasible",
            solve_seconds=dt,
            build_seconds=build,
        )
    status = "optimal" if res.status == 0 else "time_limit"
    gap = getattr(res, "mip_gap", None)
    return MilpResult(
        x=np.asarray(res.x, dtype=np.float64),
        objective=float(res.fun),
        status=status,
        solve_seconds=dt,
        mip_gap=None if gap is None else float(gap),
        build_seconds=build,
        incumbent=True,
    )


def _greedy_repair(
    problem: MilpProblem, warm_start: Optional[np.ndarray]
) -> MilpResult:
    """Scipy-less fallback: start from bounds/warm start, greedily repair rows.

    This is NOT a general MILP solver; it exists so that `repro_torch.core` degrades
    gracefully (the callers all build assignment-structured programs for which
    a feasible greedy point exists: each key group on its current node).
    """
    t0 = time.perf_counter()
    n = problem.num_vars
    x = np.clip(
        warm_start.astype(np.float64) if warm_start is not None else np.zeros(n),
        problem.var_lb,
        problem.var_ub,
    )
    # Round integers.
    mask = problem.integrality.astype(bool)
    x[mask] = np.round(x[mask])
    obj = float(problem.c @ x)
    return MilpResult(
        x=x,
        objective=obj,
        status="fallback",
        solve_seconds=time.perf_counter() - t0,
    )


def dense_rows(problem: MilpProblem) -> np.ndarray:
    """Materialize A densely (testing/debug only)."""
    a = np.zeros((problem.num_rows, problem.num_vars))
    a[problem.a_rows, problem.a_cols] = problem.a_vals
    return a


class MilpBuilder:
    """Incremental sparse builder for :class:`MilpProblem`.

    Constraint triplets and variable attributes are stored as *chunks* (lists
    of numpy arrays concatenated once in :meth:`build`), so the bulk paths —
    :meth:`add_binaries` and :meth:`add_rows` — append whole constraint blocks
    without any per-element Python list traffic.
    """

    def __init__(self) -> None:
        self._num_vars = 0
        self._obj: list[np.ndarray] = []
        self._lb: list[np.ndarray] = []
        self._ub: list[np.ndarray] = []
        self._int: list[np.ndarray] = []
        self._rows: list[np.ndarray] = []
        self._cols: list[np.ndarray] = []
        self._vals: list[np.ndarray] = []
        self._num_rows = 0
        self._row_lb: list[np.ndarray] = []
        self._row_ub: list[np.ndarray] = []
        self._bound_overrides: dict[int, tuple[float, float]] = {}
        self.names: dict[str, int] = {}

    # -- variables ---------------------------------------------------------
    def add_var(
        self,
        name: str,
        *,
        obj: float = 0.0,
        lb: float = 0.0,
        ub: float = np.inf,
        integer: bool = False,
    ) -> int:
        idx = self._num_vars
        self._num_vars += 1
        self._obj.append(np.array([obj], dtype=np.float64))
        self._lb.append(np.array([lb], dtype=np.float64))
        self._ub.append(np.array([ub], dtype=np.float64))
        self._int.append(np.array([1 if integer else 0], dtype=np.int64))
        if name:
            self.names[name] = idx
        return idx

    def add_binary(self, name: str, *, obj: float = 0.0) -> int:
        return self.add_var(name, obj=obj, lb=0.0, ub=1.0, integer=True)

    def add_binaries(self, count: int) -> int:
        """Bulk-append ``count`` anonymous binaries; returns the first index.

        Indices are contiguous — caller code typically scatters
        ``start + np.arange(count)`` into its own variable map.
        """
        start = self._num_vars
        self._num_vars += count
        self._obj.append(np.zeros(count))
        self._lb.append(np.zeros(count))
        self._ub.append(np.ones(count))
        self._int.append(np.ones(count, dtype=np.int64))
        return start

    def set_var_bounds(self, idx: int, lb: float, ub: float) -> None:
        """Override one variable's bounds (e.g. fix a pinned binary)."""
        self._bound_overrides[idx] = (float(lb), float(ub))

    # -- constraints --------------------------------------------------------
    def add_row(
        self,
        cols: list[int] | np.ndarray,
        vals: list[float] | np.ndarray,
        *,
        lb: float = -np.inf,
        ub: float = np.inf,
    ) -> int:
        row = self._num_rows
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        if cols.shape != vals.shape:
            raise ValueError(f"cols/vals mismatch {cols.shape} vs {vals.shape}")
        self._rows.append(np.full(len(cols), row, dtype=np.int64))
        self._cols.append(cols)
        self._vals.append(vals)
        self._num_rows += 1
        self._row_lb.append(np.array([lb]))
        self._row_ub.append(np.array([ub]))
        return row

    def add_rows(
        self,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        *,
        num_rows: int,
        lb: float | np.ndarray = -np.inf,
        ub: float | np.ndarray = np.inf,
    ) -> int:
        """Bulk-append a block of ``num_rows`` rows from COO triplets.

        ``rows`` holds block-relative indices in ``[0, num_rows)``; ``lb``/
        ``ub`` are scalars or (num_rows,) arrays.  Returns the block's first
        global row index.
        """
        base = self._num_rows
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        if not (rows.shape == cols.shape == vals.shape):
            raise ValueError(
                f"rows/cols/vals mismatch {rows.shape}/{cols.shape}/{vals.shape}"
            )
        self._rows.append(rows + base)
        self._cols.append(cols)
        self._vals.append(vals)
        self._row_lb.append(
            np.broadcast_to(np.asarray(lb, dtype=np.float64), (num_rows,)),
        )
        self._row_ub.append(
            np.broadcast_to(np.asarray(ub, dtype=np.float64), (num_rows,)),
        )
        self._num_rows += num_rows
        return base

    def build(self) -> MilpProblem:
        def cat(chunks: list[np.ndarray], dtype) -> np.ndarray:
            if not chunks:
                return np.empty(0, dtype=dtype)
            return np.concatenate(chunks).astype(dtype, copy=False)

        var_lb = cat(self._lb, np.float64)
        var_ub = cat(self._ub, np.float64)
        for idx, (lo, hi) in self._bound_overrides.items():
            var_lb[idx] = lo
            var_ub[idx] = hi
        return MilpProblem(
            c=cat(self._obj, np.float64),
            a_rows=cat(self._rows, np.int64),
            a_cols=cat(self._cols, np.int64),
            a_vals=cat(self._vals, np.float64),
            row_lb=cat(self._row_lb, np.float64),
            row_ub=cat(self._row_ub, np.float64),
            var_lb=var_lb,
            var_ub=var_ub,
            integrality=cat(self._int, np.int64),
        )
