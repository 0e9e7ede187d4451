"""The paper's Real Jobs 2 and 3 (§5.3) as engine topologies.

A copy of the reference package's job definitions (``repro.data.jobs``)
for the jobs this slice of the port runs; jobs 1 and 4 and the compiled
tier's ``fn_jit`` bodies come with later slices.

Job 2  airline → ExtractDelay → SumDelay(airplane, year)  (same key both ops —
       perfect collocation possible)
Job 3  job 2 + RouteDelay(origin→dest)                    (different key — the
       RouteDelay operator cannot collocate with SumDelay)

Every operator implements both interpreted execution protocols:

* the per-run ``fn`` — the semantic oracle, executed per (key group, batch);
* the segment-vectorized ``fn_seg`` — one call per (node, operator) per tick
  covering every key group as whole-segment array operations (segment-
  reduced running sums).

``fn_seg`` is required to be bit-identical to running ``fn`` run by run:
same emitted tuples in the same order, same per-key-group state including
dict insertion order (it decides pickle bytes), same float trajectories
(running sums accumulate strictly left to right).  Record-carrying edges
declare a :class:`~repro_torch.engine.topology.Schema`, so values flow as
native structured arrays and ``fn_seg`` bodies read whole column views; the
per-run ``fn`` bodies normalize with one ``values.tolist()``, which keeps
typed and untyped execution bit-identical.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data import synthetic
from repro_torch.engine.topology import OperatorSpec, Schema, Topology

# --------------------------------------------------------------------------
# Shared operator bodies (state dicts are σ_k — everything must live there).
# --------------------------------------------------------------------------


def _segment_groups(codes: np.ndarray, ends: list, *, max_group_fraction: float = 0.8):
    """Group segment tuples by an integer code.

    Returns an iterator of ``(first_index, run_slot, member_positions)`` per
    distinct code — groups in first-occurrence order (so state-dict keys are
    inserted exactly as the per-run loop would insert them), ``run_slot``
    indexing the run (hence key group) that owns the group's tuples, member
    positions ascending (original tuple order within the group),
    ``members=None`` for singletons.  Returns **None** when the codes are
    mostly unique (``> max_group_fraction`` of the tuples): per-group
    machinery cannot pay for itself there, and the caller's plain sequential
    loop is both faster and trivially order-exact.
    """
    n = len(codes)
    order = np.argsort(codes, kind="stable")
    sc = codes[order]
    group_starts = np.flatnonzero(np.concatenate(([True], sc[1:] != sc[:-1])))
    if len(group_starts) > max_group_fraction * n:
        return None
    return _iter_groups(order, group_starts, n, ends)


def _iter_groups(order: np.ndarray, group_starts: np.ndarray, n: int, ends: list):
    group_ends = np.append(group_starts[1:], n)
    # The stable sort keeps original order inside a group, so each block's
    # first element is the group's first occurrence.
    first = order[group_starts]
    # Runs tile the segment, so the run owning tuple i is the first whose
    # end exceeds i — one vectorized searchsorted for every group at once.
    slots = np.searchsorted(np.asarray(ends), first, side="right").tolist()
    starts_l, ends_l = group_starts.tolist(), group_ends.tolist()
    first_l = first.tolist()
    for gi in np.argsort(first, kind="stable").tolist():
        a, z = starts_l[gi], ends_l[gi]
        if z - a == 1:
            yield first_l[gi], slots[gi], None
        else:
            yield first_l[gi], slots[gi], order[a:z]


def _running_sum(base: float, addends: np.ndarray) -> np.ndarray:
    """Per-tuple running totals with the exact left-to-right float trajectory
    of ``s = base; for d in addends: s = s + d`` (np.cumsum is a sequential
    left fold, so ``cumsum([base, d0, d1, ...])[1:]`` reproduces it bit for
    bit)."""
    seq = np.empty(len(addends) + 1)
    seq[0] = base
    seq[1:] = addends
    return np.cumsum(seq)[1:]


# Below this group size a plain python accumulation beats the numpy cumsum's
# fixed cost; both produce the identical left-to-right float trajectory.
_CUMSUM_MIN = 16


def _scatter_running(out, sums, key, base, members, delays_l, delays):
    """Write the running totals of one multi-member group into ``out`` (a
    python list) and return the group's final total."""
    members_l = members.tolist()
    if len(members_l) < _CUMSUM_MIN:
        s = base
        for pos in members_l:
            s = s + delays_l[pos]
            out[pos] = s
        sums[key] = s
    else:
        run = _running_sum(base, delays[members]).tolist()
        for pos, s in zip(members_l, run):
            out[pos] = s
        sums[key] = run[-1]


def _object_array(items: list) -> np.ndarray:
    out = np.empty(len(items), dtype=object)
    out[:] = items
    return out


def _grouped_running_sums(
    store, kgs, starts, ends, codes, state_name, keys_l, delays_l, delays
):
    """Running-sum reduction of one segment, grouped by integer ``codes``.

    ``keys_l[i]`` is tuple i's state-dict key (each key lives in exactly one
    key group, so grouping the whole segment touches each ``store[kg]``
    dict exactly as the per-run loop would, in the same insertion order);
    ``state_name`` names the per-key-group dict holding the sums.  Returns
    the per-tuple running totals, python floats in tuple order, with the
    exact left-to-right float trajectory of the scalar loop.  Shared by
    SumDelay, RouteDelay and courier-efficiency.
    """
    n = len(codes)
    out_sums = [0.0] * n
    groups = _segment_groups(codes, ends)
    if groups is None:  # mostly-unique keys: plain per-run sequential loop
        for kg, a, z in zip(kgs, starts, ends):
            sums = store[kg].setdefault(state_name, {})
            for i in range(a, z):
                key = keys_l[i]
                s = sums.get(key, 0.0) + delays_l[i]
                sums[key] = s
                out_sums[i] = s
    else:
        run_sums: list = [None] * len(kgs)
        for i0, slot, members in groups:
            sums = run_sums[slot]
            if sums is None:
                sums = run_sums[slot] = store[kgs[slot]].setdefault(state_name, {})
            key = keys_l[i0]
            if members is None:
                s = sums.get(key, 0.0) + delays_l[i0]
                sums[key] = s
                out_sums[i0] = s
            else:
                base = sums.get(key, 0.0)
                _scatter_running(out_sums, sums, key, base, members, delays_l, delays)
    return out_sums


# --------------------------------------------------------------------------
# Jobs 2–3 (airline)
#
# ExtractDelay is a projection: it reads the wide airline record once and
# emits a *compact record tuple* — the classic column-pruning pushdown.
# Downstream operators index the record positionally, so the segment-
# vectorized bodies extract whole columns — as structured column views on
# schema-typed edges, or with one C-level ``zip(*values)`` on the object
# path.  Record layouts (each with a declared Schema for the typed edge):
#
#   extract    → (airplane, delay, year, origin, dest)       _R_*
#   sumdelay   → (airplane, running_sum)                      sink record
#   routedelay → (origin, dest, running_sum, delay)          _RD_*
# --------------------------------------------------------------------------

_R_PLANE, _R_DELAY, _R_YEAR, _R_ORIGIN, _R_DEST = range(5)
_RD_ORIGIN, _RD_DEST, _RD_SUM, _RD_DELAY = range(4)

AIRLINE_SCHEMA = Schema(synthetic.AIRLINE_DTYPE)
EXTRACT_SCHEMA = Schema.record(
    [
        ("plane", "i8"),
        ("delay", "f8"),
        ("year", "i8"),
        ("origin", "i8"),
        ("dest", "i8"),
    ]
)
SUM_OUT_SCHEMA = Schema.record([("plane", "i8"), ("sum", "f8")])
ROUTE_SCHEMA = Schema.record(
    [("origin", "i8"), ("dest", "i8"), ("sum", "f8"), ("delay", "f8")]
)


def _extract_delay(state, keys, values, ts):
    out = []
    for v, t in zip(values.tolist(), ts):
        delay = v[synthetic.A_DEP_DELAY] + v[synthetic.A_ARR_DELAY]
        out.append(
            (
                v[synthetic.A_PLANE],  # keyed by airplane → 1:1 with SumDelay
                (
                    v[synthetic.A_PLANE],
                    delay,
                    v[synthetic.A_YEAR],
                    v[synthetic.A_ORIGIN],
                    v[synthetic.A_DEST],
                ),
                float(t),
            )
        )
    return state, out


def _extract_delay_seg(store, kgs, starts, ends, keys, values, ts):
    """Stateless projection over the whole segment.

    Typed edge: every column moves with one native assignment and the delay
    is one vector add — no python objects are materialized at all.  Object
    path: column extraction is one C-level ``zip(*values)`` and the records
    are zipped back together."""
    if values.dtype.names is not None:
        out_vals = np.empty(len(values), dtype=EXTRACT_SCHEMA.value)
        out_vals["plane"] = values["plane"]
        out_vals["delay"] = values["dep_delay"] + values["arr_delay"]
        out_vals["year"] = values["year"]
        out_vals["origin"] = values["origin"]
        out_vals["dest"] = values["dest"]
        return (values["plane"], out_vals, ts), None
    vals = values.tolist()
    planes, origins, dests, dep, arr, years = zip(*vals)
    delays = (np.asarray(dep) + np.asarray(arr)).tolist()
    out_keys = np.asarray(planes, dtype=np.int64)
    out_vals = _object_array(list(zip(planes, delays, years, origins, dests)))
    return (out_keys, out_vals, ts), None


def _sum_delay(state, keys, values, ts):
    sums = state.setdefault("sums", {})
    out = []
    for v, t in zip(values.tolist(), ts):
        key = (v[_R_PLANE], v[_R_YEAR])
        sums[key] = sums.get(key, 0.0) + v[_R_DELAY]
        out.append((v[_R_PLANE], (v[_R_PLANE], sums[key]), float(t)))
    return state, out


def _sum_delay_seg(store, kgs, starts, ends, keys, values, ts):
    """Segment-reduced keyed sums: one grouped pass over every key group.

    Every (airplane, year) pair lives in exactly one key group (the operator
    partitions by airplane), so grouping the whole segment by the pair code
    touches each state dict exactly as the per-run loop would.  Hot pairs
    (Zipf airplane popularity) reduce to one cumulative sum; tail singletons
    take a plain scalar add.
    """
    typed = values.dtype.names is not None
    if typed:
        planes = values["plane"]
        years = values["year"]
        delays = values["delay"]
        planes_l, years_l, delays_l = (
            planes.tolist(),
            years.tolist(),
            delays.tolist(),
        )
    else:
        vals = values.tolist()
        planes_l, delays_l, years_l, _, _ = zip(*vals)
        planes = np.asarray(planes_l, dtype=np.int64)
        years = np.asarray(years_l, dtype=np.int64)
        delays = np.asarray(delays_l)
    # Airplane ids and years are non-negative and < 2^31: the shifted code is
    # collision-free in int64.
    codes = (planes << np.int64(32)) | years
    out_sums = _grouped_running_sums(
        store,
        kgs,
        starts,
        ends,
        codes,
        "sums",
        list(zip(planes_l, years_l)),
        delays_l,
        delays,
    )
    if typed:
        out_vals = np.empty(len(values), dtype=SUM_OUT_SCHEMA.value)
        out_vals["plane"] = planes
        out_vals["sum"] = out_sums
        return (planes, out_vals, ts), None
    out_vals = _object_array(list(zip(planes_l, out_sums)))
    return (planes, out_vals, ts), None


def _route_delay(state, keys, values, ts):
    sums = state.setdefault("route_sums", {})
    out = []
    for v, t in zip(values.tolist(), ts):
        route = (v[_R_ORIGIN], v[_R_DEST])
        sums[route] = sums.get(route, 0.0) + v[_R_DELAY]
        out.append(
            (
                v[_R_ORIGIN] * synthetic.num_airports() + v[_R_DEST],
                (v[_R_ORIGIN], v[_R_DEST], sums[route], v[_R_DELAY]),
                float(t),
            )
        )
    return state, out


def _route_delay_seg(store, kgs, starts, ends, keys, values, ts):
    """Segment-reduced route sums; the group code doubles as the output key."""
    na = synthetic.num_airports()
    typed = values.dtype.names is not None
    if typed:
        origins, dests, delays = values["origin"], values["dest"], values["delay"]
        origins_l, dests_l, delays_l = (
            origins.tolist(),
            dests.tolist(),
            delays.tolist(),
        )
        # dest < num_airports() ⇒ collision-free group code == output key
        out_keys = origins * np.int64(na) + dests
    else:
        vals = values.tolist()
        _, delays_l, _, origins_l, dests_l = zip(*vals)
        origins = np.asarray(origins_l, dtype=np.int64)
        dests = np.asarray(dests_l, dtype=np.int64)
        delays = np.asarray(delays_l)
        out_keys = origins * na + dests
    out_sums = _grouped_running_sums(
        store,
        kgs,
        starts,
        ends,
        out_keys,
        "route_sums",
        list(zip(origins_l, dests_l)),
        delays_l,
        delays,
    )
    if typed:
        out_vals = np.empty(len(values), dtype=ROUTE_SCHEMA.value)
        out_vals["origin"] = origins
        out_vals["dest"] = dests
        out_vals["sum"] = out_sums
        out_vals["delay"] = delays
        return (out_keys, out_vals, ts), None
    out_vals = _object_array(list(zip(origins_l, dests_l, out_sums, delays_l)))
    return (out_keys, out_vals, ts), None



def real_job_2(*, keygroups_per_op: int = 100) -> Topology:
    t = Topology()
    t.add_operator(
        OperatorSpec(
            "airline",
            None,
            num_keygroups=keygroups_per_op,
            is_source=True,
            schema=AIRLINE_SCHEMA,
        )
    )
    # Both operators parallelized on the SAME attribute (airplane) — the
    # One-To-One pattern where perfect collocation is possible (paper §5.4).
    # The airline stream keys tuples by airplane and extract re-keys by
    # airplane, so identity partitioning hashes exactly the attribute the
    # paper names — and integer keys route through the vectorized mix.
    t.add_operator(
        OperatorSpec(
            "extract",
            _extract_delay,
            num_keygroups=keygroups_per_op,
            fn_seg=_extract_delay_seg,
            schema=AIRLINE_SCHEMA,
            out_schema=EXTRACT_SCHEMA,
        )
    )
    t.add_operator(
        OperatorSpec(
            "sumdelay",
            _sum_delay,
            num_keygroups=keygroups_per_op,
            is_sink=True,
            fn_seg=_sum_delay_seg,
            schema=EXTRACT_SCHEMA,
            out_schema=SUM_OUT_SCHEMA,
        )
    )
    t.connect("airline", "extract")
    t.connect("extract", "sumdelay")
    return t


def real_job_3(*, keygroups_per_op: int = 100) -> Topology:
    t = real_job_2(keygroups_per_op=keygroups_per_op)
    t.operators[t._resolve("sumdelay")].is_sink = True
    # RouteDelay partitions by route — a different attribute, so it CANNOT be
    # collocated with SumDelay (paper: "collocation factor is only half").
    # The partition key is the integer route code (bijective with the
    # (origin, dest) pair, dest < num_airports): integer keys hash through
    # the vectorized mix — on typed batches as one whole-column expression
    # (key_by_value_col), never touching per-tuple python.
    na = synthetic.num_airports()
    t.add_operator(
        OperatorSpec(
            "routedelay",
            _route_delay,
            num_keygroups=keygroups_per_op,
            key_by_value=lambda v: v[_R_ORIGIN] * na + v[_R_DEST],
            key_by_value_col=lambda v: v["origin"] * np.int64(na) + v["dest"],
            is_sink=True,
            fn_seg=_route_delay_seg,
            schema=EXTRACT_SCHEMA,
            out_schema=ROUTE_SCHEMA,
        )
    )
    t.connect("extract", "routedelay")
    return t
