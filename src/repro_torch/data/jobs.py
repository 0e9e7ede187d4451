"""The paper's Real Jobs 1–4 (§5.2–§5.4) as engine topologies.

A copy of the reference package's job definitions (``repro.data.jobs``).
Operator logic is genuinely executed (geohashing, windowed TopK, keyed sums,
stream joins) — the engine measures the resulting loads and communication, it
does not assume them.

Job 1  wiki → GeoHash → windowed TopK → global TopK      (full partitioning —
       the "LP-solver-only" case; collocation maxes out ~5%)
Job 2  airline → ExtractDelay → SumDelay(airplane, year)  (same key both ops —
       perfect collocation possible)
Job 3  job 2 + RouteDelay(origin→dest)                    (different key — the
       RouteDelay operator cannot collocate with SumDelay)
Job 4  job 3 + weather → RainScore → join(route × rainscore) → courier
       efficiency → store (periodic DB writes modelled as a sink)

Every operator implements both interpreted execution protocols:

* the per-run ``fn`` — the semantic oracle, executed per (key group, batch);
* the segment-vectorized ``fn_seg`` — one call per (node, operator) per tick
  covering every key group as whole-segment array operations (vectorized
  geohash bisection, segment-reduced running sums, masked join/rainscore);

and the flight-delay operators of jobs 2–3 (extract / sumdelay /
routedelay) the compiled tier's ``fn_jit`` (torch bodies over device
columns, run by :mod:`repro_torch.engine.jitexec` under
``ExecutionConfig.jit()``; the numpy tiers ignore it).

``fn_seg`` is required to be bit-identical to running ``fn`` run by run:
same emitted tuples in the same order, same per-key-group state including
dict insertion order (it decides TopK tie-breaks and pickle bytes), same
float trajectories (running sums accumulate strictly left to right).
Record-carrying edges declare a :class:`~repro_torch.engine.topology.Schema`,
so values flow as native structured arrays and ``fn_seg`` bodies read whole
column views; the per-run ``fn`` bodies normalize with one
``values.tolist()``, which keeps typed and untyped execution bit-identical.
Only the join keeps an undeclared (object) input edge: its two upstreams
carry different record layouts, so both decay at that boundary and the
operator discriminates sides by record arity.
"""

from __future__ import annotations

import numpy as np

import torch

from repro_torch.data import synthetic
from repro_torch.engine import jitexec as jx
from repro_torch.engine.topology import (
    OperatorSpec,
    Schema,
    StateField,
    StateSchema,
    Topology,
)

# --------------------------------------------------------------------------
# Shared operator bodies (state dicts are σ_k — everything must live there).
# --------------------------------------------------------------------------


def _geohash(lat: float, lon: float, precision: int = 5) -> str:
    """Standard geohash (base32) — executed per tuple like the paper's job."""
    _b32 = "0123456789bcdefghjkmnpqrstuvwxyz"
    lat_r, lon_r = [-90.0, 90.0], [-180.0, 180.0]
    bits, ch, even, out = 0, 0, True, []
    while len(out) < precision:
        if even:
            mid = (lon_r[0] + lon_r[1]) / 2
            if lon > mid:
                ch = ch * 2 + 1
                lon_r[0] = mid
            else:
                ch *= 2
                lon_r[1] = mid
        else:
            mid = (lat_r[0] + lat_r[1]) / 2
            if lat > mid:
                ch = ch * 2 + 1
                lat_r[0] = mid
            else:
                ch *= 2
                lat_r[1] = mid
        even = not even
        bits += 1
        if bits == 5:
            out.append(_b32[ch])
            bits, ch = 0, 0
    return "".join(out)


_B32_BYTES = np.frombuffer(b"0123456789bcdefghjkmnpqrstuvwxyz", dtype=np.uint8)


def _geohash_batch(lat: np.ndarray, lon: np.ndarray, precision: int = 5) -> list[str]:
    """Vectorized :func:`_geohash` — the same bisection, whole arrays at once.

    Each iteration performs exactly the scalar loop's float operations
    (``mid = (lo + hi) / 2``, compare, narrow), so the emitted characters are
    bit-identical to the per-tuple geohash for every input.
    """
    n = len(lat)
    lat_lo, lat_hi = np.full(n, -90.0), np.full(n, 90.0)
    lon_lo, lon_hi = np.full(n, -180.0), np.full(n, 180.0)
    codes = np.empty((n, precision), dtype=np.int64)
    ch = np.zeros(n, dtype=np.int64)
    bits, ci = 0, 0
    for i in range(precision * 5):
        if i % 2 == 0:
            mid = (lon_lo + lon_hi) / 2
            take = lon > mid
            ch = ch * 2 + take
            lon_lo = np.where(take, mid, lon_lo)
            lon_hi = np.where(take, lon_hi, mid)
        else:
            mid = (lat_lo + lat_hi) / 2
            take = lat > mid
            ch = ch * 2 + take
            lat_lo = np.where(take, mid, lat_lo)
            lat_hi = np.where(take, lat_hi, mid)
        bits += 1
        if bits == 5:
            codes[:, ci] = ch
            ch = np.zeros(n, dtype=np.int64)
            bits, ci = 0, ci + 1
    flat = _B32_BYTES[codes].tobytes().decode("ascii")
    return [flat[i * precision : (i + 1) * precision] for i in range(n)]


# Denmark bounding box (paper: "completely even distribution of GeoHash
# values covering Denmark").
_DK = (54.5, 57.8, 8.0, 12.7)


def _pseudo_locations(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized article-id → deterministic location inside Denmark.

    Mirrors the scalar ``(int(k) * 2654435761) & 0xFFFFFFFF`` mix: uint64
    wraparound keeps the low 32 bits identical to Python's unbounded product
    for any int64 key, and the float expressions apply the same operations
    in the same order.
    """
    rng = (keys.astype(np.uint64) * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
    lat = _DK[0] + (rng % np.uint64(10_000)) / 10_000 * (_DK[1] - _DK[0])
    lon = _DK[2] + ((rng // np.uint64(10_000)) % np.uint64(10_000)) / 10_000 * (
        _DK[3] - _DK[2]
    )
    return lat, lon


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


# geohash → topk record layout: (article, gh) tuples / the structured dtype.
G_ARTICLE, G_GH = range(2)
GEO_SCHEMA = Schema.record([("article", "i8"), ("gh", "U5")], key="U5")
WIKI_SCHEMA = Schema(synthetic.WIKI_DTYPE)


def make_real_job_1(
    *, keygroups_per_op: int = 100, topk: int = 10, window_ticks: float = 60.0
) -> Topology:
    def geohash_run(out, keys, values, ts):
        for k, t in zip(keys, ts):
            # Article id → deterministic pseudo-location inside Denmark.
            rng = (int(k) * 2654435761) & 0xFFFFFFFF
            lat = _DK[0] + (rng % 10_000) / 10_000 * (_DK[1] - _DK[0])
            lon = _DK[2] + ((rng // 10_000) % 10_000) / 10_000 * (_DK[3] - _DK[2])
            gh = _geohash(lat, lon)
            out.append((gh, (int(k), gh), float(t)))

    def geohash_op(state, keys, values, ts):
        out = []
        geohash_run(out, keys, values, ts)
        return state, out

    def geohash_seg(store, kgs, starts, ends, keys, values, ts):
        lat, lon = _pseudo_locations(keys)
        ghs = _geohash_batch(lat, lon)
        gh_keys = np.asarray(ghs)
        if values.dtype.names is not None:  # typed edge: build record columns
            out_vals = np.empty(len(keys), dtype=GEO_SCHEMA.value)
            out_vals["article"] = keys
            out_vals["gh"] = gh_keys
        else:
            out_vals = _object_array(list(zip(keys.tolist(), ghs)))
        return (gh_keys, out_vals, ts), None

    def topk_run(state, out, keys, values, ts):
        """Scalar TopK body shared by fn and the fn_seg window-closing path."""
        counts = state.setdefault("counts", {})
        w_start = state.setdefault("w_start", float(ts[0]) if len(ts) else 0.0)
        vals = values.tolist() if isinstance(values, np.ndarray) else values
        for k, v, t in zip(keys, vals, ts):
            art = v[G_ARTICLE]
            counts[art] = counts.get(art, 0) + 1
            if t - w_start >= window_ticks:
                top = sorted(counts.items(), key=lambda x: -x[1])[:topk]
                out.append((str(k), {"top": top, "gh": str(k)}, float(t)))
                counts.clear()
                state["w_start"] = float(t)
                w_start = float(t)

    def topk_op(state, keys, values, ts):
        out = []
        topk_run(state, out, keys, values, ts)
        return state, out

    def windowed_seg(scalar_run, accumulate):
        """Shared fn_seg wrapper for the windowed TopK operators.

        Runs where no window can close (every ts within ``window_ticks`` of
        the run's ``w_start``) take ``accumulate`` — the bulk counting path;
        runs that may close a window fall back to ``scalar_run``, the exact
        per-tuple body, so emissions stay bit-identical to the oracle.
        """

        def seg(store, kgs, starts, ends, keys, values, ts):
            out, lens = [], []
            for kg, a, z in zip(kgs, starts, ends):
                state = store[kg]
                t_run = ts[a:z]
                counts = state.setdefault("counts", {})
                w_start = state.setdefault(
                    "w_start", float(t_run[0]) if len(t_run) else 0.0
                )
                if len(t_run) and float(t_run.max()) - w_start < window_ticks:
                    accumulate(counts, keys[a:z], values[a:z])
                    lens.append(0)
                else:
                    run_out = []
                    scalar_run(state, run_out, keys[a:z], values[a:z], t_run)
                    out.extend(run_out)
                    lens.append(len(run_out))
            if not out:
                return None, None
            ok, ov, ot = zip(*out)
            return (np.asarray(ok), _object_array(list(ov)), np.asarray(ot)), lens

        return seg

    def topk_accumulate(counts, keys, values):
        # Segment-reduce the article counts.  First-occurrence order
        # preserves the dict insertion order the scalar loop produces (the
        # sort that ranks the TopK is stable, so ties break on it).
        n = len(values)
        if values.dtype.names is not None:  # typed edge: the column itself
            arts = values["article"]
        else:
            arts = np.fromiter((v[G_ARTICLE] for v in values), np.int64, count=n)
        uniq, first, cnt = np.unique(arts, return_index=True, return_counts=True)
        order = np.argsort(first, kind="stable")
        for art, c in zip(uniq[order].tolist(), cnt[order].tolist()):
            counts[art] = counts.get(art, 0) + c

    def global_topk_run(state, out, keys, values, ts):
        counts = state.setdefault("counts", {})
        w_start = state.setdefault("w_start", float(ts[0]) if len(ts) else 0.0)
        for k, v, t in zip(keys, values, ts):
            for art, c in v["top"]:
                counts[art] = counts.get(art, 0) + c
            if t - w_start >= window_ticks:
                top = sorted(counts.items(), key=lambda x: -x[1])[:topk]
                out.append(("global", {"top": top}, float(t)))
                counts.clear()
                state["w_start"] = float(t)
                w_start = float(t)

    def global_topk_op(state, keys, values, ts):
        out = []
        global_topk_run(state, out, keys, values, ts)
        return state, out

    def global_topk_accumulate(counts, keys, values):
        for v in values:
            for art, c in v["top"]:
                counts[art] = counts.get(art, 0) + c

    topk_seg = windowed_seg(topk_run, topk_accumulate)
    global_topk_seg = windowed_seg(global_topk_run, global_topk_accumulate)

    t = Topology()
    t.add_operator(
        OperatorSpec(
            "wiki",
            None,
            num_keygroups=keygroups_per_op,
            is_source=True,
            schema=WIKI_SCHEMA,
        )
    )
    t.add_operator(
        OperatorSpec(
            "geohash",
            geohash_op,
            num_keygroups=keygroups_per_op,
            cost_per_tuple=1.2,
            fn_seg=geohash_seg,
            schema=WIKI_SCHEMA,
            out_schema=GEO_SCHEMA,
        )
    )
    t.add_operator(
        OperatorSpec(
            "topk",
            topk_op,
            num_keygroups=keygroups_per_op,
            fn_seg=topk_seg,
            # TopK windows emit variable-length rankings (dict payloads):
            # the input edge is typed, the output edge stays object.
            schema=GEO_SCHEMA,
        )
    )
    t.add_operator(
        OperatorSpec(
            "global_topk",
            global_topk_op,
            num_keygroups=keygroups_per_op,
            is_sink=True,
            key_fn=lambda k: "global",
            fn_seg=global_topk_seg,
        )
    )
    t.connect("wiki", "geohash")
    t.connect("geohash", "topk")
    t.connect("topk", "global_topk")
    return t


def real_job_1(**kw) -> Topology:
    return make_real_job_1(**kw)


# --------------------------------------------------------------------------
# Jobs 2–4 (airline + weather)
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
#   join       → (delay, rainscore)                          _J_*
#   efficiency → (bucket, running_sum_delay)
#
# ``join`` merges two *different* record layouts (rainscore's (airport,
# rainscore) and routedelay's _RD_*), so its input edge stays undeclared —
# both sides decay to object tuples there and the operator discriminates
# them by record arity (rain records have 2 fields, route records 4).  Both
# layouts carry the join key at position 0.
# --------------------------------------------------------------------------

_R_PLANE, _R_DELAY, _R_YEAR, _R_ORIGIN, _R_DEST = range(5)
_RD_ORIGIN, _RD_DEST, _RD_SUM, _RD_DELAY = range(4)
_RAIN_AIRPORT, _RAIN_SCORE = range(2)
_J_DELAY, _J_SCORE = range(2)

AIRLINE_SCHEMA = Schema(synthetic.AIRLINE_DTYPE)
WEATHER_SCHEMA = Schema(synthetic.WEATHER_DTYPE)
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
RAIN_SCHEMA = Schema.record([("airport", "i8"), ("rainscore", "f8")])
JOIN_SCHEMA = Schema.record([("delay", "f8"), ("rainscore", "f8")])
EFF_SCHEMA = Schema.record([("bucket", "i8"), ("sum_delay", "f8")])


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


# --------------------------------------------------------------------------
# Compiled tier (OperatorSpec.fn_jit) for the flight-delay operators — pure
# integer/float column math on torch tensors, executed by
# repro_torch.engine.jitexec as one call per operator per tick.
#
# State lives in declared StateSchema columns: the (airplane, year) and
# (origin, dest) running sums are keyed-accumulator tables whose int64
# codes refine the partition key (equal codes ⇒ equal key group), with
# key_encode/key_decode converting to the oracle dicts' tuple keys.
# --------------------------------------------------------------------------


def _extract_delay_jit(state, kgs, starts, ends, keys, values, ts):
    out = {
        "plane": values["plane"],
        "delay": values["dep_delay"] + values["arr_delay"],
        "year": values["year"],
        "origin": values["origin"],
        "dest": values["dest"],
    }
    return state, (values["plane"], out, ts), None


def _sum_delay_jit(state, kgs, starts, ends, keys, values, ts):
    planes, years, delays = values["plane"], values["year"], values["delay"]
    nb = planes.shape[0]
    codes = (planes.to(torch.int64) << 32) | years.to(torch.int64)
    kg = kgs[jx.run_of_tuples(ends, nb)]
    valid = jx.tuple_valid(starts, ends, nb)
    table, running = jx.keyed_running_sum(state["sums"], codes, kg, delays, valid)
    return {"sums": table}, (planes, {"plane": planes, "sum": running}, ts), None


def _route_delay_jit(state, kgs, starts, ends, keys, values, ts):
    na = synthetic.num_airports()
    origins, dests, delays = values["origin"], values["dest"], values["delay"]
    nb = origins.shape[0]
    codes = origins.to(torch.int64) * na + dests
    kg = kgs[jx.run_of_tuples(ends, nb)]
    valid = jx.tuple_valid(starts, ends, nb)
    table, running = jx.keyed_running_sum(state["route_sums"], codes, kg, delays, valid)
    out = {"origin": origins, "dest": dests, "sum": running, "delay": delays}
    return {"route_sums": table}, (codes, out, ts), None


def _plane_year_encode(key: tuple) -> int:
    return (int(key[0]) << 32) | int(key[1])


def _plane_year_decode(code: int) -> tuple:
    return (code >> 32, code & 0xFFFFFFFF)


def _route_encode(key: tuple) -> int:
    return int(key[0]) * synthetic.num_airports() + int(key[1])


def _route_decode(code: int) -> tuple:
    na = synthetic.num_airports()
    return (code // na, code % na)


SUM_STATE = StateSchema(
    (
        StateField(
            "sums",
            "table",
            dtype=np.float64,
            py=float,
            key_encode=_plane_year_encode,
            key_decode=_plane_year_decode,
        ),
    )
)
ROUTE_STATE = StateSchema(
    (
        StateField(
            "route_sums",
            "table",
            dtype=np.float64,
            py=float,
            key_encode=_route_encode,
            key_decode=_route_decode,
        ),
    )
)



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
            fn_jit=_extract_delay_jit,
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
            fn_jit=_sum_delay_jit,
            state_schema=SUM_STATE,
            schema=EXTRACT_SCHEMA,
            # Sinks have no downstream edge to validate, but the jit tier
            # packs its output columns through the declared record layout.
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
            fn_jit=_route_delay_jit,
            state_schema=ROUTE_STATE,
            schema=EXTRACT_SCHEMA,
            out_schema=ROUTE_SCHEMA,
        )
    )
    t.connect("extract", "routedelay")
    return t


def real_job_4(*, keygroups_per_op: int = 100) -> Topology:
    def rainscore(state, keys, values, ts):
        out = []
        for v, t in zip(values.tolist(), ts):
            score = 100.0 * v[synthetic.WX_PRECIP] / synthetic.max_precip()
            airport = v[synthetic.WX_AIRPORT]
            out.append((airport, (airport, score), float(t)))
        return state, out

    def rainscore_seg(store, kgs, starts, ends, keys, values, ts):
        if values.dtype.names is not None:
            scores = 100.0 * values["precip"] / synthetic.max_precip()
            out_keys = values["airport"]
            out_vals = np.empty(len(values), dtype=RAIN_SCHEMA.value)
            out_vals["airport"] = out_keys
            out_vals["rainscore"] = scores
            return (out_keys, out_vals, ts), None
        vals = values.tolist()
        precip = np.asarray([v[synthetic.WX_PRECIP] for v in vals])
        scores = (100.0 * precip / synthetic.max_precip()).tolist()
        out_keys = np.asarray(
            [v[synthetic.WX_AIRPORT] for v in vals], dtype=np.int64
        )
        out_vals = _object_array(list(zip(out_keys.tolist(), scores)))
        return (out_keys, out_vals, ts), None

    def join_route_rain(state, keys, values, ts):
        rain = state.setdefault("rain", {})  # airport → latest rainscore
        out = []
        for v, t in zip(values.tolist(), ts):
            if len(v) == 2:  # a rainscore record: (airport, rainscore)
                rain[v[_RAIN_AIRPORT]] = v[_RAIN_SCORE]
            else:  # a route-delay record; join on origin airport
                score = rain.get(v[_RD_ORIGIN], 0.0)
                out.append((v[_RD_ORIGIN], (v[_RD_DELAY], score), float(t)))
        return state, out

    def join_seg(store, kgs, starts, ends, keys, values, ts):
        """Masked join: runs of a single side take the vectorized path (bulk
        dict update / bulk lookup); mixed runs keep the ordered scalar walk,
        because an update must be visible to every later lookup in the run."""
        vals = values.tolist()
        ts_list = ts.tolist()
        out_k, out_v, out_t, lens = [], [], [], []
        for kg, a, z in zip(kgs, starts, ends):
            rain = store[kg].setdefault("rain", {})
            run_vals = vals[a:z]
            is_rain = [len(v) == 2 for v in run_vals]
            emitted = 0
            if all(is_rain):  # pure weather run: last write per airport wins
                rain.update(run_vals)
            elif not any(is_rain):  # pure route run: lookups only
                for i, v in enumerate(run_vals):
                    o = v[_RD_ORIGIN]
                    out_k.append(o)
                    out_v.append((v[_RD_DELAY], rain.get(o, 0.0)))
                    out_t.append(ts_list[a + i])
                    emitted += 1
            else:
                for i, v in enumerate(run_vals):
                    if is_rain[i]:
                        rain[v[_RAIN_AIRPORT]] = v[_RAIN_SCORE]
                    else:
                        o = v[_RD_ORIGIN]
                        out_k.append(o)
                        out_v.append((v[_RD_DELAY], rain.get(o, 0.0)))
                        out_t.append(ts_list[a + i])
                        emitted += 1
            lens.append(emitted)
        if not out_k:
            return None, None
        return (
            (np.asarray(out_k), _object_array(out_v), np.asarray(out_t)),
            lens,
        )

    def courier_efficiency(state, keys, values, ts):
        buckets = state.setdefault("buckets", {})  # rainscore decile → Σ delay
        out = []
        for v, t in zip(values.tolist(), ts):
            b = min(int(v[_J_SCORE] // 10), 9)
            buckets[b] = buckets.get(b, 0.0) + v[_J_DELAY]
            out.append((b, (b, buckets[b]), float(t)))
        return state, out

    def efficiency_seg(store, kgs, starts, ends, keys, values, ts):
        if values.dtype.names is not None:
            delays = values["delay"]
            scores = values["rainscore"]
            delays_l = delays.tolist()
        else:
            vals = values.tolist()
            delays_l, scores_l = zip(*vals)
            delays = np.asarray(delays_l)
            scores = np.asarray(scores_l)
        # Rainscores are non-negative, so the float floor-division matches
        # the scalar ``min(int(score // 10), 9)`` bucket exactly.
        buckets_arr = np.minimum((scores // 10.0).astype(np.int64), 9)
        buckets_l = buckets_arr.tolist()
        out_sums = _grouped_running_sums(
            store,
            kgs,
            starts,
            ends,
            buckets_arr,
            "buckets",
            buckets_l,
            delays_l,
            delays,
        )
        if values.dtype.names is not None:
            out_vals = np.empty(len(values), dtype=EFF_SCHEMA.value)
            out_vals["bucket"] = buckets_arr
            out_vals["sum_delay"] = out_sums
            return (buckets_arr, out_vals, ts), None
        out_vals = _object_array(list(zip(buckets_l, out_sums)))
        return (buckets_arr, out_vals, ts), None

    def store(state, keys, values, ts):
        rows = state.setdefault("rows", [])
        vals = values.tolist()
        for k, v, t in zip(keys, vals, ts):
            rows.append((int(k), v[1], float(t)))  # v = (bucket, sum_delay)
        if len(rows) > 1_000:  # periodic flush to the "local database"
            del rows[:-100]
        return state, []

    def store_seg(kg_store, kgs, starts, ends, keys, values, ts):
        klist = keys.tolist()
        if values.dtype.names is not None:
            sums_l = values["sum_delay"].tolist()
        else:
            sums_l = [v[1] for v in values.tolist()]
        tlist = ts.tolist()
        for kg, a, z in zip(kgs, starts, ends):
            rows = kg_store[kg].setdefault("rows", [])
            rows.extend(zip(klist[a:z], sums_l[a:z], tlist[a:z]))
            if len(rows) > 1_000:  # the scalar body flushes once per run
                del rows[:-100]
        return None, None

    t = real_job_3(keygroups_per_op=keygroups_per_op)
    t.operators[t._resolve("routedelay")].is_sink = False
    t.add_operator(
        OperatorSpec(
            "weather",
            None,
            num_keygroups=keygroups_per_op,
            is_source=True,
            schema=WEATHER_SCHEMA,
        )
    )
    t.add_operator(
        OperatorSpec(
            "rainscore",
            rainscore,
            num_keygroups=keygroups_per_op,
            key_by_value=lambda v: v[synthetic.WX_STATION],
            key_by_value_col=lambda v: v["station"],
            fn_seg=rainscore_seg,
            schema=WEATHER_SCHEMA,
            out_schema=RAIN_SCHEMA,
        )
    )
    t.add_operator(
        OperatorSpec(
            "join",
            join_route_rain,
            num_keygroups=keygroups_per_op,
            # Both sides partition by airport id, carried at position 0 of
            # either record layout (rain: airport; route: origin airport).
            # The input edge is undeclared — two different upstream layouts —
            # so both sides decay to object tuples here.
            key_by_value=lambda v: v[0],
            fn_seg=join_seg,
            out_schema=JOIN_SCHEMA,
        )
    )
    t.add_operator(
        OperatorSpec(
            "efficiency",
            courier_efficiency,
            num_keygroups=keygroups_per_op,
            key_by_value=lambda v: min(int(v[_J_SCORE] // 10), 9),  # decile
            key_by_value_col=lambda v: np.minimum(
                (v["rainscore"] // 10.0).astype(np.int64), 9
            ),
            fn_seg=efficiency_seg,
            schema=JOIN_SCHEMA,
            out_schema=EFF_SCHEMA,
        )
    )
    t.add_operator(
        OperatorSpec(
            "store",
            store,
            num_keygroups=keygroups_per_op,
            is_sink=True,
            fn_seg=store_seg,
            schema=EFF_SCHEMA,
        )
    )
    t.connect("weather", "rainscore")
    t.connect("rainscore", "join")
    t.connect("routedelay", "join")
    t.connect("join", "efficiency")
    t.connect("efficiency", "store")
    return t
