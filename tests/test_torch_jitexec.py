"""The port's compiled operator tier (``repro_torch.engine.jitexec``) against
the reference's (``repro.engine.jitexec``), on the CPU.

* The authoring helpers — ``tuple_valid``, ``run_of_tuples``,
  ``count_runs`` and ``keyed_running_sum`` — on the same inputs, made with
  numpy from a seed: run indexes, codes, sequence numbers, owners, the
  sorted view and used counts equal; running sums at the documented
  ``rtol=1e-9``.
* The non-mesh mechanics of ``tests/test_jitexec.py`` on the port: compile
  counts bounded by padding buckets, table growth, migration blobs,
  install-then-resume.
* The conformance pipeline's and the fuzz pool's ``fn_jit`` bodies,
  re-written here as torch bodies, run on their topologies against the
  reference's ``.jit()`` and ``.typed()`` engines in the harness's three
  scenarios, with the jit counters equal call for call; and Real Jobs 2
  and 3 on the port's ``.jit()`` against the reference's one-device mesh
  engine (``.jit(mesh=jax.make_mesh((1,), ("nodes",)))``), the port's
  one path against what the reference's mesh path computes.
"""

import math

import numpy as np
import pytest

from conformance import (
    FUZZ_RECORD_DTYPE,
    _FUZZ_WINDOW,
    _fuzz_bodies,
    assert_equivalent,
    fuzz_feeders,
    make_fuzz_topology,
    make_pipeline_topo,
    run_scenario,
)
from test_real_jobs_conformance import SCENARIOS

import repro.engine as ref_engine

# CI's tier-1 job installs no torch (repro_torch imports it): skip this
# module there, not fail collection.
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.engine import jitexec as rjx  # noqa: E402

import repro_torch.engine as port_engine  # noqa: E402
from repro_torch.data import StreamSpec, airline_stream, real_job_2  # noqa: E402
from repro_torch.engine import jitexec as jx  # noqa: E402
from repro_torch.engine.topology import (  # noqa: E402
    OperatorSpec,
    Schema,
    StateField,
    StateSchema,
    Topology,
)
from test_torch_engine import run_port_scenario  # noqa: E402

RTOL = ATOL = 1e-9  # conformance.JIT_FLOAT_RTOL/ATOL
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# authoring helpers against the reference's
# ---------------------------------------------------------------------------


def _runs(rng, n, r, rb):
    """Random run bounds tiling [0, n) (some empty), padded to ``rb`` runs
    with ``start == end == n`` as the runtime pads them."""
    cuts = np.sort(rng.integers(0, n + 1, size=r - 1))
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [n]])
    pad = np.full(rb - r, n)
    return np.concatenate([starts, pad]), np.concatenate([ends, pad])


@pytest.mark.parametrize("n,nb,r,rb", [(0, 16, 1, 4), (13, 16, 3, 4), (50, 64, 7, 8), (64, 64, 8, 8)])
def test_run_helpers_match_reference(n, nb, r, rb):
    rng = np.random.default_rng(n + nb + r)
    starts, ends = _runs(rng, n, r, rb)
    got_v = jx.tuple_valid(_t(starts), _t(ends), nb).numpy()
    ref_v = np.asarray(rjx.tuple_valid(jnp.asarray(starts), jnp.asarray(ends), nb))
    assert got_v.tolist() == ref_v.tolist()
    got_r = jx.run_of_tuples(_t(ends), nb).numpy()
    ref_r = np.asarray(rjx.run_of_tuples(jnp.asarray(ends), nb))
    assert got_r.tolist() == ref_r.tolist()
    # count_runs: padding runs carry kg == K and are dropped.
    k = 5
    kgs = np.concatenate([rng.integers(0, k, size=r), np.full(rb - r, k)])
    col = rng.integers(0, 100, size=k).astype(np.int64)
    got_c = jx.count_runs(_t(col), _t(kgs), _t(starts), _t(ends)).numpy()
    ref_c = np.asarray(rjx.count_runs(jnp.asarray(col), jnp.asarray(kgs), jnp.asarray(starts), jnp.asarray(ends)))
    assert got_c.tolist() == ref_c.tolist()


def _ref_table(cap):
    return rjx.TableState(
        codes=jnp.full(cap, rjx.EMPTY_CODE, dtype=jnp.int64),
        vals=jnp.zeros(cap, dtype=jnp.float64),
        seq=jnp.zeros(cap, dtype=jnp.int64),
        owner=jnp.zeros(cap, dtype=jnp.int32),
        perm=jnp.arange(cap, dtype=jnp.int32),
        cnt=jnp.zeros((), dtype=jnp.int32),
        epoch=jnp.ones((), dtype=jnp.int64),
    )


def _ref_grown(t, new_cap):
    """The reference runtime's ``_grow`` (unsharded), on a bare table."""
    old = t.codes.shape[0]
    pad = new_cap - old
    codes = np.full(new_cap, rjx.EMPTY_CODE, dtype=np.int64)
    codes[:old] = np.asarray(t.codes)
    return rjx.TableState(
        codes=jnp.asarray(codes),
        vals=jnp.pad(t.vals, (0, pad)),
        seq=jnp.pad(t.seq, (0, pad)),
        owner=jnp.pad(t.owner, (0, pad)),
        perm=jnp.concatenate([t.perm, jnp.arange(old, new_cap, dtype=t.perm.dtype)]),
        cnt=t.cnt,
        epoch=t.epoch,
    )


# case → (segment bucket, real tuples, code space, random invalid holes,
# order handed in)
KRS_CASES = {
    "new": (64, 50, 10_000, False, False),  # nearly every code new
    "hits": (64, 60, 12, False, False),  # few codes: mostly table hits
    "padding": (64, 40, 30, True, False),  # an EMPTY tail and holes
    "growth": (128, 120, 400, False, False),  # past _MIN_TABLE_CAP, twice
    "order": (64, 64, 40, True, True),  # the pre-sorted order handoff
}


@pytest.mark.parametrize("case", list(KRS_CASES), ids=str)
def test_keyed_running_sum_matches_reference(case):
    nb, n, space, holes, handoff = KRS_CASES[case]
    rng = np.random.default_rng(sorted(KRS_CASES).index(case))
    num_kg = 7
    ref_t = _ref_table(jx._MIN_TABLE_CAP)
    got_t = jx.empty_table(jx._MIN_TABLE_CAP, np.float64, CPU)
    cnt = 0
    for _ in range(4):
        codes = rng.integers(0, space, size=nb).astype(np.int64)
        kg = codes % num_kg  # equal codes → equal key group
        addends = rng.normal(10.0, 30.0, size=nb)
        valid = np.arange(nb) < n
        if holes:
            valid &= rng.random(nb) > 0.2
        # The runtime grows a table to fit one new entry per tuple.
        if cnt + nb > ref_t.codes.shape[0]:
            cap = jx._bucket(cnt + nb, jx._MIN_TABLE_CAP)
            ref_t, got_t = _ref_grown(ref_t, cap), jx.grown_table(got_t, cap)
        order = None
        if handoff:
            order = np.argsort(np.where(valid, codes, jx.EMPTY_CODE), kind="stable")
        ref_t, ref_run = rjx.keyed_running_sum(
            ref_t, jnp.asarray(codes), jnp.asarray(kg), jnp.asarray(addends),
            jnp.asarray(valid), None if order is None else jnp.asarray(order),
        )
        got_t, got_run = jx.keyed_running_sum(
            got_t, _t(codes), _t(kg), _t(addends), _t(valid),
            None if order is None else _t(order),
        )
        for name in ("codes", "seq", "owner", "perm", "cnt", "epoch"):
            a, b = np.asarray(getattr(ref_t, name)), getattr(got_t, name).numpy()
            assert a.dtype == b.dtype and a.tolist() == b.tolist(), name
        np.testing.assert_allclose(got_t.vals.numpy(), np.asarray(ref_t.vals), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            got_run.numpy()[valid], np.asarray(ref_run)[valid], rtol=RTOL, atol=ATOL
        )
        cnt = int(got_t.cnt)
    if case == "growth":
        assert got_t.codes.shape[0] > 2 * jx._MIN_TABLE_CAP


def _fold(dicts, codes, kg, addends, valid):
    out = np.zeros(len(codes))
    for i in np.flatnonzero(valid):
        d = dicts[kg[i]]
        d[codes[i]] = d.get(codes[i], 0.0) + addends[i]
        out[i] = d[codes[i]]
    return out


def test_keyed_running_sum_matches_python_fold():
    """The port's mirror of the reference's kernel check: lookups,
    first-occurrence insertion order, padding masks, duplicate codes."""
    rng = np.random.default_rng(7)
    n, nb, num_kg, cap = 50, 64, 3, 64
    codes = rng.integers(0, 6, size=nb).astype(np.int64) * 3 + np.arange(nb) % 3
    kg = codes % 3
    addends = rng.normal(size=nb)
    valid = np.arange(nb) < n
    dicts = [dict() for _ in range(num_kg)]
    table = jx.empty_table(cap, np.float64, CPU)
    for _ in range(2):
        table, running = jx.keyed_running_sum(table, _t(codes), _t(kg), _t(addends), _t(valid))
        ref = _fold(dicts, codes, kg, addends, valid)
        np.testing.assert_allclose(running.numpy()[:n], ref[:n], rtol=RTOL, atol=1e-12)
        t_codes, t_seq, t_owner = table.codes.numpy(), table.seq.numpy(), table.owner.numpy()
        cnt = int(table.cnt)
        assert cnt == sum(len(d) for d in dicts)
        for k in range(num_kg):
            mine = np.flatnonzero(t_owner[:cnt] == k)
            order = mine[np.argsort(t_seq[mine], kind="stable")]
            assert t_codes[order].tolist() == list(dicts[k])
        perm = table.perm.numpy()
        assert sorted(perm.tolist()) == list(range(cap))
        assert np.all(np.diff(t_codes[perm]) >= 0)
    # First occurrences are exact (group heads take base + addend).
    _, first_run = jx.keyed_running_sum(
        jx.empty_table(cap, np.float64, CPU), _t(codes), _t(kg), _t(addends), _t(valid)
    )
    seen = set()
    for i in range(n):
        if codes[i] not in seen:
            seen.add(codes[i])
            assert first_run.numpy()[i] == addends[i]


def test_running_sum_does_not_round_through_other_groups():
    """A group of small addends after groups of huge ones: each running sum
    stays within the tolerance of the left fold, because the within-group
    prefix never passes through the segment's running total."""
    nb = 256
    codes = np.repeat(np.arange(8, dtype=np.int64), nb // 8)
    kg = np.zeros(nb, dtype=np.int64)
    rng = np.random.default_rng(3)
    addends = np.where(codes < 7, 1e13, 0.0) + rng.normal(0.0, 1e-3, size=nb)
    valid = np.ones(nb, dtype=bool)
    table = jx.empty_table(nb, np.float64, CPU)
    _, running = jx.keyed_running_sum(table, _t(codes), _t(kg), _t(addends), _t(valid))
    ref = _fold([dict()], codes, kg, addends, valid)
    np.testing.assert_allclose(running.numpy(), ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# torch ports of the conformance pipeline's and fuzz pool's fn_jit bodies
# ---------------------------------------------------------------------------


def _pipe_mid_jit(state, kgs, starts, ends, keys, values, ts):
    return {"n": jx.count_runs(state["n"], kgs, starts, ends)}, (keys + 17, values, ts), None


def _pipe_sink_jit(state, kgs, starts, ends, keys, values, ts):
    return {"n": jx.count_runs(state["n"], kgs, starts, ends)}, (keys * 2, values, ts), None


_PIPE_STATE = StateSchema((StateField("n", "scalar", dtype=np.int64, py=int),))


def port_pipeline_topo(kgs: int = 16) -> Topology:
    """``conformance.make_pipeline_topo`` on the port's classes, with the
    torch jit bodies above (the numpy bodies copied); both jit operators
    ``jit_fusible``, as the reference's."""
    scalar = Schema(np.dtype(np.float64))

    def mid_fn(state, keys, values, ts):
        state["n"] = state.get("n", 0) + len(keys)
        return state, (keys + 17, values, ts)

    def mid_seg(store, run_kgs, starts, ends, keys, values, ts):
        for kg, a, z in zip(run_kgs, starts, ends):
            st = store[kg]
            st["n"] = st.get("n", 0) + (z - a)
        return (keys + 17, values, ts), None

    def sink_fn(state, keys, values, ts):
        state["n"] = state.get("n", 0) + len(keys)
        return state, (keys * 2, values, ts)

    def sink_seg(store, run_kgs, starts, ends, keys, values, ts):
        for kg, a, z in zip(run_kgs, starts, ends):
            st = store[kg]
            st["n"] = st.get("n", 0) + (z - a)
        return (keys * 2, values, ts), None

    t = Topology()
    t.add_operator(OperatorSpec("src", None, num_keygroups=kgs, is_source=True, schema=scalar))
    t.add_operator(
        OperatorSpec(
            "mid", mid_fn, num_keygroups=kgs, fn_seg=mid_seg, fn_jit=_pipe_mid_jit,
            jit_fusible=True, state_schema=_PIPE_STATE, schema=scalar, out_schema=scalar,
        )
    )
    t.add_operator(
        OperatorSpec(
            "sink", sink_fn, num_keygroups=kgs, is_sink=True, fn_seg=sink_seg,
            fn_jit=_pipe_sink_jit, jit_fusible=True, state_schema=_PIPE_STATE,
            schema=scalar, out_schema=scalar,
        )
    )
    t.connect("src", "mid")
    t.connect("mid", "sink")
    return t


_FUZZ_JIT_STATE = StateSchema((StateField("n", "scalar", dtype=np.int64, py=int),))
_FUZZ_WINDOW_STATE = StateSchema(
    (StateField("buf", "vector", dtype=np.float64, py=float, length=_FUZZ_WINDOW),)
)


def _fuzz_jit_bodies(kind: str, family: str):
    """Torch port of ``conformance._fuzz_jit_bodies``: ``(fn_jit,
    state_schema)`` of one generic fuzz operator (``accum`` stays on the
    numpy tiers).  Scatters drop through ``jx.scatter_drop``'s trash slot
    where the reference writes ``mode="drop"``."""
    rec = family == "record"
    if kind == "accum":
        return None, None
    if kind in ("rekey", "vshift", "project"):

        def fn_jit(state, kgs, starts, ends, keys, values, ts):
            new = {"n": jx.count_runs(state["n"], kgs, starts, ends)}
            if kind == "rekey":
                return new, (keys + 7, values, ts), None
            if kind == "vshift":
                return new, (keys, values + 0.5, ts), None
            return new, (keys, {"a": values["a"], "b": values["b"] + values["a"]}, ts), None

        return fn_jit, _FUZZ_JIT_STATE

    if kind == "filter":

        def fn_jit(state, kgs, starts, ends, keys, values, ts):
            n = keys.shape[0]
            new = {"n": jx.count_runs(state["n"], kgs, starts, ends)}
            keep = (values["a"] % 3 != 0) if rec else (keys % 3 != 0)
            keepv = jx.tuple_valid(starts, ends, n) & keep
            # Stable partition: kept tuples first, in run-major order.
            order = torch.argsort(torch.where(keepv, 0, 1), stable=True)
            ov = {nm: col[order] for nm, col in values.items()} if rec else values[order]
            oc = torch.zeros(kgs.shape[0], dtype=torch.int64).index_add_(
                0, jx.run_of_tuples(ends, n), keepv.to(torch.int64)
            )
            return new, (keys[order], ov, ts[order]), oc

        return fn_jit, _FUZZ_JIT_STATE

    # window: sliding count window over a fixed-length VectorState ring.
    def fn_jit(state, kgs, starts, ends, keys, values, ts):
        W = _FUZZ_WINDOW
        data, cnt = state["buf"].data, state["buf"].cnt
        nkg = data.shape[0]
        n = keys.shape[0]
        payload = values["b"] if rec else values
        ridx = jx.run_of_tuples(ends, n)
        kg_t = torch.clamp(kgs[ridx], 0, nkg - 1)
        c_t = cnt[kg_t].to(torch.int64)
        pos = torch.arange(n)
        m = pos - starts[ridx] + 1
        s = torch.zeros(n, dtype=torch.float64)
        for d in range(W - 1, -1, -1):  # back-offset from the newest element
            pay = payload[torch.clamp(pos - d, 0, n - 1)]
            ring = data[kg_t, torch.clamp(c_t + m - 1 - d, 0, W - 1)]
            s = torch.where(d < c_t + m, s + torch.where(d < m, pay, ring), s)
        L = ends - starts
        kg_r = torch.clamp(kgs, 0, nkg - 1)
        c_r = cnt[kg_r].to(torch.int64)
        new_cnt = torch.clamp(c_r + L, max=W)
        j = torch.arange(W)[None, :]
        s_idx = (c_r + L - new_cnt)[:, None] + j
        from_pay = s_idx >= c_r[:, None]
        pay_idx = starts[:, None] + (s_idx - c_r[:, None])
        row = torch.where(
            j < new_cnt[:, None],
            torch.where(
                from_pay,
                payload[torch.clamp(pay_idx, 0, n - 1)],
                data[kg_r[:, None], torch.clamp(s_idx, 0, W - 1)],
            ),
            0.0,
        )
        new_vst = jx.VectorState(
            jx.scatter_drop(data, kgs, row), jx.scatter_drop(cnt, kgs, new_cnt.to(cnt.dtype))
        )
        out_v = {"a": values["a"], "b": s} if rec else s
        return {"buf": new_vst}, (keys, out_v, ts), None

    return fn_jit, _FUZZ_WINDOW_STATE


def port_fuzz_topology(spec: dict) -> Topology:
    """``conformance.make_fuzz_topology`` on the port's classes with the
    torch jit bodies (the numpy fn/fn_seg bodies shared)."""
    family = spec["family"]
    value_dtype = FUZZ_RECORD_DTYPE if family == "record" else np.dtype(np.float64)
    schema = Schema(value_dtype, key=np.dtype(spec["key_dtype"]))
    t = Topology()
    t.add_operator(
        OperatorSpec(
            "src", None, num_keygroups=spec.get("source_kgs", 8), is_source=True,
            schema=schema if spec["source_schema"] else None,
        )
    )
    for i, op in enumerate(spec["ops"]):
        fn, seg = _fuzz_bodies(op["kind"], family)
        kw = {}
        if op["key"] == "mod":
            kw["key_fn"] = lambda k: k % 13
        elif op["key"] == "byval" and family == "record":
            kw["key_by_value"] = lambda v: v[0] % 11
            kw["key_by_value_col"] = lambda v: v["a"] % np.int64(11)
        fj, st = _fuzz_jit_bodies(op["kind"], family)
        if fj is not None and op["schema"] and (family == "scalar" or op["out_schema"]):
            kw["fn_jit"] = fj
            kw["state_schema"] = st
            # The reference's superstep contract: strictly 1:1 bodies with
            # scalar state and an unmapped partition key.
            kw["jit_fusible"] = op["kind"] in ("rekey", "vshift", "project") and op["key"] == "id"
        t.add_operator(
            OperatorSpec(
                f"op{i}", fn, num_keygroups=op["kgs"], fn_seg=seg,
                schema=schema if op["schema"] else None,
                out_schema=schema if op["out_schema"] else None,
                **kw,
            )
        )
    for i, ups in enumerate(spec["edges"]):
        for u in ups:
            t.connect("src" if u < 0 else f"op{u}", f"op{i}")
    return t


def _op(kind, kgs, key="id", schema=True, out_schema=True):
    return {"kind": kind, "kgs": kgs, "schema": schema, "out_schema": out_schema, "key": key}


# Two fixed draws from the fuzz grammar that cover every jit body (the 1:1
# scalar-state bodies, filter's out_counts, window's VectorState), a fan-in,
# an undeclared edge beside jit operators, int32 keys and a value-keyed hop.
FUZZ_SPECS = {
    "scalar": {
        "family": "scalar", "key_dtype": "i8", "source_schema": True,
        "ops": [_op("rekey", 6), _op("window", 5, "mod"), _op("filter", 4),
                _op("vshift", 3, schema=False, out_schema=False)],
        "edges": [[-1], [0], [0, 1], [2]],
    },
    "record": {
        "family": "record", "key_dtype": "i4", "source_schema": True,
        "ops": [_op("project", 6, "byval"), _op("filter", 5), _op("window", 4, "mod"),
                _op("accum", 3)],
        "edges": [[-1], [0], [1], [1, 2]],
    },
}


# Real Jobs whose reference runs as the one-device mesh engine.
MESH_JOBS = ("job2", "job3")


def _topologies(name):
    """(reference factory, reference feeders, port factory, port feeders)
    per topology."""
    if name in MESH_JOBS:
        from test_torch_engine import _port_factories, _ref_factories

        return (*_ref_factories(name), *_port_factories(name))
    if name == "pipeline":
        from conformance import _pipeline_feeders

        return (lambda: make_pipeline_topo(12), _pipeline_feeders,
                lambda: port_pipeline_topo(12), _pipeline_feeders)
    spec = FUZZ_SPECS[name]
    feeders = fuzz_feeders(spec)
    return (lambda: make_fuzz_topology(spec), feeders, lambda: port_fuzz_topology(spec), feeders)


def _ref_jit_config(name):
    """The reference's ``.jit()``; for :data:`MESH_JOBS`, its mesh engine on
    one device."""
    if name in MESH_JOBS:
        import jax

        return ref_engine.ExecutionConfig.jit(mesh=jax.make_mesh((1,), ("nodes",)))
    return ref_engine.ExecutionConfig.jit()


_JIT_COUNTERS = ("jit_calls", "jit_compiles", "jit_host_syncs", "seg_calls", "seg_tuples")


@pytest.mark.parametrize("scenario", list(SCENARIOS), ids=str)
@pytest.mark.parametrize("topo", ["pipeline", *FUZZ_SPECS, *MESH_JOBS], ids=str)
def test_jit_bodies_match_reference(topo, scenario):
    ref_topo, ref_feeders, port_topo, port_feeders = _topologies(topo)
    sc = SCENARIOS[scenario]
    ref_jit = run_scenario(ref_topo, ref_feeders, sc, _ref_jit_config(topo))
    ref_typed = run_scenario(ref_topo, ref_feeders, sc, ref_engine.ExecutionConfig.typed())
    port, eng = run_port_scenario(port_topo, port_feeders, sc, port_engine.ExecutionConfig.jit())
    assert_equivalent({"ref:soa+seg+schema+jit": ref_jit, "port:soa+seg+schema+jit": port})
    assert_equivalent({"ref:soa+seg+schema": ref_typed, "port:soa+seg+schema+jit": port})
    assert port["jit_calls"] > 0
    for field in _JIT_COUNTERS:
        assert port[field] == ref_jit[field], field
    if topo == "pipeline":  # integer state: migration blobs byte-identical
        assert port["migration_blobs"] == ref_jit["migration_blobs"]


# ---------------------------------------------------------------------------
# the reference's runtime mechanics (tests/test_jitexec.py, non-mesh)
# ---------------------------------------------------------------------------


def _engine(topo, nodes=4, **kw):
    return port_engine.Engine(
        topo, nodes, service_rate=1e9, seed=0, config=port_engine.ExecutionConfig.jit(),
        device="cpu", **kw,
    )


def _feed_pipeline(eng, sizes, *, seed=0):
    rng = np.random.default_rng(seed)
    for t, n in enumerate(sizes):
        keys = rng.integers(0, 10_000, size=n).astype(np.int64)
        eng.push_source("src", keys, rng.random(n), np.full(n, float(t)))
        eng.tick()
    for _ in range(6):
        eng.tick()


def test_compiles_bounded_by_buckets_not_ticks():
    eng = _engine(port_pipeline_topo(8))
    _feed_pipeline(eng, [7, 40, 900, 13, 260, 55, 1, 470, 33, 128] * 6)
    m = eng.metrics
    assert m.jit_calls > 100
    assert m.jit_compiles < 40
    assert m.jit_compiles < m.jit_calls / 4
    assert m.jit_tuples > 0
    assert eng._jit.compile_seconds > 0.0


def test_second_engine_counts_the_same_buckets():
    counts = []
    for _ in range(2):
        eng = _engine(port_pipeline_topo(8), nodes=2)
        _feed_pipeline(eng, [64, 64, 64, 64])
        counts.append((eng.metrics.jit_compiles, eng.metrics.jit_calls))
    assert counts[0] == counts[1]


def test_jit_requires_soa_and_schema():
    cfg = port_engine.ExecutionConfig
    with pytest.raises(ValueError):
        cfg(queue_impl="deque", use_fn_jit=True, use_schema=True)
    with pytest.raises(ValueError):
        cfg(use_schema=False, use_fn_jit=True)
    with pytest.raises(ValueError, match="splitting"):
        cfg(use_fn_jit=True, split_degree=2)
    assert cfg.jit().name == "soa+seg+schema+jit"


def test_table_growth_past_initial_capacity():
    """More distinct keys than the 64-slot initial capacity: the runtime
    grows the tables and the state stays equal to the numpy tier's."""
    kw = dict(service_rate=1e9, seed=0, collect_sinks=False, device="cpu")
    jit_eng = port_engine.Engine(
        real_job_2(keygroups_per_op=2), 2, config=port_engine.ExecutionConfig.jit(), **kw
    )
    seg_eng = port_engine.Engine(real_job_2(keygroups_per_op=2), 2, **kw)
    stream = airline_stream(StreamSpec(rate=500.0, seed=3))
    batches = [next(stream) for _ in range(6)]
    for eng in (jit_eng, seg_eng):
        for k, v, ts in batches:
            eng.push_source("airline", k, v, ts)
            eng.tick()
        for _ in range(4):
            eng.tick()
        eng.end_period()
    assert jit_eng._jit._by_op[2].caps["sums"] > 64
    for kg in range(jit_eng.topology.num_keygroups):
        a, b = jit_eng.store.get(kg), seg_eng.store.get(kg)
        assert list(a) == list(b)
        for name in a:
            assert list(a[name]) == list(b[name])  # keys + insertion order
            assert all(
                math.isclose(x, y, rel_tol=RTOL, abs_tol=ATOL)
                for x, y in zip(a[name].values(), b[name].values())
            )


def test_migration_blob_bytes_identical_on_integer_state():
    jit_eng = _engine(port_pipeline_topo(8), nodes=2)
    seg_eng = port_engine.Engine(port_pipeline_topo(8), 2, service_rate=1e9, seed=0, device="cpu")
    _feed_pipeline(jit_eng, [100, 80, 120])
    _feed_pipeline(seg_eng, [100, 80, 120])
    assert jit_eng.metrics.jit_calls > 0
    for kg in range(8, 24):
        assert jit_eng.serialize(kg) == seg_eng.serialize(kg)


def test_install_then_jit_resumes_from_installed_state():
    eng = _engine(port_pipeline_topo(8), nodes=2)
    _feed_pipeline(eng, [50, 50])
    kg = 8  # a mid-operator key group
    blob = eng.serialize(kg)
    before = dict(eng.store.get(kg))
    assert before["n"] > 0
    dst = (eng.router.node_of(kg) + 1) % eng.num_nodes
    eng.redirect(kg, dst)
    eng.install(kg, dst, blob)
    assert eng.store.get(kg) == before
    _feed_pipeline(eng, [50])
    eng._jit.sync_store()
    assert eng.store.get(kg)["n"] >= before["n"]


def test_duplicate_key_groups_run_as_one_plain_call():
    """Duplicate key groups in one call run as one plain call: scalar state
    stays exact, as the reference's parity script checks."""
    e = port_engine.Engine(port_pipeline_topo(4), 2, service_rate=1e9, seed=0, device="cpu",
                           config=port_engine.ExecutionConfig.jit())
    g = e.topology.kg_base(1)
    keys = np.arange(4, dtype=np.int64)
    out, _ = e._jit_exec(1, [g + 1, g + 1], [0, 2], [2, 4], keys, keys, np.zeros(4))
    e._jit.sync_store()
    assert e.store.get(g + 1) == {"n": 4}
    assert np.asarray(out[0]).tolist() == (keys + 17).tolist()  # the body's 1:1 outputs


def test_mesh_needs_the_devices_it_names():
    from repro_torch.launch.mesh import make_mesh

    with pytest.raises(RuntimeError, match="needs 2 devices, found 1"):
        make_mesh((2,), ("nodes",), device="cpu")
