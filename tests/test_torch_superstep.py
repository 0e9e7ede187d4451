"""The port's fused superstep (``repro_torch.engine.superstep``) against the
reference's (``repro.engine.superstep``), on the CPU.

Every test of ``tests/test_superstep.py`` on the port: the same topologies
(``port_pipeline_topo``, ``port_fuzz_topology`` and a port of the
benchmark's record pipeline, with torch ``fn_jit`` bodies and key maps
over tensors), the same inputs made with numpy from a seed, driven through
the port's ``ExecutionConfig.superstep()`` engine and the reference's.  The pipelines' state is integer, so every field
``test_superstep._result`` pins is held equal (no tolerance), with the jit
counters — one host sync per fused tick and one per scan, as in the
reference.  Beyond the mirror: ``local_keygroups`` against the reference's
``local_keygroups_jax``, the scan's exact usage fold under non-dyadic costs,
the record pipeline (record columns, a counting sink whose ``fn_jit``
emits nothing) in both routing modes, and an emitting record sink with a
migration against the port's ``.jit()`` engine.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from conformance import (
    METRIC_FIELDS,
    Scenario,
    _int_batches,
    assert_equivalent,
    fuzz_feeders,
    make_fuzz_topology,
    make_pipeline_topo,
    normalize,
    run_scenario,
)
from test_superstep import _FUZZ_SPECS

import repro.engine as ref_engine
from repro.engine.topology import Schema as RefSchema

# CI's tier-1 job installs no torch (repro_torch imports it): skip this
# module there, not fail collection.
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.engine import superstep as rss  # noqa: E402

import repro_torch.engine as port_engine  # noqa: E402
from repro_torch.engine import jitexec as jx  # noqa: E402
from repro_torch.engine import superstep as ss  # noqa: E402
from repro_torch.engine.topology import (  # noqa: E402
    OperatorSpec,
    Schema,
    StateField,
    StateSchema,
    Topology,
)
from test_torch_engine import run_port_scenario  # noqa: E402
from test_torch_jitexec import port_fuzz_topology, port_pipeline_topo  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JIT_COUNTERS = ("jit_calls", "jit_compiles", "jit_host_syncs", "ticks", "typed_batches")


def _engine(package, superstep, *, topo=None, service_rate=1e9, num_nodes=4, **kw):
    """The pipeline engine of ``test_superstep._engine`` in ``package``
    (the reference's or the port's, on the CPU)."""
    if package is port_engine:
        kw["device"] = "cpu"
        topo = topo or port_pipeline_topo()
    else:
        topo = topo or make_pipeline_topo()
    cfg = package.ExecutionConfig
    return package.Engine(
        topo, num_nodes, service_rate=service_rate, seed=0,
        config=cfg.superstep() if superstep else cfg.jit(), **kw,
    )


def _result(eng):
    """``test_superstep._result``, with the jit counters, and the arrival
    and usage vectors read before ``end_period`` zeroes them (with the
    snapshot's folded loads beside them)."""
    arrivals, usage = eng._arrivals.tolist(), eng._cpu_usage.tolist()
    snap = eng.end_period()
    return {
        "metrics": {m: getattr(eng.metrics, m) for m in METRIC_FIELDS + _JIT_COUNTERS},
        "sink_outputs": normalize(eng.metrics.sink_outputs),
        "states": [normalize(s) for _, s in eng.store.items()],
        "pair_src": snap.out_pairs.src.tolist(),
        "pair_dst": snap.out_pairs.dst.tolist(),
        "pair_rate": snap.out_pairs.rate.tolist(),
        "arrivals": arrivals,
        "usage": usage,
        "kg_load": snap.kg_load.tolist(),
        "kg_tuple_rate": snap.kg_tuple_rate.tolist(),
        "queue_costs": [q.cost for q in eng._queues],
        "alloc": eng.router.table.tolist(),
    }


def _assert_same(ref, port, classic=None):
    """Every field of ``_result`` equal between the reference's and the
    port's engines; with ``classic`` (a port ``.jit()`` engine) every field
    but the counters equal to it too.  Each result folds its engine's
    statistics period, so each engine is read once."""
    ra, rb = _result(ref), _result(port)
    for field in ra:
        assert ra[field] == rb[field], field
    if classic is not None:
        # The scan needs fewer ticks than the classic engine to drain, and
        # the snapshot's loads and rates are per tick.
        rc = _result(classic)
        for field in rc:
            if field not in ("metrics", "kg_load", "kg_tuple_rate"):
                assert rc[field] == rb[field], field
        assert rc["metrics"]["processed_tuples"] == rb["metrics"]["processed_tuples"]


def _drive(eng, *, ticks=12, migrate_at=(), fail_at=None, collect_blobs=False):
    """``test_superstep._drive`` (the same feed and migration draws)."""
    feed = _int_batches()
    rng = np.random.default_rng(1)
    in_flight = []
    blobs = []
    for t in range(ticks):
        if t in migrate_at:
            kg = int(rng.integers(0, eng.topology.num_keygroups))
            dst = int(rng.integers(0, eng.num_nodes))
            if not eng.router.is_in_flight(kg):
                eng.redirect(kg, dst)
                in_flight.append((t, kg, dst))
        if fail_at is not None and t == fail_at:
            eng.fail_node(2)
        keys, values, ts = next(feed)
        eng.push_source("src", keys, values, ts)
        eng.tick()
        for item in list(in_flight):
            t0, kg, dst = item
            if t >= t0 + 1:
                blob = eng.serialize(kg)
                if collect_blobs:
                    blobs.append(blob)
                eng.install(kg, dst, blob)
                in_flight.remove(item)
    for _ in range(8):
        eng.tick()
    return blobs


def _fused_ticks(eng):
    """The host syncs each non-empty tick that the fused runtime ran
    (``try_fused_tick`` → True) added, in order."""
    rt = eng._superstep_rt()
    seen = []
    inner = rt.try_fused_tick

    def counted():
        before = eng.metrics.jit_host_syncs
        busy = any(bool(q) for q in eng._queues)
        fused = inner()
        if fused and busy:
            seen.append(eng.metrics.jit_host_syncs - before)
        return fused

    rt.try_fused_tick = counted
    return seen


# ---------------------------------------------------------------------------
# routing helpers against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nkg", [1, 7, 16, 1000], ids=str)
@pytest.mark.parametrize("dtype", [np.int64, np.int32], ids=["i8", "i4"])
def test_local_keygroups_match_reference(nkg, dtype):
    rng = np.random.default_rng(nkg)
    info = np.iinfo(dtype)
    keys = rng.integers(info.min, info.max, size=300, dtype=dtype)
    got = ss.local_keygroups(torch.from_numpy(keys), nkg).numpy()
    ref = np.asarray(rss.local_keygroups_jax(jnp.asarray(keys), nkg))
    assert got.dtype == np.int64 and got.tolist() == ref.tolist()


@pytest.mark.parametrize("c", [1.0, 0.25, 0.1, 3.7e15], ids=str)
def test_add_repeated_is_np_add_at(c):
    """The scan's source-usage fold equals the reference's per-tuple
    ``np.add.at`` bit for bit, on and off the exact-sum grid."""
    rng = np.random.default_rng(int(c * 10) % 97)
    idx = np.arange(3, 40)
    counts = rng.integers(0, 60, size=len(idx))
    start = rng.integers(0, 9, size=50) * 0.3
    ref, got = start.copy(), start.copy()
    np.add.at(ref, np.repeat(idx, counts), np.full(counts.sum(), c))
    ss._add_repeated(got, idx, counts, c)
    assert got.tobytes() == ref.tobytes()


# ---------------------------------------------------------------------------
# static eligibility
# ---------------------------------------------------------------------------


def test_plan_accepts_the_pipeline_chain():
    eng = _engine(port_engine, True)
    plan = ss.plan_chain(eng)
    assert plan is not None
    assert [eng.topology.operators[o].name for o in plan.fops] == ["mid", "sink"]
    assert not plan.static_route


def test_plan_rejects_non_fusible_shapes():
    # Not marked jit_fusible → never fuses (the contract is an opt-in).
    topo = port_pipeline_topo()
    topo.operators[1].jit_fusible = False
    assert ss.plan_chain(_engine(port_engine, True, topo=topo)) is None
    # Non-identity partition key breaks the device-routing replay.
    topo = port_pipeline_topo()
    topo.operators[2].key_fn = lambda k: k % 3
    assert ss.plan_chain(_engine(port_engine, True, topo=topo)) is None
    # The interpreted tiers must not build a plan at all.
    eng = port_engine.Engine(port_pipeline_topo(), 4, service_rate=1e9, seed=0, device="cpu")
    assert ss.plan_chain(eng) is None


def test_superstep_config_requires_the_jit_tier():
    cfg = port_engine.ExecutionConfig
    with pytest.raises(ValueError, match="use_superstep requires use_fn_jit"):
        cfg(use_superstep=True)
    assert cfg.superstep().name == "soa+seg+schema+jit+superstep"
    assert cfg.superstep().name == ref_engine.ExecutionConfig.superstep().name


# ---------------------------------------------------------------------------
# fused tick: equivalence + one crossing per tick
# ---------------------------------------------------------------------------


def test_fused_tick_is_bit_identical_and_syncs_once_per_tick():
    ref = _engine(ref_engine, True)
    _drive(ref)
    port = _engine(port_engine, True)
    fused = _fused_ticks(port)
    _drive(port)
    jit = _engine(port_engine, False)
    _drive(jit)
    assert fused and set(fused) == {1}  # one crossing per non-empty fused tick
    m, mj = port.metrics, jit.metrics
    # Classic: one crossing per fn_jit operator per non-empty tick.
    assert 0 < m.jit_host_syncs < mj.jit_host_syncs
    assert m.jit_host_syncs <= m.ticks
    _assert_same(ref, port, jit)


def test_migration_blobs_byte_identical_at_superstep_boundary():
    ref = _engine(ref_engine, True)
    blobs_ref = _drive(ref, migrate_at=(3, 7), collect_blobs=True)
    port = _engine(port_engine, True)
    blobs_port = _drive(port, migrate_at=(3, 7), collect_blobs=True)
    jit = _engine(port_engine, False)
    blobs_jit = _drive(jit, migrate_at=(3, 7), collect_blobs=True)
    assert blobs_ref and blobs_ref == blobs_port == blobs_jit
    _assert_same(ref, port)


@pytest.mark.parametrize("case", ["binding_budget", "dead_node"], ids=str)
def test_classic_fallback(case):
    """A binding budget (service_rate 60: partial drains every tick) and a
    dead node make ``_collect`` bail; ``flush_to_host`` leaves the classic
    drain bit-exact."""
    kw = dict(service_rate=60.0) if case == "binding_budget" else {}
    drive = dict(fail_at=5) if case == "dead_node" else {}
    ref = _engine(ref_engine, True, **kw)
    _drive(ref, **drive)
    port = _engine(port_engine, True, **kw)
    _drive(port, **drive)
    _assert_same(ref, port)


# ---------------------------------------------------------------------------
# the reference's fixed fuzz specs under the port's .superstep()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(_FUZZ_SPECS), ids=str)
def test_fuzz_specs_conform(name):
    spec = _FUZZ_SPECS[name]
    scenario = Scenario("fuzz", ticks=10, drain_ticks=6, migrate_at=(4,))
    feeders = fuzz_feeders(spec)
    cfg = ref_engine.ExecutionConfig
    ref_ss = run_scenario(lambda: make_fuzz_topology(spec), feeders, scenario, cfg.superstep())
    ref_typed = run_scenario(lambda: make_fuzz_topology(spec), feeders, scenario, cfg.typed())
    port, _ = run_port_scenario(
        lambda: port_fuzz_topology(spec), feeders, scenario, port_engine.ExecutionConfig.superstep()
    )
    name_ = "soa+seg+schema+jit+superstep"
    assert_equivalent({f"ref:{name_}": ref_ss, f"port:{name_}": port})
    assert_equivalent({"ref:soa+seg+schema": ref_typed, f"port:{name_}": port})
    assert port["jit_calls"] > 0
    for field in ("jit_calls", "jit_compiles", "jit_host_syncs", "seg_calls", "typed_batches"):
        assert port[field] == ref_ss[field], field
    # Integer state and exact float payloads: the envelopes are the bytes.
    assert port["migration_blobs"] == ref_ss["migration_blobs"]


# ---------------------------------------------------------------------------
# run_supersteps: the K-tick scan
# ---------------------------------------------------------------------------


def _batches(K, seed=5):
    feed = _int_batches(seed=seed)
    return [next(feed) for _ in range(K)]


def _drain(eng):
    while any(bool(q) for q in eng._queues):
        eng.tick()


def _scan(eng, batches):
    syncs = eng.metrics.jit_host_syncs
    assert eng.run_supersteps(batches) == len(batches)
    # One host crossing for all K supersteps.
    assert eng.metrics.jit_host_syncs - syncs == 1
    _drain(eng)


def _keyed(topo):
    """``topo`` with mid's declared key map (+17): the static schedule."""
    topo.operators[1].jit_key_map = lambda k: k + 17
    return topo


@pytest.mark.parametrize("route", ["device", "static"], ids=str)
def test_run_supersteps_matches_reference_and_classic(route):
    """Both routing modes: the body's own routing (no key map) and the
    schedule staged from the declared ``jit_key_map`` — against the
    reference's scan and the port's classic ``.jit()`` engine."""
    K = 14
    batches = _batches(K)
    static = route == "static"
    ref = _engine(ref_engine, True, topo=_keyed(make_pipeline_topo()) if static else None)
    port = _engine(port_engine, True, topo=_keyed(port_pipeline_topo()) if static else None)
    assert ss.plan_chain(port).static_route == static
    for eng in (ref, port):
        _scan(eng, batches)
    jit = _engine(port_engine, False)
    for k, v, t in batches:
        jit.push_source("src", k, v, t)
        jit.tick()
    _drain(jit)
    assert port.metrics.sink_outputs == jit.metrics.sink_outputs
    _assert_same(ref, port, jit)


@pytest.mark.parametrize("route", ["device", "static"], ids=str)
def test_run_supersteps_usage_exact_under_odd_costs(route):
    """Non-dyadic operator and serialization costs: the scan's usage fold
    (per-tuple adds in the reference) stays bit-identical."""

    def costly(topo):
        for op, c in zip(topo.operators, (0.7, 1.3, 0.1)):
            op.cost_per_tuple = c
        return _keyed(topo) if route == "static" else topo

    batches = _batches(9, seed=11)
    ref = _engine(ref_engine, True, topo=costly(make_pipeline_topo()), ser_cost=0.3)
    port = _engine(port_engine, True, topo=costly(port_pipeline_topo()), ser_cost=0.3)
    for eng in (ref, port):
        _scan(eng, batches)
    _assert_same(ref, port)


def test_run_supersteps_guards():
    eng = _engine(port_engine, False)
    with pytest.raises(RuntimeError, match="superstep=True"):
        eng.run_supersteps(_batches(2))
    eng = _engine(port_engine, True)
    k, v, t = _batches(1)[0]
    eng.push_source("src", k, v, t)
    with pytest.raises(RuntimeError, match="empty queues"):
        eng.run_supersteps(_batches(2))
    eng = _engine(port_engine, True, service_rate=100.0)  # a superstep cannot fit
    with pytest.raises(RuntimeError, match="backpressure"):
        eng.run_supersteps(_batches(2))
    eng = _engine(port_engine, True)
    eng.redirect(5, 2)
    with pytest.raises(RuntimeError, match="migration"):
        eng.run_supersteps(_batches(2))
    assert _engine(port_engine, True).run_supersteps([]) == 0


@pytest.mark.parametrize("route", ["device", "static"], ids=str)
def test_run_supersteps_then_migration_round_trip(route):
    """The scan's leftover pendings are real segments: a migration right
    after run_supersteps extracts and replays them like any queued work."""
    batches = _batches(8)
    static = route == "static"
    ref = _engine(ref_engine, True, topo=_keyed(make_pipeline_topo()) if static else None)
    port = _engine(port_engine, True, topo=_keyed(port_pipeline_topo()) if static else None)
    blobs = []
    for eng in (ref, port):
        eng.run_supersteps(batches)
        eng.redirect(5, 2)
        eng.tick()
        blobs.append(eng.serialize(5))
        eng.install(5, 2, blobs[-1])
        _drain(eng)
    assert blobs[0] == blobs[1]
    _assert_same(ref, port)


def test_scan_is_built_once_per_key_and_rebuilt_for_a_new_table():
    """First calls per (K, bucket, collect, router version) count as
    compiles, as the reference's traces; a migration moves the version and
    drops the older scan."""
    def batches(seed):
        rng = np.random.default_rng(seed)
        return [(rng.integers(0, 10_000, size=100), rng.random(100), np.full(100, float(t)))
                for t in range(6)]

    eng = _engine(port_engine, True)
    rt = eng._superstep_rt()

    def scan_compiles(seed):
        before = eng.metrics.jit_compiles
        eng.run_supersteps(batches(seed))
        after = eng.metrics.jit_compiles
        _drain(eng)
        return after - before

    assert [scan_compiles(1), scan_compiles(2)] == [1, 0]
    assert len(rt._scan_cache) == 1
    eng.redirect(5, 2)
    eng.install(5, 2, eng.serialize(5))
    _drain(eng)
    assert scan_compiles(3) == 1
    assert len(rt._scan_cache) == 1 and rt.last_scan is next(iter(rt._scan_cache.values()))


# ---------------------------------------------------------------------------
# the benchmark's record pipeline (record columns, a counting sink)
# ---------------------------------------------------------------------------


_COUNT = StateSchema((StateField("n", "scalar", dtype=np.int64, py=int),))
_REC = np.dtype([("a", "i8"), ("b", "f8")])


def _count(state, kgs, starts, ends, keys, values, ts):
    return {"n": jx.count_runs(state["n"], kgs, starts, ends)}, None, None


def _port_stage(shift):
    def fn_jit(state, kgs, starts, ends, keys, values, ts):
        out = {"a": values["a"], "b": values["b"] + values["a"]}
        return {"n": jx.count_runs(state["n"], kgs, starts, ends)}, (keys + shift, out, ts), None

    return fn_jit


def _emitting_sink():
    """A record sink that emits ``keys * 2`` with the stages' record
    transform (numpy and torch bodies), so sink outputs are records."""

    def fn_seg(store, run_kgs, starts, ends, keys, values, ts):
        for kg, a, z in zip(run_kgs, starts, ends):
            store[kg]["n"] = store[kg].get("n", 0) + (z - a)
        out = np.empty(len(values), dtype=_REC)
        out["a"], out["b"] = values["a"], values["b"] + values["a"]
        return (keys * 2, out, ts), None

    def fn_jit(state, kgs, starts, ends, keys, values, ts):
        out = {"a": values["a"], "b": values["b"] + values["a"]}
        return {"n": jx.count_runs(state["n"], kgs, starts, ends)}, (keys * 2, out, ts), None

    return fn_seg, fn_jit


def port_record_pipeline(kgs, depth, *, key_map=True, emit=False):
    """``benchmarks.engine_throughput.make_record_pipeline_job`` on the
    port's classes: the benchmark's numpy bodies, torch ``fn_jit`` bodies
    and tensor key maps; ``emit`` puts an emitting record sink in place of
    the counting one."""
    from benchmarks import engine_throughput as bench

    schema = Schema.record([("a", "i8"), ("b", "f8")])
    t = Topology()
    t.add_operator(OperatorSpec("src", None, num_keygroups=kgs, is_source=True, schema=schema))
    prev = "src"
    for i in range(depth - 1):
        shift = 17 * (i + 1)
        fn, fn_seg, _, _ = bench._record_stage(shift)
        t.add_operator(OperatorSpec(
            f"stage{i}", fn, num_keygroups=kgs, fn_seg=fn_seg, fn_jit=_port_stage(shift),
            jit_fusible=True, jit_key_map=(lambda k, s=shift: k + s) if key_map else None,
            state_schema=_COUNT, schema=schema, out_schema=schema,
        ))
        t.connect(prev, f"stage{i}")
        prev = f"stage{i}"
    sink_seg, sink_jit = _emitting_sink() if emit else (bench._counting_sink_seg, _count)
    t.add_operator(OperatorSpec(
        "sink", bench._counting_sink, num_keygroups=kgs, is_sink=True,
        fn_seg=sink_seg, fn_jit=sink_jit, jit_fusible=True,
        state_schema=_COUNT, schema=schema, out_schema=schema if emit else None,
    ))
    t.connect(prev, "sink")
    return t


def _record_batches(K, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(K):
        values = np.empty(n, dtype=_REC)
        values["a"] = rng.integers(0, 1_000, size=n)
        values["b"] = rng.random(n)
        out.append((rng.integers(0, 1_000_000, size=n), values, np.full(n, float(t))))
    return out


@pytest.mark.parametrize("route", ["device", "static"], ids=str)
def test_record_pipeline_ticks_and_scan_match_reference(route):
    from benchmarks import engine_throughput as bench

    static = route == "static"
    batches = _record_batches(7, 300, seed=4)
    kw = dict(service_rate=1e12, seed=0, collect_sinks=False)

    def engines():
        ref_topo = bench.make_record_pipeline_job(num_keygroups=16, depth=4)
        if not static:
            for op in ref_topo.operators:
                op.jit_key_map = None
        assert ref_topo.operators[0].schema == RefSchema.record([("a", "i8"), ("b", "f8")])
        ref = ref_engine.Engine(ref_topo, 6, config=ref_engine.ExecutionConfig.superstep(), **kw)
        port = port_engine.Engine(
            port_record_pipeline(16, 4, key_map=static), 6,
            config=port_engine.ExecutionConfig.superstep(), device="cpu", **kw,
        )
        return ref, port

    # Fused ticks.
    ref, port = engines()
    for eng in (ref, port):
        for k, v, t in batches:
            eng.push_source("src", k, v, t)
            eng.tick()
        _drain(eng)
    assert port.metrics.processed_tuples == 5 * 7 * 300  # src, 3 stages, sink
    _assert_same(ref, port)
    # The scan, then a fused tick over its leftover pendings.
    ref, port = engines()
    assert ss.plan_chain(port).static_route == static
    for eng in (ref, port):
        _scan(eng, batches)
    _assert_same(ref, port)


@pytest.mark.parametrize("route", ["device", "static"], ids=str)
def test_record_sink_outputs_and_migration_match_jit(route):
    """Record columns end to end: an emitting record sink collected by fused
    ticks and by the scan, and a migration whose envelope carries record
    pendings flushed from the device, against the port's ``.jit()``
    engine."""
    batches = _record_batches(6, 200, seed=8)
    engines = [
        port_engine.Engine(
            port_record_pipeline(16, 3, key_map=route == "static", emit=True), 5,
            config=cfg, service_rate=1e12, seed=0, device="cpu",
        )
        for cfg in (port_engine.ExecutionConfig.superstep(), port_engine.ExecutionConfig.jit())
    ]
    blobs = []
    for eng in engines:
        for t, (k, v, ts) in enumerate(batches):
            if t == 2:
                eng.redirect(20, 1)  # a stage0 key group, pendings in flight
            eng.push_source("src", k, v, ts)
            eng.tick()
            if t == 3:
                blobs.append(eng.serialize(20))
                eng.install(20, 1, blobs[-1])
        _drain(eng)
        if eng.superstep:
            eng.run_supersteps(batches)
        else:
            for k, v, ts in batches:
                eng.push_source("src", k, v, ts)
                eng.tick()
        _drain(eng)
    ss, jit = engines
    assert blobs[0] == blobs[1]
    assert len(ss.metrics.sink_outputs) == 2 * 6 * 200
    assert ss.metrics.sink_outputs == jit.metrics.sink_outputs
    ra, rb = _result(ss), _result(jit)
    for field in ra:
        if field not in ("metrics", "kg_load", "kg_tuple_rate"):
            assert ra[field] == rb[field], field


# ---------------------------------------------------------------------------
# zero-fn_jit: a .superstep() engine must not import the jit tier
# ---------------------------------------------------------------------------

ZERO_FN_JIT = textwrap.dedent(
    """
    import sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None
    import numpy as np
    from repro_torch.engine import Engine, ExecutionConfig
    from repro_torch.engine.topology import OperatorSpec, Schema, Topology

    t = Topology()
    scalar = Schema(np.dtype(np.float64))
    t.add_operator(OperatorSpec("src", None, num_keygroups=4,
                                is_source=True, schema=scalar))

    def fn(state, keys, values, ts):
        state["n"] = state.get("n", 0) + len(keys)
        return state, (keys, values, ts)

    t.add_operator(OperatorSpec("snk", fn, num_keygroups=4, is_sink=True,
                                schema=scalar))
    t.connect("src", "snk")
    eng = Engine(t, 2, service_rate=1e9, seed=0, device="cpu",
                 config=ExecutionConfig.superstep())
    assert eng.superstep is False  # degraded: nothing to fuse
    eng.push_source("src", np.arange(8, dtype=np.int64), np.ones(8),
                    np.zeros(8))
    eng.tick()
    eng.tick()
    assert eng.metrics.sink_tuples == 8
    assert "repro_torch.engine.jitexec" not in sys.modules
    assert "repro_torch.engine.superstep" not in sys.modules
    print("ZERO-FN-JIT-OK")
    """
)


def test_superstep_with_zero_fn_jit_ops_skips_jit_setup():
    """``.superstep()`` over a topology with no fn_jit operator imports
    neither the jit tier nor the superstep runtime (subprocess: module
    import state is process-global), with jax unimportable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run(
        [sys.executable, "-c", ZERO_FN_JIT],
        capture_output=True,
        text=True,
        timeout=300,
        env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ZERO-FN-JIT-OK" in proc.stdout
