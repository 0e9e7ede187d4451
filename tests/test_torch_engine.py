"""The port's engine (``repro_torch``, on the CPU) against the reference's.

The same scenarios of ``tests/conformance.py`` — steady, random mid-run
migrations, and a binding service budget — drive the reference
``repro.engine.Engine`` (the production ``.typed()`` configuration) and the
port's ``Engine(device="cpu")`` in each of its configurations, on the
four real jobs.  Every field the conformance contract pins must be bit-identical:
tuple-flow metrics, sink outputs and their order, per-key-group state
(dict insertion order included), the folded SPL statistics, the routing
table, queue costs and the migration envelope bytes.  On the CPU the port
routes through its kernels' plain PyTorch versions, so this also holds the
partition/histogram and composite-sort wiring against the reference's numpy
routing.

The port's compiled tier (``ExecutionConfig.jit()``) is held to the same
fields, with the harness's documented float tolerance (rtol 1e-9 on floats
in sink outputs and states, and only there), against the reference's
``.typed()`` and ``.jit()`` engines; its jit counters equal the reference
``.jit()`` run's call for call.

Beyond the harness: cross-loading reference state into the port
(``load_reference_state``, also from a reference ``.jit()`` engine into a
port ``.jit()`` engine), and a 4-period ALBIC controller run whose
deterministic ``PeriodMetrics`` fields must match.
"""

import hashlib
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

from conformance import (
    JIT_FLOAT_ATOL,
    JIT_FLOAT_RTOL,
    METRIC_FIELDS,
    approx_equal,
    assert_equivalent,
    normalize,
    run_scenario,
)
from test_real_jobs_conformance import SCENARIOS

import repro.data.jobs as ref_jobs
import repro.data.synthetic as ref_synthetic
import repro.engine as ref_engine
from repro.core import AdaptationFramework as RefFramework
from repro.core import AlbicParams as RefAlbicParams

# CI's tier-1 job installs no torch (repro_torch.engine imports it): skip
# this module there, not fail collection.
pytest.importorskip("torch")

import repro_torch.data.jobs as port_jobs
import repro_torch.data.synthetic as port_synthetic
import repro_torch.engine as port_engine
from repro_torch.core import AdaptationFramework as PortFramework
from repro_torch.core import AlbicParams as PortAlbicParams
from repro_torch.engine.serde import Envelope as PortEnvelope

_KGS = 12
JOBS = ("job1", "job2", "job3", "job4")
# Jobs whose flight-delay operators carry fn_jit (job 4 extends job 3): the
# compiled tier runs there and nowhere else (the reference's JIT_JOBS).
JIT_JOBS = {"job2", "job3", "job4"}
# The workers configuration sits before the jit ones, and the reference
# runs only ``.typed()`` in the test that drives them: its processes fork
# before any jax state exists in this process (tests/conformance.py's rule).
PORT_CONFIGS = {
    "typed": port_engine.ExecutionConfig.typed(),
    "seg": port_engine.ExecutionConfig.seg(),
    "oracle": port_engine.ExecutionConfig.oracle(),
    "workers": port_engine.ExecutionConfig.workers(2),
    "jit": port_engine.ExecutionConfig.jit(),
    "superstep": port_engine.ExecutionConfig.superstep(),
}


def _factories(jobs, synth, job, kgs=_KGS):
    """``tests/conformance.py``'s JOBS entries, built from one package."""
    topo = {
        "job1": lambda **kw: jobs.make_real_job_1(topk=3, window_ticks=4.0, **kw),
        "job2": jobs.real_job_2,
        "job3": jobs.real_job_3,
        "job4": jobs.real_job_4,
    }[job]
    spec = synth.StreamSpec

    def feeders():
        if job == "job1":
            return {"wiki": synth.wiki_edit_stream(spec(rate=90.0, seed=5))}
        feeds = {"airline": synth.airline_stream(spec(rate=90.0, seed=5))}
        if job == "job4":
            feeds["weather"] = synth.weather_stream(spec(rate=40.0, seed=5))
        return feeds

    return lambda: topo(keygroups_per_op=kgs), feeders


def _ref_factories(job):
    return _factories(ref_jobs, ref_synthetic, job)


def _port_factories(job):
    return _factories(port_jobs, port_synthetic, job)


def run_port_scenario(topo_factory, feeder_factory, scenario, config):
    """``conformance.run_scenario``'s drive, on the port's CPU engine
    (``make_engine``: the multi-worker runtime under ``.workers(n)``, its
    pool bounded by a 60 s deadline)."""
    topo = topo_factory()
    eng = port_engine.make_engine(
        topo,
        scenario.num_nodes,
        config=config,
        service_rate=scenario.service_rate,
        seed=scenario.seed,
        device="cpu",
        **({"timeout": 60.0} if config.num_workers > 1 else {}),
    )
    feeds = feeder_factory()
    rng = np.random.default_rng(scenario.seed + 1)
    in_flight = []
    migration_blobs = []
    for t in range(scenario.ticks):
        if t in scenario.migrate_at:
            kg = int(rng.integers(0, topo.num_keygroups))
            dst = int(rng.integers(0, eng.num_nodes))
            if not eng.router.is_in_flight(kg):
                eng.redirect(kg, dst)
                in_flight.append((t, kg, dst))
        for op, it in feeds.items():
            keys, values, ts = next(it)
            eng.push_source(op, keys, values, ts)
        eng.tick()
        for item in list(in_flight):
            t0, kg, dst = item
            if t >= t0 + 1:
                blob = eng.serialize(kg)
                migration_blobs.append(hashlib.sha256(blob).hexdigest())
                eng.install(kg, dst, blob)
                in_flight.remove(item)
    for _ in range(scenario.drain_ticks):
        eng.tick()
    snap = eng.end_period()
    eng.finalize()
    result = {
        "metrics": {m: getattr(eng.metrics, m) for m in METRIC_FIELDS},
        "sink_outputs": normalize(eng.metrics.sink_outputs),
        "states": [normalize(s) for _, s in eng.store.items()],
        "kg_load": snap.kg_load.tolist(),
        "kg_tuple_rate": snap.kg_tuple_rate.tolist(),
        "kg_state_bytes": snap.kg_state_bytes.tolist(),
        "pair_src": snap.out_pairs.src.tolist(),
        "pair_dst": snap.out_pairs.dst.tolist(),
        "pair_rate": snap.out_pairs.rate.tolist(),
        "alloc": eng.router.table.tolist(),
        "queue_costs": eng.queue_costs(),
        "migration_blobs": migration_blobs,
        "seg_calls": eng.metrics.seg_calls,
        "seg_tuples": eng.metrics.seg_tuples,
        "typed_batches": eng.metrics.typed_batches,
        "jit_calls": eng.metrics.jit_calls,
        "jit_compiles": eng.metrics.jit_compiles,
        "jit_host_syncs": eng.metrics.jit_host_syncs,
    }
    return result, eng


@pytest.mark.parametrize("config", list(PORT_CONFIGS), ids=str)
@pytest.mark.parametrize("scenario", list(SCENARIOS), ids=str)
@pytest.mark.parametrize("job", JOBS, ids=str)
def test_port_engine_matches_reference(job, scenario, config):
    ref = run_scenario(
        *_ref_factories(job), SCENARIOS[scenario], ref_engine.ExecutionConfig.typed()
    )
    cfg = PORT_CONFIGS[config]
    if cfg.num_workers > 1:
        # serde interns one typed-batch header per dtype triple and process,
        # pickled from the first dtype objects it meets: a pool forked before
        # any encode interns headers of dtypes unpickled from the command
        # queue, whose sub-dtypes are not numpy's shared singletons, so the
        # header bytes differ (the reference's property: ROADMAP queue 3,
        # item 2).  The single-process engine runs first, as in
        # tests/test_torch_cluster.py, and the pool inherits its headers.
        run_port_scenario(*_port_factories(job), SCENARIOS[scenario], PORT_CONFIGS["typed"])
    port, eng = run_port_scenario(*_port_factories(job), SCENARIOS[scenario], cfg)
    # assert_equivalent pins envelope bytes only between configurations of
    # the same edge encoding (names carrying "schema"), as the reference's.
    assert_equivalent({"ref:soa+seg+schema": ref, f"port:{cfg.name}": port})
    assert port["metrics"]["sink_tuples"] > 0
    if scenario == "migrate":
        assert port["migration_blobs"]
    if cfg.use_fn_jit:
        assert (port["jit_calls"] > 0) == (job in JIT_JOBS)
    if config == "superstep":
        # No operator of the real jobs is jit_fusible (and job 4 has two
        # sources): nothing fuses, and the engine is the .jit() engine,
        # counters included.
        jit, _ = run_port_scenario(
            *_port_factories(job), SCENARIOS[scenario], PORT_CONFIGS["jit"]
        )
        assert port == jit
        if job in JIT_JOBS:
            assert eng._superstep is not None and eng._superstep.plan is None
        else:  # no fn_jit operator: the superstep flag is a no-op
            assert not eng.superstep and eng._superstep is None
    # Routed hops went through the kernels (plain versions here): every
    # hop outside chip_smoke.HOST_HASHED (those whose partition key is not
    # an integer, hashed on the host in both packages) partitions by an
    # integer key — those keyed by
    # a column expression (routedelay, rainscore, efficiency) only on
    # schema-typed batches; on object edges they hash on the host, as the
    # reference does.  A multi-worker shard partitions each exchanged hop
    # twice (split by owner, then routed), and the coordinator folds every
    # worker's counters.
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import HOST_HASHED

    m = eng.metrics
    ops = eng.topology.operators
    assert set(m.routed_batches) == set(range(len(ops)))
    expect = {
        op: n + m.exchange_split_batches.get(op, 0)
        for op, n in m.routed_batches.items()
        if ops[op].name not in HOST_HASHED.get(job, ())
        and (cfg.use_schema or ops[op].key_by_value is None)
    }
    assert bool(m.exchange_split_batches) == (cfg.num_workers > 1)
    assert m.partition_kernel_batches == expect
    assert 0 < sum(m.sort_kernel_batches.values()) <= sum(m.routed_batches.values())
    assert m.host_device_copies > 0


@pytest.mark.parametrize("scenario", list(SCENARIOS), ids=str)
@pytest.mark.parametrize("job", JOBS, ids=str)
def test_port_jit_counters_match_reference_jit(job, scenario):
    """The port's ``.jit()`` engine against the reference's ``.jit()``: every
    pinned field (floats at the jit tolerance) and the compiled tier's
    counters — calls, first calls per padding bucket (the reference's
    compiles) and host syncs — equal, call for call."""
    cfg = ref_engine.ExecutionConfig.jit()
    ref = run_scenario(*_ref_factories(job), SCENARIOS[scenario], cfg)
    port, _ = run_port_scenario(
        *_port_factories(job), SCENARIOS[scenario], port_engine.ExecutionConfig.jit()
    )
    assert_equivalent({f"ref:{cfg.name}": ref, f"port:{cfg.name}": port})
    assert (port["jit_calls"] > 0) == (job in JIT_JOBS)
    for field in ("jit_calls", "jit_compiles", "jit_host_syncs", "seg_calls", "seg_tuples"):
        assert port[field] == ref[field], field


def _drive(eng, feeds, ticks, drain):
    for _ in range(ticks):
        for op, it in feeds.items():
            keys, values, ts = next(it)
            eng.push_source(op, keys, values, ts)
        eng.tick()
    for _ in range(drain):
        eng.tick()


@pytest.mark.parametrize("queued", [False, True], ids=["drained", "backlog"])
@pytest.mark.parametrize("job", ("job2", "job3", "job4"), ids=str)
def test_load_reference_state_continues_identically(job, queued):
    """Reference state (routing table + every key group's envelope) installs
    into a fresh port engine, and both continue bit-identically.

    ``drained``: the reference's queues are empty and each envelope is a
    standalone export (state only).  ``backlog``: one more batch is left
    queued, and every key group is migrated in place on the reference
    (redirect → serialize → install), so each envelope also ships its queued
    runs, which the port replays into the same queues.  Job 4 is six hops
    deep, so it drains for six ticks.  Job 1 is not here: its geohash hop
    costs 1.2 a tuple, and the reference's running queue costs keep the
    float residue of every add and subtract (1.4e-14 on a drained node),
    which a queue rebuilt from the envelopes does not carry.
    """
    drain = 6 if job == "job4" else 4
    ref_topo, ref_feeds = _ref_factories(job)
    port_topo, port_feeds = _port_factories(job)
    ref = ref_engine.Engine(ref_topo(), 4, service_rate=1e9, seed=0)
    feeds = ref_feeds()
    _drive(ref, feeds, ticks=6, drain=drain)
    consumed = 6
    g = ref.topology.num_keygroups
    if queued:
        _drive(ref, feeds, ticks=1, drain=0)
        consumed += 1
        blobs = {}
        for kg in range(g):
            node = ref.router.node_of(kg)
            ref.redirect(kg, node)
            blobs[kg] = ref.serialize(kg)
            ref.install(kg, node, blobs[kg])
        assert any(ref.queue_costs())
    else:
        blobs = {kg: ref.export_keygroup(kg).blob for kg in range(g)}
    ref.end_period()  # both windows start the continuation empty
    port = port_engine.Engine(port_topo(), 4, service_rate=1e9, seed=7, device="cpu")
    port.load_reference_state(ref.router.table.copy(), blobs)
    assert port.router.table.tolist() == ref.router.table.tolist()
    assert port.queue_costs() == ref.queue_costs()
    if not queued:
        # The port re-exports byte-identical envelopes.
        for kg in range(g):
            assert port.export_keygroup(kg).blob == blobs[kg], kg
    # Continue both on the same traffic; the port's feeder is fast-forwarded
    # past the batches the reference consumed.
    port_it = port_feeds()
    for _ in range(consumed):
        for it in port_it.values():
            next(it)
    n_sink = len(ref.metrics.sink_outputs)
    _drive(ref, feeds, ticks=5, drain=drain)
    _drive(port, port_it, ticks=5, drain=drain)
    assert normalize(port.metrics.sink_outputs) == normalize(
        ref.metrics.sink_outputs[n_sink:]
    )
    for kg in range(g):
        assert normalize(port.store.get(kg)) == normalize(ref.store.get(kg)), kg
    s_ref, s_port = ref.end_period(), port.end_period()
    assert s_port.kg_load.tolist() == s_ref.kg_load.tolist()
    assert s_port.kg_tuple_rate.tolist() == s_ref.kg_tuple_rate.tolist()
    assert s_port.kg_state_bytes.tolist() == s_ref.kg_state_bytes.tolist()
    assert s_port.out_pairs.rate.tolist() == s_ref.out_pairs.rate.tolist()


def test_reference_classes_in_blobs_resolve_to_port_copies():
    """A state pickle naming a ``repro.*`` class installs as the port's copy."""
    state = {"env": ref_engine.Envelope(3, b"xyz"), "n": 1}
    blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    port = port_engine.Engine(
        port_jobs.real_job_2(keygroups_per_op=4), 2, seed=0, device="cpu"
    )
    port.load_reference_state(port.router.table.copy(), {5: blob})
    got = port.store.get(5)
    assert type(got["env"]) is PortEnvelope
    assert got["env"] == PortEnvelope(3, b"xyz") and got["n"] == 1


def _build(job, eng_mod, jobs, synth, kgs, nodes, seed, *, device=None):
    """``benchmarks/real_jobs.py``'s ``build``: anti-collocated start,
    ser_cost 0.6, service_rate 3000; job 1 with its short TopK windows, job
    4's weather at a quarter of the airline rate."""
    topo_fn = _factories(jobs, synth, job, kgs)[0]
    topo = topo_fn()
    g = topo.num_keygroups
    alloc = np.zeros(g, dtype=np.int64)
    for op in range(topo.num_operators):
        base = topo.kg_base(op)
        n_op = topo.operators[op].num_keygroups
        alloc[base : base + n_op] = (np.arange(n_op) + op * (nodes // 2 + 1)) % nodes
    kw = {} if device is None else {"device": device}
    eng = eng_mod.Engine(
        topo,
        nodes,
        initial_alloc=alloc,
        ser_cost=0.6,
        service_rate=3000.0,
        seed=seed,
        collect_sinks=False,
        **kw,
    )
    rates = {"wiki": 220.0} if job == "job1" else {"airline": 220.0}
    if job == "job4":
        rates["weather"] = 55.0
    make = {
        "wiki": synth.wiki_edit_stream,
        "airline": synth.airline_stream,
        "weather": synth.weather_stream,
    }
    streams = {
        op: make[op](synth.StreamSpec(rate=rate, seed=seed)) for op, rate in rates.items()
    }

    def feeder(engine, tick):
        for op, it in streams.items():
            k, v, ts = next(it)
            engine.push_source(op, k, v, ts)

    return eng, feeder


_DETERMINISTIC_FIELDS = (
    "period",
    "load_distance",
    "collocation_factor",
    "system_load",
    "load_index",
    "num_migrations",
    "migration_cost",
    "latency",
    "num_nodes_alive",
    "scaling_added",
    "scaling_marked",
)


@pytest.mark.parametrize("job", JOBS, ids=str)
def test_albic_controller_matches_reference(job):
    """Four SPL periods of Algorithm 1 with ALBIC (the real-jobs benchmark
    setup, small): identical statistics → identical plans → identical
    deterministic period metrics, routing and state.  At this size every
    MILP solve proves optimality in well under a second, far inside the
    time limit, so no solve is cut and the plans are deterministic."""
    # Job 4's ten operators at 4 key groups each make MILPs that run into
    # the time limit; at 2 each they still prove optimality quickly.
    kgs, nodes, ticks, seed = (2 if job == "job4" else 4), 3, 6, 3
    runs = {}
    for label, eng_mod, jobs, synth, fw, params, dev in (
        ("ref", ref_engine, ref_jobs, ref_synthetic, RefFramework, RefAlbicParams, None),
        (
            "port",
            port_engine,
            port_jobs,
            port_synthetic,
            PortFramework,
            PortAlbicParams,
            "cpu",
        ),
    ):
        eng, feeder = _build(job, eng_mod, jobs, synth, kgs, nodes, seed, device=dev)
        ctl = eng_mod.Controller(
            eng,
            fw(
                mode="albic",
                max_migrations=10,
                albic_params=params(max_ld=15.0, time_limit=60.0),
            ),
            eng_mod.ControllerConfig(ticks_per_period=ticks),
            feeder=feeder,
        )
        for _ in range(4):
            ctl.period()
        runs[label] = (ctl, eng)
    (rc, re_), (pc, pe) = runs["ref"], runs["port"]
    assert sum(m.num_migrations for m in rc.history) > 0
    for a, b in zip(rc.history, pc.history):
        for f in _DETERMINISTIC_FIELDS:
            assert getattr(b, f) == getattr(a, f), (a.period, f)
    assert pe.router.table.tolist() == re_.router.table.tolist()
    for kg in range(re_.topology.num_keygroups):
        assert normalize(pe.store.get(kg)) == normalize(re_.store.get(kg)), kg


def _close(a, b) -> bool:
    return approx_equal(normalize(a), normalize(b), JIT_FLOAT_RTOL, JIT_FLOAT_ATOL)


@pytest.mark.parametrize("queued", [False, True], ids=["drained", "backlog"])
def test_load_reference_jit_state_continues_identically(queued):
    """A reference ``.jit()`` engine's state — its device columns
    materialized (``sync_store`` at ``end_period``, ``ensure_dict`` in each
    export) — installs into a port ``.jit()`` engine, whose columns are then
    rebuilt from the installed dicts; both continue alike (floats at the jit
    tolerance, everything else exact)."""
    ref_topo, ref_feeds = _ref_factories("job3")
    port_topo, port_feeds = _port_factories("job3")
    ref = ref_engine.Engine(
        ref_topo(), 4, service_rate=1e9, seed=0, config=ref_engine.ExecutionConfig.jit()
    )
    feeds = ref_feeds()
    _drive(ref, feeds, ticks=6, drain=4)
    consumed = 6
    g = ref.topology.num_keygroups
    if queued:
        _drive(ref, feeds, ticks=1, drain=0)
        consumed += 1
        blobs = {}
        for kg in range(g):
            node = ref.router.node_of(kg)
            ref.redirect(kg, node)
            blobs[kg] = ref.serialize(kg)
            ref.install(kg, node, blobs[kg])
        assert any(ref.queue_costs())
    else:
        blobs = {kg: ref.export_keygroup(kg).blob for kg in range(g)}
    ref.end_period()
    assert ref.metrics.jit_calls > 0
    port = port_engine.Engine(
        port_topo(), 4, service_rate=1e9, seed=7, device="cpu",
        config=port_engine.ExecutionConfig.jit(),
    )
    port.load_reference_state(ref.router.table.copy(), blobs)
    assert port.queue_costs() == ref.queue_costs()
    port_it = port_feeds()
    for _ in range(consumed):
        for it in port_it.values():
            next(it)
    n_sink = len(ref.metrics.sink_outputs)
    _drive(ref, feeds, ticks=5, drain=4)
    _drive(port, port_it, ticks=5, drain=4)
    s_ref, s_port = ref.end_period(), port.end_period()
    assert port.metrics.jit_calls > 0
    assert _close(port.metrics.sink_outputs, ref.metrics.sink_outputs[n_sink:])
    for kg in range(g):
        assert _close(port.store.get(kg), ref.store.get(kg)), kg
    assert s_port.kg_load.tolist() == s_ref.kg_load.tolist()
    assert s_port.kg_tuple_rate.tolist() == s_ref.kg_tuple_rate.tolist()
    assert s_port.kg_state_bytes.tolist() == s_ref.kg_state_bytes.tolist()
    assert s_port.out_pairs.rate.tolist() == s_ref.out_pairs.rate.tolist()
