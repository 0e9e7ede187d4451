"""The port's multi-worker runtime (``repro_torch.engine.cluster``, workers
on the CPU) against the reference's, field by field.

Mirrors ``tests/test_cluster.py`` and ``tests/test_cluster_faults.py``: the
port's :class:`ClusterEngine` and the reference's run on the same seeded
batches and must agree on every field the conformance contract pins (sink
outputs and their order, states, statistics, routing, queue costs,
migration envelope bytes, exchange transport counts); the port's cluster is
also held to the port's single-process engine under the ``+workers``
contract (``tests/conformance.py``: exact but ``kg_load`` and
``pair_rate`` at rtol 1e-12, atol 1e-18).  Beyond them: a pool forked from
a process whose torch thread pool ran still finishes (workers call
``torch.set_num_threads(1)`` first); a worker that cannot reach its device
fails the run with its traceback (no CPU fallback); ``device="cuda"`` is
refused before any fork once CUDA is initialized; the port's routing
counters are folded from every worker; and the leak checks look at the
pool's own shared-memory segments, whose prefix is the port's, never the
reference's ``repro_xchg`` (the reference's suites scan for theirs).

Every pool gets a deadline (``timeout=``), and forks before any jax state
exists in this process (nothing here imports jax).
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os

import numpy as np
import pytest

from conformance import (
    METRIC_FIELDS,
    Scenario,
    _pipeline_feeders,
    assert_equivalent,
    make_pipeline_topo,
    normalize,
    run_scenario,
)
from test_real_jobs_conformance import SCENARIOS

torch = pytest.importorskip("torch")

import repro.data.jobs as ref_jobs  # noqa: E402
import repro.data.synthetic as ref_synthetic  # noqa: E402
import repro.engine as ref_engine  # noqa: E402
from repro.engine import cluster as ref_cluster  # noqa: E402
from repro.engine.shmx import SEGMENT_PREFIX as REF_PREFIX  # noqa: E402

import repro_torch.data.jobs as port_jobs  # noqa: E402
import repro_torch.data.synthetic as port_synthetic  # noqa: E402
import repro_torch.engine as port_engine  # noqa: E402
from repro_torch.engine import cluster as port_cluster  # noqa: E402
from repro_torch.engine.shmx import SEGMENT_PREFIX  # noqa: E402
from repro_torch.engine.topology import OperatorSpec, Schema, Topology  # noqa: E402

KGS = 8
#: Every pool's deadline (seconds a coordinator or worker wait may stall).
TIMEOUT = 60.0
PortConfig = port_engine.ExecutionConfig
RefConfig = ref_engine.ExecutionConfig


def port_pipeline_topo(kgs: int = 16) -> Topology:
    """``conformance.make_pipeline_topo`` on the port's classes (the numpy
    tiers only: the multi-worker runtime runs no ``fn_jit``)."""
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
    t.add_operator(OperatorSpec("mid", mid_fn, num_keygroups=kgs, fn_seg=mid_seg,
                                schema=scalar, out_schema=scalar))
    t.add_operator(OperatorSpec("sink", sink_fn, num_keygroups=kgs, is_sink=True,
                                fn_seg=sink_seg, schema=scalar, out_schema=scalar))
    t.connect("src", "mid")
    t.connect("mid", "sink")
    return t


def _airline(synth):
    return lambda: {"airline": synth.airline_stream(synth.StreamSpec(rate=90.0, seed=5))}


#: job → (reference factories, port factories): the same seeded feeds.
JOBS = {
    "job3": (
        (lambda: ref_jobs.real_job_3(keygroups_per_op=12), _airline(ref_synthetic)),
        (lambda: port_jobs.real_job_3(keygroups_per_op=12), _airline(port_synthetic)),
    ),
    "pipeline": (
        (lambda: make_pipeline_topo(12), _pipeline_feeders),
        (lambda: port_pipeline_topo(12), _pipeline_feeders),
    ),
}


def port_cluster_engine(num_workers=2, num_nodes=4, service_rate=1e9, seed=0, shm=None,
                        device="cpu", timeout=TIMEOUT, **kw):
    cfg = PortConfig.workers(num_workers) if shm is None else PortConfig.workers(
        num_workers, shm=shm)
    return port_engine.make_engine(
        port_pipeline_topo(KGS), num_nodes, config=cfg, service_rate=service_rate,
        seed=seed, device=device, timeout=timeout, **kw)


def ref_cluster_engine(num_workers=2, num_nodes=4, service_rate=1e9, seed=0, **kw):
    """The reference's cluster, always on its queue transport: its shm lanes
    would be ``repro_xchg`` segments, which the reference's own leak checks
    (in other test processes) must never see."""
    cfg = RefConfig.workers(num_workers, shm=0)
    return ref_engine.make_engine(
        make_pipeline_topo(KGS), num_nodes, config=cfg, service_rate=service_rate,
        seed=seed, timeout=TIMEOUT, **kw)


def port_single(num_nodes=4, service_rate=1e9, seed=0):
    return port_engine.Engine(port_pipeline_topo(KGS), num_nodes, config=PortConfig.typed(),
                              service_rate=service_rate, seed=seed, device="cpu")


def run_port(topo_factory, feeder_factory, scenario, config):
    """``conformance.run_scenario``'s drive and result on the port's
    ``make_engine`` (CPU); also returns the engine."""
    topo = topo_factory()
    eng = port_engine.make_engine(
        topo, scenario.num_nodes, config=config, service_rate=scenario.service_rate,
        seed=scenario.seed, device="cpu",
        **({"timeout": TIMEOUT} if config.num_workers > 1 else {}))
    feeds = feeder_factory()
    rng = np.random.default_rng(scenario.seed + 1)
    in_flight, blobs = [], []
    for t in range(scenario.ticks):
        if t in scenario.migrate_at:
            kg = int(rng.integers(0, topo.num_keygroups))
            dst = int(rng.integers(0, eng.num_nodes))
            if not eng.router.is_in_flight(kg):
                eng.redirect(kg, dst)
                in_flight.append((t, kg, dst))
        for op, it in feeds.items():
            eng.push_source(op, *next(it))
        eng.tick()
        for item in list(in_flight):
            t0, kg, dst = item
            if t >= t0 + 1:
                blob = eng.serialize(kg)
                blobs.append(hashlib.sha256(blob).hexdigest())
                eng.install(kg, dst, blob)
                in_flight.remove(item)
    for _ in range(scenario.drain_ticks):
        eng.tick()
    snap = eng.end_period()
    eng.finalize()
    m = eng.metrics
    return {
        "metrics": {f: getattr(m, f) for f in METRIC_FIELDS},
        "sink_outputs": normalize(m.sink_outputs),
        "states": [normalize(s) for _, s in eng.store.items()],
        "kg_load": snap.kg_load.tolist(),
        "kg_tuple_rate": snap.kg_tuple_rate.tolist(),
        "kg_state_bytes": snap.kg_state_bytes.tolist(),
        "pair_src": snap.out_pairs.src.tolist(),
        "pair_dst": snap.out_pairs.dst.tolist(),
        "pair_rate": snap.out_pairs.rate.tolist(),
        "alloc": eng.router.table.tolist(),
        "queue_costs": eng.queue_costs(),
        "migration_blobs": blobs,
        "seg_calls": m.seg_calls,
        "seg_tuples": m.seg_tuples,
        "typed_batches": m.typed_batches,
        "jit_calls": m.jit_calls,
        "jit_compiles": m.jit_compiles,
        "jit_host_syncs": m.jit_host_syncs,
    }, eng


def _assert_routing_folded(eng, num_workers):
    """Every worker's routing counters reached the coordinator: each hop's
    batches partitioned twice (split by owner, then routed), the plain
    versions' host↔device copies counted, one lifetime per worker."""
    m = eng.metrics
    ops = range(len(eng.topology.operators))
    assert set(m.routed_batches) == set(ops)
    for op in ops:
        assert m.partition_kernel_batches[op] == (
            m.routed_batches[op] + m.exchange_split_batches.get(op, 0)), op
    assert sum(m.exchange_split_batches.values()) > 0
    assert 0 < sum(m.sort_kernel_batches.values()) <= sum(m.routed_batches.values())
    assert m.host_device_copies > 0 and m.host_device_bytes > 0
    lives = eng.worker_stats
    assert sorted(life["worker"] for life in lives) == list(range(num_workers))
    assert sum(life["metrics"]["host_device_copies"] for life in lives) == m.host_device_copies
    # The plain versions launch nothing: the wrappers count only kernels.
    assert eng.kernel_launches == dict.fromkeys(eng.kernel_launches, 0)


# ---------------------------------------------------------------------------
# tests/test_cluster.py
# ---------------------------------------------------------------------------


def test_contiguous_node_worker_matches_reference():
    for n, w in [(4, 2), (5, 2), (4, 3), (7, 3), (2, 2), (16, 4)]:
        owners = port_cluster.contiguous_node_worker(n, w)
        assert np.array_equal(owners, ref_cluster.contiguous_node_worker(n, w))
        assert (np.diff(owners) >= 0).all()
        counts = np.bincount(owners, minlength=w)
        assert counts.min() >= 1 and counts.max() - counts.min() <= 1


def test_worker_rng_streams_match_reference():
    for seed, wid in [(3, 0), (3, 1), (4, 0)]:
        assert np.array_equal(
            port_cluster.worker_rng(seed, wid).random(4),
            ref_cluster.worker_rng(seed, wid).random(4),
        )
    assert not np.array_equal(
        port_cluster.worker_rng(3, 0).random(4), port_cluster.worker_rng(3, 1).random(4))


@pytest.mark.parametrize("scenario", list(SCENARIOS), ids=str)
@pytest.mark.parametrize("job", list(JOBS), ids=str)
def test_port_cluster_matches_reference_cluster_and_port_engine(job, scenario):
    """On the queue transport (the one the reference runs here, see
    ``ref_cluster_engine``) and on the shm lanes the port's cluster equals
    the reference's cluster in every field, bit for bit, and holds the
    ``+workers`` contract against the port's single-process engine —
    envelope bytes included.  The one exception is the reference's own: on
    its queue transport the pressure scenario's envelope differs in bytes
    from its single-process engine's (the arrays inside are equal), so the
    envelope field is held to the port's single-process engine."""
    (ref_f, port_f) = JOBS[job]
    sc = SCENARIOS[scenario]
    ref = run_scenario(*ref_f, sc, RefConfig.workers(2, shm=0))
    single, _ = run_port(*port_f, sc, PortConfig.typed())
    for shm in (0, None):
        cfg = PortConfig.workers(2) if shm is None else PortConfig.workers(2, shm=shm)
        port, eng = run_port(*port_f, sc, cfg)
        assert {k: v for k, v in port.items() if k != "migration_blobs"} == {
            k: v for k, v in ref.items() if k != "migration_blobs"}  # bit for bit
        assert_equivalent({"port:soa+seg+schema": single, "port:soa+seg+schema+workers": port})
    assert port["metrics"]["sink_tuples"] > 0
    if scenario != "steady":
        assert port["migration_blobs"]
    _assert_routing_folded(eng, 2)


def test_three_workers_uneven_split_matches_reference():
    scenario = Scenario("uneven", ticks=10, drain_ticks=8, migrate_at=(3, 6))
    ref = run_scenario(make_pipeline_topo, _pipeline_feeders, scenario,
                       RefConfig.workers(3, shm=0))
    queued, _ = run_port(port_pipeline_topo, _pipeline_feeders, scenario,
                         PortConfig.workers(3, shm=0))
    assert queued == ref  # field by field, bit for bit
    port, eng = run_port(port_pipeline_topo, _pipeline_feeders, scenario, PortConfig.workers(3))
    single, _ = run_port(port_pipeline_topo, _pipeline_feeders, scenario, PortConfig.typed())
    assert_equivalent({"port:soa+seg+schema": single, "port:soa+seg+schema+workers": port})
    assert port["migration_blobs"]
    _assert_routing_folded(eng, 3)


def _push(eng, n, seed, key_space=5_000):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_space, size=n).astype(np.int64)
    return eng.push_source("src", keys, rng.random(n), np.zeros(n))


def _drain(eng, max_ticks=60):
    for _ in range(max_ticks):
        if eng.worst_queue_cost() == 0.0:
            return
        eng.tick()
    raise AssertionError("cluster failed to quiesce")


def test_same_seed_reproduces_run_exactly():
    def drive(make, seed):
        with make(seed=seed) as eng:
            alloc = eng.router.table.copy()
            for t in range(5):
                _push(eng, 200, seed=100 + t)
                eng.tick()
            _drain(eng)
            eng.finalize()
            return alloc, eng.metrics.sink_outputs, eng.metrics.sink_tuples

    a0, s0, n0 = drive(port_cluster_engine, seed=7)
    a1, s1, n1 = drive(port_cluster_engine, seed=7)
    assert np.array_equal(a0, a1) and s0 == s1 and n0 == n1
    a2, _, _ = drive(port_cluster_engine, seed=8)
    assert not np.array_equal(a0, a2)
    r0, rs0, rn0 = drive(ref_cluster_engine, seed=7)
    assert np.array_equal(a0, r0) and s0 == rs0 and n0 == rn0


def _batches(n_batches, size=150, seed=11, key_space=5_000):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, key_space, size=size).astype(np.int64), rng.random(size),
         np.full(size, float(t)))
        for t in range(n_batches)
    ]


def test_run_stream_matches_lockstep_ticks_and_reference():
    batches = _batches(10)
    with port_cluster_engine() as piped:
        accepted_p = piped.run_stream("src", batches, window=4)
        _drain(piped)
        piped.finalize()
    with port_cluster_engine() as lock:
        accepted_l = 0
        for keys, values, ts in batches:
            accepted_l += lock.push_source("src", keys, values, ts)
            lock.tick()
        _drain(lock)
        lock.finalize()
    with ref_cluster_engine() as ref:
        accepted_r = ref.run_stream("src", batches, window=4)
        _drain(ref)
        ref.finalize()
    assert accepted_p == accepted_l == accepted_r == sum(len(b[0]) for b in batches)
    assert piped.metrics.sink_outputs == lock.metrics.sink_outputs == ref.metrics.sink_outputs
    assert [s for _, s in piped.store.items()] == [s for _, s in lock.store.items()]
    assert [s for _, s in piped.store.items()] == [s for _, s in ref.store.items()]


def test_run_stream_backpressure_conserves_tuples():
    batches = _batches(12, size=1000)
    with port_cluster_engine(service_rate=50.0) as eng:
        accepted = eng.run_stream("src", batches, window=3)
        _drain(eng, max_ticks=400)
        eng.finalize()
    assert 0 < accepted < sum(len(b[0]) for b in batches)
    assert eng.metrics.dropped_credits == sum(len(b[0]) for b in batches) - accepted
    assert eng.metrics.sink_tuples == accepted


def test_run_stream_shuffle_matches_reference():
    batches = _batches(8)

    def drive(make, seed):
        with make(seed=seed) as eng:
            accepted = eng.run_stream("src", batches, shuffle=True)
            _drain(eng)
            eng.finalize()
            return accepted, eng.metrics.sink_outputs

    acc0, sinks0 = drive(port_cluster_engine, seed=5)
    acc1, sinks1 = drive(port_cluster_engine, seed=5)
    accr, sinksr = drive(ref_cluster_engine, seed=5)
    assert acc0 == acc1 == accr == sum(len(b[0]) for b in batches)
    assert sinks0 == sinks1 == sinksr


def test_export_envelope_identical_to_reference():
    single = ref_engine.Engine(make_pipeline_topo(KGS), 4, config=RefConfig.typed(),
                               service_rate=1e9, seed=0)
    with port_cluster_engine() as cluster:
        assert np.array_equal(single.router.table, cluster.router.table)
        for t in range(4):
            _push(single, 200, seed=40 + t)
            _push(cluster, 200, seed=40 + t)
            single.tick()
            cluster.tick()
        base = single.topology.kg_base(1)
        for kg in range(base, base + KGS):
            env_s = single.export_keygroup(kg)
            env_c = cluster.export_keygroup(kg)
            assert env_c.version == env_s.version == 1
            assert env_c.keygroup == kg
            assert env_c.blob == env_s.blob  # byte-identical envelope


def test_import_keygroup_installs_across_workers():
    with port_cluster_engine() as eng:
        for t in range(4):
            _push(eng, 200, seed=60 + t)
            eng.tick()
        _drain(eng)
        base = eng.topology.kg_base(1)
        kg = next(k for k in range(base, base + KGS)
                  if eng.worker_of_node(eng.router.node_of(k)) == 0)
        dst = int(np.flatnonzero(eng.node_worker == 1)[0])
        eng.import_keygroup(eng.export_keygroup(kg), dst)
        assert eng.router.node_of(kg) == dst
        accepted2 = _push(eng, 200, seed=99)
        _drain(eng)
        eng.finalize()
    expected = 4 * 200 + accepted2
    assert eng.metrics.sink_tuples == expected
    assert sum(eng.store.get(k).get("n", 0) for k in range(base, base + KGS)) == expected


def test_add_nodes_stays_monotone_and_carries_traffic():
    with port_cluster_engine() as eng:
        accepted = _push(eng, 200, seed=1)
        _drain(eng)
        eng.add_nodes(2)
        assert eng.num_nodes == 6
        assert (np.diff(eng.node_worker) >= 0).all()
        assert (eng.node_worker[-2:] == eng.num_workers - 1).all()
        base = eng.topology.kg_base(1)
        eng.redirect(base, 5)
        eng.install(base, 5, eng.serialize(base))
        accepted2 = _push(eng, 200, seed=2)
        _drain(eng)
        eng.finalize()
    assert eng.metrics.sink_tuples == accepted + accepted2


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_engine_refuses_workers_config_and_make_engine_builds_a_cluster(pkg):
    """``Engine`` refuses ``ExecutionConfig.workers(n)`` in both packages
    (naming the cluster and ``make_engine``); ``make_engine`` still builds
    the multi-worker ``ClusterEngine`` for it."""
    if pkg == "ref":
        eng_mod, cluster_mod, topo, kw = ref_engine, ref_cluster, make_pipeline_topo, {}
        cfg = RefConfig.workers(2, shm=0)
    else:
        eng_mod, cluster_mod, topo, kw = port_engine, port_cluster, port_pipeline_topo, {
            "device": "cpu"}
        cfg = PortConfig.workers(2)
    with pytest.raises(ValueError, match=rf"{eng_mod.__name__}\.make_engine"):
        eng_mod.Engine(topo(KGS), 4, config=cfg, **kw)
    eng = eng_mod.make_engine(topo(KGS), 4, config=cfg, timeout=TIMEOUT, **kw)
    try:
        assert isinstance(eng, cluster_mod.ClusterEngine)
        assert eng.num_workers == 2
    finally:
        eng.close()
    single = eng_mod.make_engine(topo(KGS), 4, config=cfg.__class__.typed(), **kw)
    assert type(single) is eng_mod.Engine


def test_close_terminates_worker_processes():
    eng = port_cluster_engine()
    procs = list(eng.pool.processes)
    assert all(p.is_alive() for p in procs)
    _push(eng, 100, seed=3)
    eng.tick()
    eng.close()
    for p in procs:
        p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    eng.close()  # idempotent


def _run_matched(cluster, ticks=6, n=300):
    """Identical traffic through a 3-worker cluster and the port's
    single-process engine; returns both."""
    oracle = port_single()
    try:
        for t in range(ticks):
            rng = np.random.default_rng(70 + t)
            keys = rng.integers(0, 5_000, size=n).astype(np.int64)
            values, ts = rng.random(n), np.zeros(n)
            cluster.push_source("src", keys, values, ts)
            oracle.push_source("src", keys, values, ts)
            cluster.tick()
            oracle.tick()
        for _ in range(60):
            if cluster.worst_queue_cost() == 0.0 and not any(oracle.queue_costs()):
                break
            cluster.tick()
            oracle.tick()
        cluster.finalize()
    finally:
        cluster.close()
    return cluster, oracle


@pytest.mark.parametrize(
    "shm, transports",
    [(1 << 20, "shm"), (128, "mixed"), (0, "queue")],
    ids=["shm_lanes", "ring_full_overflow", "queue_only"],
)
def test_exchange_transports_bit_exact_and_counted_as_reference(shm, transports):
    """A 1 MiB ring carries the whole exchange, a 128-byte ring overflows
    every payload to the queue path (both transports per lane), no ring
    means the queue only — each bit-exact against the single-process engine
    and the reference's cluster, with one message per (tick, lane) as the
    reference's queue transport counts them, and every byte sent received."""
    cluster, oracle = _run_matched(port_cluster_engine(num_workers=3, shm=shm))
    ref, _ = _run_matched(ref_cluster_engine(num_workers=3))
    assert cluster.metrics.sink_outputs == oracle.metrics.sink_outputs
    assert ({kg: s for kg, s in cluster.store.items() if s}
            == {kg: s for kg, s in oracle.store.items() if s})
    assert cluster.metrics.sink_outputs == ref.metrics.sink_outputs
    xs, xr = cluster.exchange_stats, ref.exchange_stats
    assert xs["shm_msgs"] + xs["queue_msgs"] == xr["queue_msgs"] > 0
    assert xs["shm_bytes_out"] == xs["shm_bytes_in"]
    if transports == "shm":
        assert xs["shm_msgs"] > 0 and xs["queue_msgs"] == 0 and xs["shm_bytes_in"] > 0
    elif transports == "mixed":
        assert xs["shm_msgs"] > 0 and xs["queue_msgs"] > 0
    else:
        assert xs["shm_msgs"] == 0 and xs["queue_msgs"] > 0 and xs["shm_bytes_out"] == 0


# ---------------------------------------------------------------------------
# tests/test_cluster_faults.py
# ---------------------------------------------------------------------------


def _push_both(engines, n, seed, key_space=5_000):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_space, size=n).astype(np.int64)
    values, ts = rng.random(n), np.zeros(n)
    return [e.push_source("src", keys, values, ts) for e in engines]


def _drain_both(cluster, oracle, max_ticks=200):
    for _ in range(max_ticks):
        busy = cluster.worst_queue_cost() > 0.0
        busy |= any(oracle.queue_costs())
        if not busy:
            return
        cluster.tick()
        oracle.tick()
    raise AssertionError("failed to quiesce")


def _kill_between_ticks(cluster, oracle):
    """tests/test_cluster_faults.py's crash: stale checkpoints of worker 1's
    key groups, worker 1 killed, its key groups reinstalled on worker 0."""
    for t in range(6):
        _push_both((cluster, oracle), 300, seed=10 + t)
        cluster.tick()
        oracle.tick()
    doomed_nodes = np.flatnonzero(cluster.node_worker == 1)
    doomed_kgs = np.flatnonzero(np.isin(cluster.router.table, doomed_nodes))
    checkpoints = {}
    for kg in doomed_kgs.tolist():
        env_c = cluster.export_keygroup(kg)
        env_o = oracle.export_keygroup(kg)
        assert env_c.blob == env_o.blob and env_c.version == 1
        checkpoints[kg] = env_c
    for t in range(2):
        _push_both((cluster, oracle), 300, seed=20 + t)
        cluster.tick()
        oracle.tick()
    orphans = cluster.fail_worker(1)
    assert np.array_equal(orphans, doomed_kgs)
    for node in doomed_nodes.tolist():
        oracle.fail_node(node)
    assert np.array_equal(cluster.alive, oracle.alive)
    dst = int(np.flatnonzero(cluster.node_worker == 0)[0])
    for kg, env in checkpoints.items():
        cluster.import_keygroup(env, dst)
        oracle.router.table[kg] = dst
        oracle.router.version += 1
        oracle.import_keygroup(env, dst)
    for t in range(3):
        _push_both((cluster, oracle), 300, seed=30 + t)
        cluster.tick()
        oracle.tick()
    _drain_both(cluster, oracle)
    cluster.finalize()


def test_kill_between_ticks_recovers_like_reference_and_oracle():
    cluster = port_cluster_engine(service_rate=400.0)
    oracle = port_single(service_rate=400.0)
    try:
        _kill_between_ticks(cluster, oracle)
    finally:
        cluster.close()
    ref = ref_cluster_engine(service_rate=400.0)
    ref_oracle = ref_engine.Engine(make_pipeline_topo(KGS), 4, config=RefConfig.typed(),
                                   service_rate=400.0, seed=0)
    try:
        _kill_between_ticks(ref, ref_oracle)
    finally:
        ref.close()
    assert cluster.metrics.sink_outputs == oracle.metrics.sink_outputs
    assert cluster.metrics.sink_outputs == ref.metrics.sink_outputs
    c_states = {kg: s for kg, s in cluster.store.items() if s}
    assert c_states == {kg: s for kg, s in oracle.store.items() if s}
    assert c_states == {kg: s for kg, s in ref.store.items() if s}
    # The dead worker's last heartbeat is one of the folded lifetimes.
    assert [life["died"] for life in cluster.worker_stats].count(True) == 1
    for f in ("processed_tuples", "sink_tuples", "host_device_copies"):
        assert getattr(cluster.metrics, f) == sum(
            life["metrics"][f] for life in cluster.worker_stats), f


def test_kill_mid_tick_does_not_wedge_the_pool():
    cluster = port_cluster_engine()
    try:
        for t in range(3):
            rng = np.random.default_rng(50 + t)
            keys = rng.integers(0, 5_000, size=400).astype(np.int64)
            cluster.push_source("src", keys, rng.random(400), np.zeros(400))
            cluster.tick()
        sinks_before = len(cluster.metrics.sink_outputs)
        cluster.pool.kill(1)
        rng = np.random.default_rng(99)
        keys = rng.integers(0, 5_000, size=400).astype(np.int64)
        cluster.push_source("src", keys, rng.random(400), np.zeros(400))
        cluster.tick()
        assert 1 in cluster._dead_workers
        assert not cluster.alive[cluster.node_worker == 1].any()
        for _ in range(20):
            if cluster.worst_queue_cost() == 0.0:
                break
            cluster.tick()
        assert cluster.worst_queue_cost() == 0.0
        assert len(cluster.metrics.sink_outputs) > sinks_before
        cluster.finalize()
    finally:
        cluster.close()


def test_fail_worker_reports_orphans_and_rejects_dead_installs():
    cluster = port_cluster_engine()
    try:
        _push_both((cluster,), 200, seed=1)
        cluster.tick()
        base = cluster.topology.kg_base(1)
        kg0 = next(k for k in range(base, base + KGS)
                   if cluster.worker_of_node(cluster.router.node_of(k)) == 0)
        env = cluster.export_keygroup(kg0)
        orphans = cluster.fail_worker(1)
        dead_nodes = np.flatnonzero(cluster.node_worker == 1)
        assert set(orphans.tolist()) == set(
            np.flatnonzero(np.isin(cluster.router.table, dead_nodes)).tolist())
        with pytest.raises(RuntimeError, match="dead"):
            cluster.import_keygroup(env, int(dead_nodes[0]))
    finally:
        cluster.close()


def _schedule_ops(st, draw, steps):
    return [
        draw(st.one_of(
            st.tuples(st.just("push"), st.integers(0, 10_000)),
            st.just(("tick",)),
            st.tuples(st.just("migrate"), st.integers(0, KGS - 1), st.integers(0, 3)),
        ))
        for _ in range(steps)
    ]


def test_random_migrate_kill_interleavings_match_oracle():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @st.composite
    def schedules(draw):
        steps = draw(st.integers(4, 8))
        ops = _schedule_ops(st, draw, steps)
        return ops, draw(st.one_of(st.none(), st.integers(0, steps - 1)))

    @settings(max_examples=5, deadline=None)
    @given(sched=schedules())
    def run(sched):
        ops, kill_at = sched
        cluster, oracle = port_cluster_engine(), port_single()
        try:
            killed = False
            for i, op in enumerate(ops):
                if kill_at == i and not killed:
                    killed = True
                    doomed = np.flatnonzero(cluster.node_worker == 1)
                    kgs = np.flatnonzero(np.isin(cluster.router.table, doomed))
                    envs = {kg: cluster.export_keygroup(kg) for kg in kgs.tolist()}
                    cluster.fail_worker(1)
                    for node in doomed.tolist():
                        oracle.fail_node(node)
                    dst = int(np.flatnonzero(cluster.node_worker == 0)[0])
                    for kg, env in envs.items():
                        cluster.import_keygroup(env, dst)
                        oracle.router.table[kg] = dst
                        oracle.router.version += 1
                        oracle.import_keygroup(env, dst)
                if op[0] == "push":
                    _push_both((cluster, oracle), 120, seed=op[1])
                elif op[0] == "tick":
                    cluster.tick()
                    oracle.tick()
                else:
                    base = cluster.topology.kg_base(1)
                    kg, dst = base + op[1], op[2]
                    if (not cluster.router.is_in_flight(kg)
                            and cluster.alive[cluster.router.node_of(kg)]
                            and cluster.alive[dst]):
                        cluster.redirect(kg, dst)
                        oracle.redirect(kg, dst)
                        blob_c, blob_o = cluster.serialize(kg), oracle.serialize(kg)
                        assert blob_c == blob_o
                        cluster.install(kg, dst, blob_c)
                        oracle.install(kg, dst, blob_o)
            _drain_both(cluster, oracle)
            cluster.finalize()
        finally:
            cluster.close()
        assert cluster.metrics.sink_outputs == oracle.metrics.sink_outputs
        assert ({kg: s for kg, s in cluster.store.items() if s}
                == {kg: s for kg, s in oracle.store.items() if s})

    run()


def test_random_mixed_transport_interleavings_match_oracle():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @st.composite
    def schedules(draw):
        shm = draw(st.sampled_from([0, 128, 2048, 1 << 16]))
        return shm, _schedule_ops(st, draw, draw(st.integers(4, 8)))

    @settings(max_examples=6, deadline=None)
    @given(sched=schedules())
    def run(sched):
        shm, ops = sched
        cluster, oracle = port_cluster_engine(shm=shm), port_single()
        try:
            for op in ops:
                if op[0] == "push":
                    _push_both((cluster, oracle), 150, seed=op[1])
                elif op[0] == "tick":
                    cluster.tick()
                    oracle.tick()
                else:
                    base = cluster.topology.kg_base(1)
                    kg, dst = base + op[1], op[2]
                    if not cluster.router.is_in_flight(kg):
                        cluster.redirect(kg, dst)
                        oracle.redirect(kg, dst)
                        blob = cluster.serialize(kg)
                        assert blob == oracle.serialize(kg)
                        cluster.install(kg, dst, blob)
                        oracle.install(kg, dst, blob)
            _drain_both(cluster, oracle)
            cluster.finalize()
        finally:
            cluster.close()
        assert cluster.metrics.sink_outputs == oracle.metrics.sink_outputs
        assert ({kg: s for kg, s in cluster.store.items() if s}
                == {kg: s for kg, s in oracle.store.items() if s})

    run()


def _segments(cluster) -> list[str]:
    return [ring.shm.name for row in cluster.pool.rings for ring in row if ring is not None]


def test_sigkill_leaves_none_of_the_pools_segments():
    """The coordinator owns every lane segment: SIGKILL a worker mid-service
    and close the pool — none of this pool's segments (named by the port's
    prefix, the coordinator's pid and the pool's uid) is left in /dev/shm,
    and none was ever named with the reference's prefix."""
    if not os.path.isdir("/dev/shm"):  # pragma: no cover - non-POSIX-shm host
        pytest.skip("no /dev/shm to scan")
    cluster = port_cluster_engine()
    try:
        names = _segments(cluster)
        assert len(names) == 2  # both directions allocated
        assert all(n.startswith(f"{SEGMENT_PREFIX}_{os.getpid()}_") for n in names)
        assert not any(n.startswith(REF_PREFIX) for n in names)
        _push_both((cluster,), 300, seed=5)
        cluster.tick()
        assert all(os.path.exists(f"/dev/shm/{n}") for n in names)
        cluster.pool.kill(1)
        _push_both((cluster,), 300, seed=6)
        cluster.tick()  # death detected; the coordinator unlinks the dead lanes
        assert not any(os.path.exists(f"/dev/shm/{n}") for n in names)
        cluster.finalize()
    finally:
        cluster.close()
    assert not any(os.path.exists(f"/dev/shm/{n}") for n in names)


# ---------------------------------------------------------------------------
# The device seams
# ---------------------------------------------------------------------------


def test_pool_forked_after_threaded_torch_ops_finishes():
    """A forked child whose parent ran a threaded torch op hangs in its
    first threaded op unless it drops to one thread first: the parent runs a
    threaded matmul and argsort, then the workers route batches large enough
    for torch's plain versions to go parallel (bounded by a 20 s deadline:
    a hang fails the run, it does not wedge it)."""
    if torch.get_num_threads() < 2:  # pragma: no cover - one-core host
        pytest.skip("torch runs one thread here: nothing to fork from")
    a = torch.randn(1000, 1000)
    (a @ a).sum().item()
    torch.argsort(torch.rand(1 << 20)).sum().item()
    n = 1 << 17
    rng = np.random.default_rng(4)
    batches = [(rng.integers(0, 1 << 40, size=n), rng.random(n), np.zeros(n)) for _ in range(2)]
    engines = (port_cluster_engine(timeout=20.0), port_single())
    try:
        for eng in engines:
            eng.backpressure.full_credit = 2 * n
            for batch in batches:
                assert eng.push_source("src", *batch) == n
                eng.tick()
            for _ in range(3):
                eng.tick()
        engines[0].finalize()
    finally:
        engines[0].close()
    cluster, single = engines
    assert cluster.metrics.sink_tuples == single.metrics.sink_tuples == 2 * n
    assert cluster.metrics.sink_outputs == single.metrics.sink_outputs
    assert [s for _, s in cluster.store.items()] == [s for _, s in single.store.items()]


def test_worker_without_its_device_fails_the_run(monkeypatch):
    """``device="cuda"`` where there is no card: the coordinator makes no
    CUDA call (the kernels' build is stubbed here, there is no nvcc), every
    worker fails to resolve the device, and the coordinator raises the
    worker's traceback — no worker carries on on the CPU."""
    if torch.cuda.is_available():  # pragma: no cover - a card is present
        pytest.skip("a card is present: the workers would reach it")
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "build", lambda names=None: {})
    eng = port_engine.make_engine(port_pipeline_topo(KGS), 4, config=PortConfig.workers(2),
                                  service_rate=1e9, timeout=TIMEOUT, device="cuda")
    try:
        assert eng.device == torch.device("cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _push(eng, 100, seed=1)
            eng.tick()
    finally:
        eng.close()
    assert not any(p.is_alive() for p in eng.pool.processes)


def test_cuda_initialized_caller_is_refused_before_any_fork(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match="has not initialized CUDA"):
        port_engine.make_engine(port_pipeline_topo(KGS), 4, config=PortConfig.workers(2),
                                device="cuda", timeout=TIMEOUT)
    assert set(multiprocessing.active_children()) == before
    # The CPU workers do not care.
    with port_cluster_engine() as eng:
        assert _push(eng, 10, seed=2) == 10
    with pytest.raises(ValueError, match="unsupported device"):
        port_cluster_engine(device="mps")
