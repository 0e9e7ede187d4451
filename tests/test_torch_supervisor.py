"""The port's self-healing cluster (``repro_torch.engine.supervisor``, workers
on the CPU): supervised respawn, periodic checkpoints, chaos.

Mirrors ``tests/test_supervisor.py``: a worker SIGKILLed mid-stream is
respawned and the cluster rewinds to the latest checkpoint unattended, and
everything after the recovery's sink mark is bit-identical to a fresh
single-process port engine restored from the same checkpoint and fed the
same post-checkpoint admissions.  Where the drive is deterministic the
reference's supervised cluster runs it too, and the two must agree: the
recovery reports (but their wall-clock MTTR), sink outputs and their order,
states and counters.  The port's extras: the respawned worker's lifetime is
folded once beside its dead predecessor's (``ClusterEngine.worker_stats``),
and the chaos leak check looks only at the pools' own segments.

Every pool gets a deadline (``timeout=``).  Within each test the port's
pools fork before the reference's supervised cluster is built (its
supervisor imports jax, through the reference's checkpoint stack).
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

from conformance import make_pipeline_topo
from test_torch_cluster import TIMEOUT, port_pipeline_topo

torch = pytest.importorskip("torch")

import repro.engine as ref_engine  # noqa: E402

import repro_torch.engine as port_engine  # noqa: E402
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.engine.checkpointing import (  # noqa: E402
    payload_from_tree,
    restore_engine,
    snapshot_payload,
)
from repro_torch.engine.cluster import WorkerPool  # noqa: E402
from repro_torch.engine.config import CheckpointPolicy, SupervisionPolicy  # noqa: E402
from repro_torch.engine.faults import FaultEvent, FaultPlan  # noqa: E402
from repro_torch.engine.shmx import SEGMENT_PREFIX  # noqa: E402

KGS = 8
NODES = 4
TICKS_PER_PERIOD = 6
PortConfig = port_engine.ExecutionConfig


def _batches(n, size=200, key_space=5_000, seed=123):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, key_space, size=size).astype(np.int64), rng.random(size),
         np.full(size, float(t)))
        for t in range(n)
    ]


def _healing_config(mod, directory, *, shm, every=2, supervision=None):
    return mod.ExecutionConfig.workers(
        2,
        shm=shm,
        checkpoint=mod.config.CheckpointPolicy(directory=str(directory), every=every),
        supervision=supervision or mod.config.SupervisionPolicy(),
    )


def _port_cluster(tmp_path, *, shm, every=2, supervision=None, faults=None, seed=0, sub="ck"):
    return port_engine.make_engine(
        port_pipeline_topo(KGS), NODES,
        config=_healing_config(port_engine, tmp_path / sub, shm=shm, every=every,
                               supervision=supervision),
        service_rate=1e9, seed=seed, faults=faults, device="cpu", timeout=TIMEOUT,
    )


def _ref_cluster(tmp_path, *, every=2, supervision=None, faults=None, seed=0, sub="ref"):
    """The reference's supervised cluster on its queue transport (its shm
    lanes would be ``repro_xchg`` segments, which the reference's own leak
    checks in other test processes must never see)."""
    from repro.engine import faults as ref_faults

    plan = None if faults is None else ref_faults.FaultPlan.of(
        ref_faults.FaultEvent(e.kind, e.worker, at_tick=e.at_tick, at_period=e.at_period,
                              seconds=e.seconds, ignore_term=e.ignore_term)
        for e in faults.events)
    sup = None
    if supervision is not None:
        import dataclasses

        sup = ref_engine.config.SupervisionPolicy(**dataclasses.asdict(supervision))
    return ref_engine.make_engine(
        make_pipeline_topo(KGS), NODES,
        config=_healing_config(ref_engine, tmp_path / sub, shm=0, every=every,
                               supervision=sup),
        service_rate=1e9, seed=seed, faults=plan, timeout=TIMEOUT,
    )


def _port_oracle():
    return port_engine.Engine(port_pipeline_topo(KGS), NODES, config=PortConfig.typed(),
                              service_rate=1e9, seed=0, device="cpu")


def _drive_periods(eng, batches, periods):
    it = iter(batches)
    for _ in range(periods):
        for _ in range(TICKS_PER_PERIOD):
            eng.push_source("src", *next(it))
            eng.tick()
        eng.end_period()


def _drain(eng, max_ticks=60):
    for _ in range(max_ticks):
        if eng.worst_queue_cost() == 0.0:
            return
        eng.tick()
    raise AssertionError("cluster failed to quiesce")


def _drain_oracle(eng, max_ticks=60):
    for _ in range(max_ticks):
        if not any(eng.queue_costs()):
            return
        eng.tick()
    raise AssertionError("oracle failed to quiesce")


def _nonempty_states(store):
    return {kg: s for kg, s in store.items() if s}


def _run(eng, drive):
    try:
        drive(eng)
        _drain(eng)
        eng.finalize()
    finally:
        eng.close()
    assert not any(p.is_alive() for p in eng.pool.processes)
    return eng


def _report_fields(report):
    return {f: getattr(report, f) for f in (
        "worker", "cause", "respawn_attempt", "gave_up", "restored_step", "restored_cursor",
        "restored_sink_len", "orphans", "rehomed", "replayed_batches")}


@pytest.mark.parametrize("shm", [1 << 20, 0], ids=["shm", "queue"])
def test_auto_respawn_converges_to_oracle_replay(tmp_path, shm):
    """SIGKILL one worker mid-stream, recover unattended, and match the
    port oracle replayed from the surviving checkpoint — and the reference's
    supervised cluster through the same plan."""
    kill_tick = 2 * TICKS_PER_PERIOD + 3  # mid period 3; checkpoint at p2
    batches = _batches(4 * TICKS_PER_PERIOD)
    plan = FaultPlan.of([FaultEvent("kill", 1, at_tick=kill_tick)])

    def drive(e):
        _drive_periods(e, batches, 4)

    cluster = _run(_port_cluster(tmp_path, shm=shm, faults=plan), drive)
    assert len(cluster.recoveries) == 1
    report = cluster.recoveries[0]
    assert report.cause == "kill" and not report.gave_up
    assert report.worker == 1 and report.respawn_attempt == 1
    assert report.restored_step == report.restored_cursor == 2 * TICKS_PER_PERIOD
    assert report.replayed_batches == kill_tick + 1 - report.restored_cursor
    assert report.orphans > 0

    tree, meta = CheckpointManager(str(tmp_path / "ck")).restore(step=report.restored_step)
    payload = payload_from_tree(tree)
    assert meta["ingest_cursor"] == report.restored_cursor
    payload["table"] = np.asarray(cluster.router.table, dtype=np.int64).copy()
    oracle = _port_oracle()
    restore_engine(oracle, payload)
    for keys, values, ts in batches[report.restored_cursor:]:
        oracle.push_source("src", keys, values, ts)
        oracle.tick()
    _drain_oracle(oracle)
    assert cluster.metrics.sink_outputs[report.restored_sink_len:] == oracle.metrics.sink_outputs
    assert _nonempty_states(cluster.store) == _nonempty_states(oracle.store)

    # The dead incarnation's last heartbeat and both live lifetimes, once.
    lives = [(life["worker"], life["incarnation"], life["died"]) for life in cluster.worker_stats]
    assert sorted(lives) == [(0, 0, False), (1, 0, True), (1, 1, False)]
    assert cluster.metrics.processed_tuples == sum(
        life["metrics"]["processed_tuples"] for life in cluster.worker_stats)

    ref = _run(_ref_cluster(tmp_path, faults=plan), drive)
    assert [_report_fields(r) for r in cluster.recoveries] == [
        _report_fields(r) for r in ref.recoveries]
    assert cluster.metrics.sink_outputs == ref.metrics.sink_outputs
    assert np.array_equal(cluster.router.table, ref.router.table)
    assert _nonempty_states(cluster.store) == _nonempty_states(ref.store)


def _merge_counts(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def _count_op(state, keys, values, ts):
    for k in keys.tolist():
        state[k] = state.get(k, 0) + 1
    return state, (keys, values, ts)


def _record_sink(state, keys, values, ts):
    state["n"] = state.get("n", 0) + len(keys)
    return state, (keys, values, ts)


def _make_split_topo(kgs=KGS):
    from repro_torch.engine import OperatorSpec, Topology

    t = Topology()
    t.add_operator(OperatorSpec("src", None, num_keygroups=kgs, is_source=True))
    t.add_operator(OperatorSpec("count", _count_op, num_keygroups=kgs, merge_state=_merge_counts))
    t.add_operator(OperatorSpec("sink", _record_sink, num_keygroups=kgs, is_sink=True))
    t.connect("src", "count")
    t.connect("count", "sink")
    return t


def test_split_replicas_recover_through_checkpoint_path():
    """Replica (split) key groups ride the port's checkpoint/restore path:
    split topology and fan-out cursors restore bit-exact, and the restored
    engine replayed over the post-cut admissions converges to the tail."""
    cfg = PortConfig.split(2, reserve=4)
    batches = _batches(18, key_space=40)

    def build():
        return port_engine.Engine(_make_split_topo(), NODES, config=cfg, service_rate=1e9,
                                  seed=0, device="cpu")

    eng = build()
    hot = KGS
    eng.split_keygroup(hot)
    assert eng.split_families()[hot]
    for keys, values, ts in batches[:12]:
        eng.push_source("src", keys, values, ts)
        eng.tick()
    _drain_oracle(eng)
    payload = snapshot_payload(eng)
    sink_mark = payload["sink_len"]
    assert payload["split"]["map"] and payload["ingest_cursor"] == 12
    for keys, values, ts in batches[12:]:
        eng.push_source("src", keys, values, ts)
        eng.tick()
    _drain_oracle(eng)

    restored = build()
    restored.split_keygroup(hot)
    restored.unsplit_keygroup(hot)
    restore_engine(restored, payload)
    assert restored._split_map == {int(p): list(f) for p, f in payload["split"]["map"].items()}
    assert restored._split_rr == {int(p): int(c) for p, c in payload["split"]["rr"].items()}
    assert restored.ingest_cursor == 12
    for keys, values, ts in batches[12:]:
        restored.push_source("src", keys, values, ts)
        restored.tick()
    _drain_oracle(restored)
    assert eng.metrics.sink_outputs[sink_mark:] == restored.metrics.sink_outputs
    assert _nonempty_states(eng.store) == _nonempty_states(restored.store)


def test_hung_worker_is_escalated_and_recovered(tmp_path):
    """Wedged ≠ dead: a worker stuck mid-command past the liveness deadline
    (1.5 s) is SIGKILLed and recovered like a crash, long before its 30 s
    hang would end."""
    supervision = SupervisionPolicy(hb_interval_s=0.25, hb_misses=6)
    batches = _batches(3 * TICKS_PER_PERIOD)
    plan = FaultPlan.of([FaultEvent("hang", 1, at_tick=TICKS_PER_PERIOD + 2, seconds=30.0)])
    start = time.monotonic()
    cluster = _run(
        _port_cluster(tmp_path, shm=0, every=1, supervision=supervision, faults=plan),
        lambda e: _drive_periods(e, batches, 3),
    )
    assert time.monotonic() - start < 25.0
    assert [r.cause for r in cluster.recoveries] == ["hang"], cluster.recoveries
    assert not cluster.recoveries[0].gave_up
    assert len(cluster.metrics.sink_outputs) > 0


def test_shutdown_escalates_to_sigkill_on_ignoring_worker(monkeypatch):
    monkeypatch.setattr(WorkerPool, "_GRACE_S", 0.5)
    cluster = port_engine.make_engine(
        port_pipeline_topo(KGS), NODES, config=PortConfig.workers(2), service_rate=1e9,
        seed=0, timeout=1.0, device="cpu")
    cluster.push_source("src", *_batches(1)[0])
    cluster.tick()
    cluster.pool.send(1, ("fault", "hang", 60.0, True))
    time.sleep(0.3)
    procs = list(cluster.pool.processes)
    cluster.close()
    assert not any(p.is_alive() for p in procs)


def test_counters_conserved_across_respawn(tmp_path):
    """A kill at a just-checkpointed, quiesced period boundary loses and
    duplicates nothing: finalize totals (the port's per-operator routing
    counters too) and exchange message counts match the fault-free run, and
    the reference's healed run."""
    batches = _batches(4 * TICKS_PER_PERIOD)
    keep = SupervisionPolicy(rehome="keep")

    def drive(e):
        it = iter(batches)
        for _ in range(4):
            for _ in range(TICKS_PER_PERIOD):
                e.push_source("src", *next(it))
                e.tick()
            _drain(e)
            e.end_period()

    plain = _run(_port_cluster(tmp_path, shm=1 << 20, supervision=keep, sub="a"), drive)
    healed = _run(_port_cluster(tmp_path, shm=1 << 20, supervision=keep, sub="b",
                                faults=FaultPlan.kill_at_period(1, 2)), drive)
    assert len(healed.recoveries) == 1
    assert healed.recoveries[0].replayed_batches == 0
    assert healed.metrics.sink_outputs == plain.metrics.sink_outputs
    for f in ("processed_tuples", "emitted_tuples", "sink_tuples", "ticks",
              "routed_batches", "partition_kernel_batches", "sort_kernel_batches",
              "exchange_split_batches"):
        assert getattr(healed.metrics, f) == getattr(plain.metrics, f), f
    # The replacement uploads its routing table to its device afresh.
    assert healed.metrics.host_device_copies > plain.metrics.host_device_copies
    for f in ("shm_msgs", "queue_msgs"):
        assert healed.exchange_stats[f] == plain.exchange_stats[f], f
    assert _nonempty_states(healed.store) == _nonempty_states(plain.store)
    ref = _run(_ref_cluster(tmp_path, supervision=keep,
                            faults=FaultPlan.kill_at_period(1, 2)), drive)
    assert healed.metrics.sink_outputs == ref.metrics.sink_outputs
    for f in ("processed_tuples", "emitted_tuples", "sink_tuples", "ticks"):
        assert getattr(healed.metrics, f) == getattr(ref.metrics, f), f
    xs = healed.exchange_stats
    assert xs["shm_msgs"] + xs["queue_msgs"] == ref.exchange_stats["queue_msgs"]


def _chaos_seeds():
    env = os.environ.get("CHAOS_SEEDS")
    return [int(s) for s in env.split(",")] if env else [0, 1, 2]


@pytest.mark.parametrize("seed", _chaos_seeds())
def test_seeded_chaos_run_is_bounded_and_leak_free(tmp_path, seed):
    """A seeded FaultPlan of kills, hangs and delays through a supervised
    cluster: the run completes, recovers every kill, and leaks neither
    processes nor any of its own segments (the original lanes and every
    respawn's replacements, named by the port's prefix)."""
    periods = 3
    plan = FaultPlan.random(seed, num_workers=2, periods=periods, hang_seconds=0.3)
    supervision = SupervisionPolicy(hb_interval_s=0.1, hb_misses=8, max_respawns=5)
    batches = _batches(periods * TICKS_PER_PERIOD, size=100)
    cluster = _port_cluster(tmp_path, shm=1 << 20, every=1, supervision=supervision,
                            faults=plan, seed=seed)
    names: set[str] = set()
    respawn = cluster.pool.respawn

    def respawn_noting_lanes(wid):
        out = respawn(wid)
        names.update(r.shm.name for row in cluster.pool.rings for r in row if r is not None)
        return out

    cluster.pool.respawn = respawn_noting_lanes
    names.update(r.shm.name for row in cluster.pool.rings for r in row if r is not None)
    _run(cluster, lambda e: _drive_periods(e, batches, periods))
    kills = sum(1 for e in plan.events if e.kind == "kill")
    recovered = sum(1 for r in cluster.recoveries if not r.gave_up)
    assert recovered >= min(kills, 1)
    assert len(cluster.metrics.sink_outputs) > 0
    assert names and all(n.startswith(f"{SEGMENT_PREFIX}_{os.getpid()}_") for n in names)
    if os.path.isdir("/dev/shm"):
        assert not [n for n in names if os.path.exists(f"/dev/shm/{n}")]


def test_recovery_without_checkpoint_rewinds_to_start(tmp_path):
    """No committed checkpoint yet: recovery rewinds to T0 and replays
    every buffered admission; as the reference does."""
    batches = _batches(TICKS_PER_PERIOD)
    plan = FaultPlan.of([FaultEvent("kill", 0, at_tick=3)])

    def drive(e):
        _drive_periods(e, batches, 1)

    cluster = _run(_port_cluster(tmp_path, shm=0, every=50, faults=plan), drive)
    report = cluster.recoveries[0]
    assert report.restored_step == -1 and report.restored_cursor == 0
    assert report.replayed_batches == 4

    oracle = _port_oracle()
    oracle.router.reset(np.asarray(cluster.router.table, dtype=np.int64))
    for keys, values, ts in batches:
        oracle.push_source("src", keys, values, ts)
        oracle.tick()
    _drain_oracle(oracle)
    assert cluster.metrics.sink_outputs[report.restored_sink_len:] == oracle.metrics.sink_outputs
    assert _nonempty_states(cluster.store) == _nonempty_states(oracle.store)
    ref = _run(_ref_cluster(tmp_path, every=50, faults=plan), drive)
    assert [_report_fields(r) for r in cluster.recoveries] == [
        _report_fields(r) for r in ref.recoveries]
    assert cluster.metrics.sink_outputs == ref.metrics.sink_outputs


def test_respawn_budget_exhaustion_degrades_to_fail_node(tmp_path):
    supervision = SupervisionPolicy(max_respawns=0)
    batches = _batches(2 * TICKS_PER_PERIOD)
    cluster = _run(
        _port_cluster(tmp_path, shm=0, supervision=supervision,
                      faults=FaultPlan.of([FaultEvent("kill", 1, at_tick=3)])),
        lambda e: _drive_periods(e, batches, 2),
    )
    assert [r.gave_up for r in cluster.recoveries] == [True]
    assert 1 in cluster._dead_workers
    assert len(cluster.metrics.sink_outputs) > 0


def test_policies_and_config_checks_match_reference():
    """The port's ExecutionConfig checks, presets and names are the
    reference's for the multi-worker and checkpoint fields."""
    ref_cfg = ref_engine.ExecutionConfig
    pol = CheckpointPolicy("/nonexistent-ok", every=3)
    for port, ref in (
        (PortConfig.workers(4), ref_cfg.workers(4)),
        (PortConfig.workers(2, shm=0), ref_cfg.workers(2, shm=0)),
        (PortConfig(checkpoint=pol), ref_cfg(checkpoint=ref_engine.config.CheckpointPolicy(
            "/nonexistent-ok", every=3))),
        (PortConfig.workers(2, checkpoint=pol, supervision=SupervisionPolicy()),
         ref_cfg.workers(2, checkpoint=ref_engine.config.CheckpointPolicy(
             "/nonexistent-ok", every=3), supervision=ref_engine.config.SupervisionPolicy())),
    ):
        assert port.name == ref.name
        assert (port.num_workers, port.shm_lane_bytes) == (ref.num_workers, ref.shm_lane_bytes)
    bad = (
        dict(num_workers=0), dict(shm_lane_bytes=-1), dict(shm_lane_bytes=10),
        dict(num_workers=2, use_fn_jit=True), dict(num_workers=2, split_degree=2),
        dict(supervision=SupervisionPolicy()),
        dict(num_workers=2, supervision=SupervisionPolicy()),
    )
    for kw in bad:
        with pytest.raises(ValueError):
            PortConfig(**kw)
    for kw in (dict(directory=""), dict(directory="d", every=0), dict(directory="d", keep=0)):
        with pytest.raises(ValueError):
            CheckpointPolicy(**kw)
    for kw in (dict(hb_interval_s=0), dict(hb_misses=0), dict(max_respawns=-1),
               dict(backoff_base_s=-1), dict(rehome="nowhere")):
        with pytest.raises(ValueError):
            SupervisionPolicy(**kw)
    assert SupervisionPolicy(hb_interval_s=0.5, hb_misses=4).deadline_s == 2.0
    assert PortConfig.workers(2, supervision=SupervisionPolicy(respawn=False)).name == (
        "soa+seg+schema+workers+supervised")
