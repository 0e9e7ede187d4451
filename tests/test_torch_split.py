"""The port's hot-key splitting (``ExecutionConfig.split(d)``,
``Engine.split_keygroup`` / ``unsplit_keygroup``, ``HotKeySplitter``)
against the reference's.

Mirrors ``tests/test_split_conformance.py`` on the port's CPU engine: the
pinned split against the unsplit oracle, the unsplit merge, round robin
over replicas, replica migration, the refusal cases, the splitter's
hysteresis, the controller splitting on a flash crowd, and the hot-key
gauges.  Beyond the reference's own checks, each run is held to the
reference engine on the same traffic: every key group's state (replica
slots included), the routing table, tuple counts, migration envelope
bytes, split families and the controller's deterministic period metrics.
"""

import numpy as np
import pytest

import repro.core.framework as ref_framework
import repro.core.splitting as ref_splitting
import repro.core.stats as ref_stats
import repro.engine as ref_engine
import repro.engine.executor as ref_executor
import repro.engine.topology as ref_topology
import repro.workloads as ref_workloads
from conformance import normalize

pytest.importorskip("torch")

import repro_torch.core.framework as port_framework  # noqa: E402
import repro_torch.core.splitting as port_splitting  # noqa: E402
import repro_torch.core.stats as port_stats  # noqa: E402
import repro_torch.engine as port_engine  # noqa: E402
import repro_torch.engine.executor as port_executor  # noqa: E402
import repro_torch.engine.topology as port_topology  # noqa: E402
import repro_torch.workloads as port_workloads  # noqa: E402

KGS = 8
NODES = 4
#: package → (engine module, topology module); the port's engines run on the CPU.
PKGS = {"ref": (ref_engine, ref_topology), "port": (port_engine, port_topology)}


def _merge_counts(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def _count_op(state, keys, values, ts):
    for k in keys.tolist():
        state[k] = state.get(k, 0) + 1
    return state, list(zip(keys.tolist(), [1] * len(keys), ts.tolist()))


def _sum_sink(state, keys, values, ts):
    for k, v in zip(keys.tolist(), values.tolist()):
        state[k] = state.get(k, 0) + v
    return state, None


def _nonmergeable_op(state, keys, values, ts):
    state.setdefault("seq", []).extend(keys.tolist())
    return state, None


def make_topo(pkg, kgs=KGS, mergeable=True):
    topo = PKGS[pkg][1]
    t = topo.Topology()
    t.add_operator(topo.OperatorSpec("src", None, num_keygroups=kgs, is_source=True))
    t.add_operator(
        topo.OperatorSpec(
            "count",
            _count_op,
            num_keygroups=kgs,
            merge_state=_merge_counts if mergeable else None,
        )
    )
    t.add_operator(topo.OperatorSpec("sink", _sum_sink, num_keygroups=kgs, is_sink=True))
    t.connect("src", "count")
    t.connect("count", "sink")
    return t


def engine(pkg, *, split=0, kgs=KGS, mergeable=True):
    eng_mod = PKGS[pkg][0]
    cfg = eng_mod.ExecutionConfig.split(split) if split else None
    kw = {"device": "cpu"} if pkg == "port" else {}
    return eng_mod.Engine(
        make_topo(pkg, kgs, mergeable), NODES, service_rate=1e9, seed=0, config=cfg, **kw
    )


def _drive(eng, ticks=16, batch=300, hot_key=3, hot_frac=0.5, seed=7):
    """Skewed feed: ``hot_frac`` of traffic on one key, rest uniform."""
    rng = np.random.default_rng(seed)
    for t in range(ticks):
        hot = rng.random(batch) < hot_frac
        keys = np.where(hot, hot_key, rng.integers(0, 1000, size=batch))
        keys = keys.astype(np.int64)
        eng.push_source("src", keys, rng.random(batch), np.full(batch, float(t)))
        eng.tick()
    for _ in range(6):
        eng.tick()


def _layer_totals(eng, op_idx):
    base = eng.topology.kg_base(op_idx)
    nkg = eng.topology.operators[op_idx].num_keygroups
    kgs = list(range(base, base + nkg))
    for parent, slots in eng.split_families().items():
        if parent in kgs:
            kgs.extend(slots)
    out = {}
    for kg in kgs:
        for k, v in eng.store.get(kg).items():
            out[k] = out.get(k, 0) + v
    return out


def _hot_kg(eng, op_idx=1, key=3):
    return int(eng.topology.keygroups_of(op_idx, np.array([key], dtype=np.int64), None)[0])


def _assert_same_engine(port, ref):
    """Every key group's state (the replica reserve included), the routing
    table, the split families and the tuple counts, bit for bit."""
    g = len(ref.router.table)
    assert port.router.table.tolist() == ref.router.table.tolist()
    assert port.split_families() == ref.split_families()
    for kg in range(g):
        assert normalize(port.store.get(kg)) == normalize(ref.store.get(kg)), kg
    for f in ("processed_tuples", "sink_tuples", "cross_node_tuples", "intra_node_tuples"):
        assert getattr(port.metrics, f) == getattr(ref.metrics, f), f
    assert normalize(port.metrics.sink_outputs) == normalize(ref.metrics.sink_outputs)


# ---------------------------------------------------------------- bit-exact
def test_split_pinned_bit_exact_against_unsplit_oracle_and_reference():
    runs = {}
    for pkg in PKGS:
        oracle = engine(pkg)
        _drive(oracle)
        split_eng = engine(pkg, split=4)
        split_eng.split_keygroup(_hot_kg(split_eng))
        _drive(split_eng)
        assert _layer_totals(split_eng, 2) == _layer_totals(oracle, 2)
        assert _layer_totals(split_eng, 1) == _layer_totals(oracle, 1)
        runs[pkg] = split_eng
    _assert_same_engine(runs["port"], runs["ref"])
    # The split hop fans out on the host and still sorts through the kernel.
    m = runs["port"].metrics
    assert sum(m.sort_kernel_batches.values()) > 0


def test_unsplit_merges_family_state_back_bit_exact():
    runs = {}
    for pkg in PKGS:
        oracle = engine(pkg)
        _drive(oracle)
        split_eng = engine(pkg, split=3)
        kg = _hot_kg(split_eng)
        slots = split_eng.split_keygroup(kg)
        _drive(split_eng)
        assert all(sum(split_eng.store.get(s).values()) > 0 for s in [kg] + slots)
        split_eng.unsplit_keygroup(kg)
        assert split_eng.split_families() == {}
        assert split_eng.store.get(kg) == oracle.store.get(kg)
        for s in slots:
            assert split_eng.store.get(s) == {}
        assert split_eng.split_slots_free == split_eng.config.split_reserve
        assert split_eng.split_keygroup(kg) == slots
        runs[pkg] = (split_eng, slots)
    assert runs["port"][1] == runs["ref"][1]
    _assert_same_engine(runs["port"][0], runs["ref"][0])


def test_round_robin_spreads_a_single_hot_key():
    counts = {}
    for pkg in PKGS:
        eng = engine(pkg, split=4)
        kg = _hot_kg(eng)
        slots = eng.split_keygroup(kg)
        _drive(eng, hot_frac=1.0)
        counts[pkg] = [sum(eng.store.get(s).values()) for s in [kg] + slots]
        assert max(counts[pkg]) - min(counts[pkg]) <= 1
    assert counts["port"] == counts["ref"]


def test_split_survives_replica_migration():
    runs = {}
    for pkg in PKGS:
        eng = engine(pkg, split=3)
        kg = _hot_kg(eng)
        slots = eng.split_keygroup(kg)
        _drive(eng, ticks=8)
        replica = slots[0]
        dst = (eng.router.node_of(replica) + 1) % NODES
        eng.redirect(replica, dst)
        blob = eng.serialize(replica)
        eng.install(replica, dst, blob)
        assert eng.router.node_of(replica) == dst
        _drive(eng, ticks=8, seed=11)
        oracle = engine(pkg)
        _drive(oracle, ticks=8)
        _drive(oracle, ticks=8, seed=11)
        assert _layer_totals(eng, 1) == _layer_totals(oracle, 1)
        assert _layer_totals(eng, 2) == _layer_totals(oracle, 2)
        runs[pkg] = (eng, blob)
    assert runs["port"][1] == runs["ref"][1]  # envelope bytes
    _assert_same_engine(runs["port"][0], runs["ref"][0])


# ------------------------------------------------------------------- errors
def test_non_mergeable_operator_refuses_to_split():
    t = port_topology.Topology()
    t.add_operator(port_topology.OperatorSpec("src", None, num_keygroups=4, is_source=True))
    t.add_operator(port_topology.OperatorSpec("seq", _nonmergeable_op, num_keygroups=4))
    t.connect("src", "seq")
    eng = port_engine.Engine(
        t, 2, service_rate=1e9, seed=0, config=port_engine.ExecutionConfig.split(2),
        device="cpu",
    )
    with pytest.raises(ValueError, match="not split-mergeable"):
        eng.split_keygroup(t.kg_base(1))


def test_split_requires_config_and_valid_target():
    eng = engine("port")
    with pytest.raises(ValueError, match="disabled"):
        eng.split_keygroup(KGS)
    eng = engine("port", split=3)
    with pytest.raises(ValueError, match="source"):
        eng.split_keygroup(0)
    kg = _hot_kg(eng)
    eng.split_keygroup(kg)
    with pytest.raises(ValueError, match="already split"):
        eng.split_keygroup(kg)
    with pytest.raises(ValueError, match="replica"):
        eng.split_keygroup(eng.split_families()[kg][0])
    with pytest.raises(ValueError, match="not split"):
        eng.unsplit_keygroup(kg + 1 if kg + 1 < 2 * KGS else kg - 1)


def test_config_validation():
    cfg = port_engine.ExecutionConfig
    with pytest.raises(ValueError, match="split_degree"):
        cfg(split_degree=1)
    with pytest.raises(ValueError, match="split_reserve"):
        cfg(split_degree=8, split_reserve=3)
    with pytest.raises(ValueError, match="single-process"):
        cfg(split_degree=2, num_workers=2)
    with pytest.raises(ValueError, match="single-process"):
        cfg(split_degree=2, use_fn_jit=True)
    assert cfg.split(4).name == ref_engine.ExecutionConfig.split(4).name
    t = port_topology.Topology()
    t.add_operator(
        port_topology.OperatorSpec(
            "src", None, num_keygroups=2, is_source=True, merge_state=_merge_counts
        )
    )
    with pytest.raises(ValueError, match="source"):
        t.validate()


# -------------------------------------------------------- policy + controller
def test_splitter_policy_hysteresis_matches_reference():
    decisions = {}
    for pkg, stats, splitting in (
        ("ref", ref_stats, ref_splitting),
        ("port", port_stats, port_splitting),
    ):
        state = stats.ClusterState.create(
            2,
            np.array([0, 0, 1, 1]),
            np.array([1.0, 1.0, 1.0, 1.0]),
            np.array([0, 1, 0, 1]),
            kg_state_bytes=np.ones(4),
            out_rates=np.zeros((4, 4)),
            downstream={0: [1], 1: []},
            kg_tuple_rate=np.array([100.0, 1.0, 1.0, 1.0]),
        )
        pol = splitting.HotKeySplitter(hot_frac=0.5, cool_frac=0.25)
        got = [pol.decide(state, {})]
        got.append(pol.decide(state, {}, eligible=np.array([False, True, True, True])))
        got.append(pol.decide(state, {0: [3]}))
        cold = state.copy()
        cold.kg_tuple_rate = np.array([0.1, 50.0, 50.0, 0.1])
        got.append(pol.decide(cold, {0: [3]}))
        decisions[pkg] = [(d.split, d.unsplit) for d in got]
    assert decisions["port"] == decisions["ref"]
    d = decisions["port"]
    assert d[0][0] == (0,)  # the hot key group splits
    assert d[1][0] == ()  # the eligibility mask vetoes it
    assert d[2] == ((), ())  # an active family is not re-split
    assert d[3][1] == (0,)  # and folds back once cooled


_PERIOD_FIELDS = (
    "period",
    "load_distance",
    "collocation_factor",
    "load_index",
    "num_migrations",
    "migration_cost",
    "num_splits",
    "num_nodes_alive",
)


def test_controller_splits_on_flash_crowd_like_reference():
    """Scenario stream → SPL statistics → splitter decision → engine split,
    through both packages' controllers: the same splits, migrations,
    period metrics, families and states."""
    runs = {}
    for pkg, fw_mod, split_mod, wl in (
        ("ref", ref_framework, ref_splitting, ref_workloads),
        ("port", port_framework, port_splitting, port_workloads),
    ):
        eng_mod = PKGS[pkg][0]
        spec = wl.make_scenario("flash_crowd", rate=128.0, key_space=256, seed=1)
        batches = iter(wl.scenario_batches(spec, 120))

        def feeder(engine_, tick, batches=batches):
            try:
                keys, values, ts = next(batches)
            except StopIteration:
                return
            if len(keys):
                engine_.push_source("src", keys, values["entity"], ts)

        eng = engine(pkg, split=4, kgs=16)
        fw = fw_mod.AdaptationFramework(
            mode="albic", max_migrations=8, splitter=split_mod.HotKeySplitter()
        )
        ctl = eng_mod.Controller(
            eng, fw, eng_mod.ControllerConfig(ticks_per_period=10), feeder=feeder
        )
        history = [ctl.period() for _ in range(8)]
        assert sum(m.num_splits for m in history) >= 1
        assert eng.split_families()
        runs[pkg] = (history, eng)
    (rh, re_), (ph, pe) = runs["ref"], runs["port"]
    for a, b in zip(rh, ph):
        for f in _PERIOD_FIELDS:
            assert getattr(b, f) == getattr(a, f), (a.period, f)
    _assert_same_engine(pe, re_)


# ------------------------------------------------------- hot-key observability
def test_hot_key_summary_matches_reference():
    for load, k in (
        (np.array([0.0, 5.0, 5.0, 10.0]), 2),
        (np.zeros(4), 3),
        (np.random.default_rng(0).random(64), 5),
    ):
        assert port_executor.hot_key_summary(load, topk=k) == ref_executor.hot_key_summary(
            load, topk=k
        )
    assert port_executor.hot_key_summary(np.array([0.0, 5.0, 5.0, 10.0]), topk=2) == (
        [(3, 10.0), (1, 5.0)],
        0.5,
    )


def test_engine_metrics_expose_hot_keygroups_like_reference():
    got = {}
    for pkg in PKGS:
        eng = engine(pkg)
        _drive(eng, ticks=6)
        eng.end_period()
        assert eng.metrics.hot_keygroups
        assert 0.0 < eng.metrics.max_kg_share <= 1.0
        assert _hot_kg(eng) in [kg for kg, _ in eng.metrics.hot_keygroups]
        got[pkg] = (eng.metrics.hot_keygroups, eng.metrics.max_kg_share)
    assert got["port"] == got["ref"]


def test_cluster_fold_matches_single_process_gauge():
    """The port's coordinator folds the same gauge as its single-process
    engine, and both equal the reference's single-process gauge."""
    from conformance import make_pipeline_topo
    from test_torch_cluster import port_pipeline_topo

    def run(make, topo, config, **kw):
        eng = make(topo(8), 4, config=config, service_rate=1e9, seed=0, **kw)
        rng = np.random.default_rng(5)
        for _ in range(6):
            keys = np.where(
                rng.random(200) < 0.4, 7, rng.integers(0, 4000, size=200)
            ).astype(np.int64)
            eng.push_source("src", keys, rng.random(200), np.zeros(200))
            eng.tick()
        eng.end_period()
        hot, share = eng.metrics.hot_keygroups, eng.metrics.max_kg_share
        eng.finalize()
        return hot, share

    cfg = port_engine.ExecutionConfig
    single = run(port_engine.make_engine, port_pipeline_topo, cfg.typed(), device="cpu")
    multi = run(
        port_engine.make_engine, port_pipeline_topo, cfg.workers(2), device="cpu", timeout=60.0
    )
    ref = run(ref_engine.make_engine, make_pipeline_topo, ref_engine.ExecutionConfig.typed())
    assert single == multi == ref
