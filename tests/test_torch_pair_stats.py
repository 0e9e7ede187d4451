"""The statistics window's send pairs counted in dense per-operator blocks
(``repro_torch.core.stats.PairBlocks``, ``SPLWindow(layout=...)``).

A window with the topology's layout is held, in codes, order and every
rate (``np.array_equal``), to the same window without one -- the sort-based
compaction, unchanged -- and to the reference's ``repro.core.stats.
SPLWindow``: on Real Jobs 3 and 1 at 30 and 1,000 key groups an operator,
across many compactions, folds and resets; with hot-key replica ids and
pairs off the topology's edges mixed in; on the fused superstep's integer
counts; on a restored checkpoint's non-integral rates followed by unit
pairs; on an empty window.  The engine's counters say which path took each
entry, and ``route.stats``/``fold.pairs`` are timed.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.stats as ref_stats  # noqa: E402
import repro.engine as ref_engine  # noqa: E402
import repro.engine.topology as ref_topology  # noqa: E402
from repro_torch.core import stats  # noqa: E402
from repro_torch.data import jobs, synthetic  # noqa: E402
from repro_torch.engine import Engine, ExecutionConfig  # noqa: E402
from repro_torch.engine import topology as port_topology  # noqa: E402

JOBS = {"job3": jobs.real_job_3, "job1": jobs.real_job_1}
RESERVE = 16  # replica slots past the topology's key groups


def _layout(topo, g):
    return stats.PairBlocks(
        topo.kg_base_table()[:-1],
        [o.num_keygroups for o in topo.operators],
        topo.downstream(),
        g,
    )


def _windows(topo, g, threshold):
    """The window under test, the same without a layout, the reference's."""
    return [
        stats.SPLWindow(g, compact_threshold=threshold, layout=_layout(topo, g)),
        stats.SPLWindow(g, compact_threshold=threshold),
        ref_stats.SPLWindow(g, compact_threshold=threshold),
    ]


def _assert_same(windows):
    got = [w.pair_counts() for w in windows]
    for p in got[1:]:
        for f in ("src", "dst", "rate"):
            assert np.array_equal(getattr(got[0], f), getattr(p, f)), f
        assert got[0].num_keygroups == p.num_keygroups
    return got[0]


def _hop(rng, topo, s, d, n, zipf=1.2):
    """``n`` skewed (src, dst) entries on the edge s → d."""
    base = topo.kg_base_table()
    ns, nd = base[s + 1] - base[s], base[d + 1] - base[d]
    src = base[s] + (rng.zipf(zipf, n) - 1) % ns
    dst = base[d] + rng.integers(0, nd, n)
    return src.astype(np.int64), dst.astype(np.int64)


@pytest.mark.parametrize("kgs", [30, 1000])
@pytest.mark.parametrize("job", sorted(JOBS))
def test_blocks_equal_the_sort_and_the_reference(job, kgs):
    """Three periods of every edge's hops, each crossing the compaction
    threshold several times, then a fold and a reset."""
    topo = JOBS[job](keygroups_per_op=kgs)
    g = topo.num_keygroups
    windows = _windows(topo, g, threshold=5_000)
    rng = np.random.default_rng(kgs)
    for period in range(3):
        for _ in range(4):
            for s, d in topo.edges:
                src, dst = _hop(rng, topo, s, d, 3_000)
                took = [w.record_send_pairs(src, dst) for w in windows]
                assert took[0] == len(src) and took[1] == 0
        pairs = _assert_same(windows)
        assert pairs.nnz > 0 and pairs.total() == 4 * 3_000 * len(topo.edges)
        folds = [w.fold() for w in windows]
        for f in ("src", "dst", "rate"):
            assert np.array_equal(getattr(folds[0][1], f), getattr(folds[2][1], f))
        for w in windows:
            w.reset()
        assert _assert_same(windows).nnz == 0


@pytest.mark.parametrize("job", sorted(JOBS))
def test_replicas_and_pairs_off_the_edges_take_the_sparse_path(job):
    topo = JOBS[job](keygroups_per_op=30)
    g = topo.num_keygroups + RESERVE
    windows = _windows(topo, g, threshold=2_000)
    rng = np.random.default_rng(3)
    (s, d), first = topo.edges[-1], topo.edges[0]
    for _ in range(5):
        src, dst = _hop(rng, topo, s, d, 1_500)
        rep = rng.random(len(src)) < 0.2  # hot-key replicas at either end
        src[rep] = topo.num_keygroups + rng.integers(0, RESERVE, rep.sum())
        dst[rng.random(len(dst)) < 0.1] = topo.num_keygroups + 3
        held = (src < topo.num_keygroups) & (dst < topo.num_keygroups)
        took = [w.record_send_pairs(src, dst) for w in windows]
        assert took[0] == held.sum() < len(src)
        # An operator to itself is no edge of the job: every entry sparse.
        self_src, self_dst = _hop(rng, topo, first[0], first[0], 700)
        assert windows[0].record_send_pairs(self_src, self_dst) == 0
        for w in windows[1:]:
            w.record_send_pairs(self_src, self_dst)
        _assert_same(windows)
    for w in windows:
        w.reset()
    src, dst = _hop(rng, topo, s, d, 1_000)
    assert [w.record_send_pairs(src, dst) for w in windows][0] == 1_000
    _assert_same(windows)


def test_superstep_counts_mixed_edges_and_zero_counts():
    """The fused superstep records every edge of a tick in one call, with
    integer counts; zero counts keep their pairs as the sort does."""
    topo = jobs.real_job_3(keygroups_per_op=30)
    g = topo.num_keygroups
    windows = _windows(topo, g, threshold=400)
    rng = np.random.default_rng(11)
    for tick in range(6):
        parts = [_hop(rng, topo, s, d, 200) for s, d in topo.edges]
        src = np.concatenate([p[0] for p in parts])
        dst = np.concatenate([p[1] for p in parts])
        counts = rng.integers(0, 5, len(src)).astype(np.int64)  # zeros among them
        took = [w.record_send_counts(src, dst, counts) for w in windows]
        assert took[0] == np.count_nonzero(counts)
        _assert_same(windows)


def test_pairs_whose_counts_sum_to_zero_are_kept():
    topo = jobs.real_job_3(keygroups_per_op=30)
    windows = _windows(topo, topo.num_keygroups, threshold=400)
    for w in windows:
        w.record_send_counts([0, 1], [30, 31], [0, 0])
        w.record_send_counts([0, 2], [30, 32], [3, 1])
        w.record_send_counts([2], [32], [-1])
    got = _assert_same(windows)
    assert got.src.tolist() == [0, 1, 2] and got.rate.tolist() == [3.0, 0.0, 0.0]


@pytest.mark.parametrize("first", ["restored", "unit"])
def test_non_integral_rates_take_the_sort_until_reset(first):
    """A restored checkpoint's rates (non-integral) hand the blocks' counts
    to the sort, which then takes every entry, as at the parent."""
    topo = jobs.real_job_3(keygroups_per_op=30)
    g = topo.num_keygroups
    windows = _windows(topo, g, threshold=1_000)
    rng = np.random.default_rng(5)
    (s, d) = topo.edges[1]
    src, dst = _hop(rng, topo, s, d, 600)
    rates = rng.random(600) * 7.0
    if first == "unit":
        unit = _hop(rng, topo, s, d, 900)
        assert windows[0].record_send_pairs(*unit) == 900
        for w in windows[1:]:
            w.record_send_pairs(*unit)
    took = [w.record_send_counts(src, dst, rates) for w in windows]
    assert took[0] == 0
    for _ in range(4):
        unit = _hop(rng, topo, s, d, 700)
        assert windows[0].record_send_pairs(*unit) == 0
        for w in windows[1:]:
            w.record_send_pairs(*unit)
        _assert_same(windows)
    for w in windows:
        w.reset()
    unit = _hop(rng, topo, s, d, 700)
    assert windows[0].record_send_pairs(*unit) == 700
    for w in windows[1:]:
        w.record_send_pairs(*unit)
    _assert_same(windows)


def test_checkpoint_round_trip_of_a_window():
    """``window_peek`` and ``window_restore`` carry a window's rates."""
    from repro_torch.engine.checkpointing import window_peek, window_restore

    topo = jobs.real_job_3(keygroups_per_op=30)
    g = topo.num_keygroups
    a, b = (stats.SPLWindow(g, layout=_layout(topo, g)) for _ in range(2))
    rng = np.random.default_rng(2)
    for s, d in topo.edges:
        a.record_send_pairs(*_hop(rng, topo, s, d, 800))
    window_restore(b, window_peek(a))
    for f in ("src", "dst", "rate"):
        assert np.array_equal(getattr(a.pair_counts(), f), getattr(b.pair_counts(), f))
    assert b._cells is not None  # integral rates stay on the blocks


@pytest.mark.parametrize("with_layout", [True, False])
def test_empty_window(with_layout):
    topo = jobs.real_job_3(keygroups_per_op=30)
    g = topo.num_keygroups
    windows = _windows(topo, g, threshold=100)
    if not with_layout:
        windows = windows[1:]
    empty = np.empty(0, np.int64)
    assert [w.record_send_pairs(empty, empty) for w in windows][0] == 0
    assert _assert_same(windows).nnz == 0
    for w in windows:
        w.reset()
        _, pairs, _ = w.fold()
        assert pairs.nnz == 0


def test_a_block_over_the_cap_takes_the_sparse_path(monkeypatch):
    topo = jobs.real_job_3(keygroups_per_op=30)
    g = topo.num_keygroups
    monkeypatch.setattr(stats, "DENSE_PAIR_CELLS", 30 * 30)  # extract's 30 x 60 is over
    windows = _windows(topo, g, threshold=500)
    rng = np.random.default_rng(9)
    for s, d in topo.edges:
        src, dst = _hop(rng, topo, s, d, 400)
        took = windows[0].record_send_pairs(src, dst)
        assert took == (400 if s == 0 else 0)
        for w in windows[1:]:
            w.record_send_pairs(src, dst)
    _assert_same(windows)


def test_blocks_read_back_in_pair_order():
    topo = jobs.real_job_3(keygroups_per_op=5)
    lay = _layout(topo, topo.num_keygroups)
    assert lay.size == 5 * 5 + 5 * 10
    src = np.array([5, 5, 9, 0, 5], dtype=np.int64)
    dst = np.array([19, 10, 14, 5, 10], dtype=np.int64)
    code, held = lay.codes(src, dst)
    assert held is not None and held.all()
    src_b, dst_b, n = lay.pairs(np.bincount(code, minlength=lay.size))
    assert list(zip(src_b.tolist(), dst_b.tolist(), n.tolist())) == [
        (0, 5, 1), (5, 10, 2), (5, 19, 1), (9, 14, 1)]


# ------------------------------------------------------------------ engine
def _engine(job):
    spec = synthetic.StreamSpec(rate=600.0, seed=5)
    if job == "job3":
        topo, cfg = jobs.real_job_3(keygroups_per_op=8), ExecutionConfig.jit()
        feed, src = synthetic.airline_stream(spec), "airline"
    else:
        topo, cfg = jobs.real_job_1(keygroups_per_op=8, window_ticks=1.0), ExecutionConfig.typed()
        feed, src = synthetic.wiki_edit_stream(spec), "wiki"
    eng = Engine(topo, 4, config=cfg, service_rate=1e9, seed=0, device="cpu")
    eng.spans = []
    for _ in range(6):
        eng.push_source(src, *next(feed))
        eng.tick()
    return eng


@pytest.mark.parametrize("job", sorted(JOBS))
def test_engine_counts_every_attributed_entry_dense(job):
    eng = _engine(job)
    m = eng.metrics
    assert m.pair_sparse_entries == 0
    assert m.pair_dense_entries == m.cross_node_tuples + m.intra_node_tuples > 0
    stats_spans = [e - s for n, s, e in eng.spans if n.startswith("route.stats:")]
    assert m.stats_seconds == pytest.approx(sum(stats_spans), rel=1e-9, abs=1e-12)
    assert len(stats_spans) > 0 and m.stats_seconds > 0
    n_before = len(eng.spans)
    state = eng.end_period()
    folds = [sp for sp in eng.spans[n_before:] if sp[0] == "fold.pairs"]
    assert len(folds) == 1 and folds[0][1] < folds[0][2]
    assert state.out_pairs.total() == m.pair_dense_entries


def _split_topo(mod, kgs=8):
    def count_op(state, keys, values, ts):
        for k in keys.tolist():
            state[k] = state.get(k, 0) + 1
        return state, list(zip(keys.tolist(), [1] * len(keys), ts.tolist()))

    def sum_sink(state, keys, values, ts):
        for k, v in zip(keys.tolist(), values.tolist()):
            state[k] = state.get(k, 0) + v
        return state, None

    def merge(a, b):
        return {k: a.get(k, 0) + b.get(k, 0) for k in {**a, **b}}

    t = mod.Topology()
    t.add_operator(mod.OperatorSpec("src", None, num_keygroups=kgs, is_source=True))
    t.add_operator(mod.OperatorSpec("count", count_op, num_keygroups=kgs, merge_state=merge))
    t.add_operator(mod.OperatorSpec("sink", sum_sink, num_keygroups=kgs, is_sink=True))
    t.connect("src", "count")
    t.connect("count", "sink")
    return t


def test_engine_with_replicas_counts_sparse_entries_and_equals_the_reference():
    """A split hot key group's replicas lie outside every block: their
    entries take the sparse path, and the fold equals the reference's."""
    engines = [
        Engine(_split_topo(port_topology), 4, config=ExecutionConfig.split(4),
               service_rate=1e9, seed=0, device="cpu"),
        ref_engine.Engine(_split_topo(ref_topology), 4,
                          config=ref_engine.ExecutionConfig.split(4), service_rate=1e9, seed=0),
    ]
    for eng in engines:
        hot = int(eng.topology.keygroups_of(1, np.array([3], dtype=np.int64), None)[0])
        eng.split_keygroup(hot)
        rng = np.random.default_rng(7)
        for t in range(10):
            keys = np.where(rng.random(300) < 0.5, 3, rng.integers(0, 1000, 300))
            eng.push_source("src", keys.astype(np.int64), rng.random(300), np.full(300, float(t)))
            eng.tick()
    m = engines[0].metrics
    assert m.pair_sparse_entries > 0 and m.pair_dense_entries > 0
    assert m.pair_sparse_entries + m.pair_dense_entries == m.cross_node_tuples + m.intra_node_tuples
    port, ref = (eng.end_period().out_pairs for eng in engines)
    for f in ("src", "dst", "rate"):
        assert np.array_equal(getattr(port, f), getattr(ref, f)), f
