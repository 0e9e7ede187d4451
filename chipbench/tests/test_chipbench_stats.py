"""The frozen arithmetic against hand-worked cases."""

import pytest

from chipbench import stats


def test_union_busy_and_idle_gaps():
    iv = [(1.0, 1.5), (1.4, 2.0), (3.0, 3.2), (5.0, 6.0)]
    assert stats.union(iv) == [(1.0, 2.0), (3.0, 3.2), (5.0, 6.0)]
    assert stats.busy_seconds(iv, 0.0, 4.0) == pytest.approx(1.2)
    assert stats.busy_seconds(iv, 1.25, 5.5) == pytest.approx(0.75 + 0.2 + 0.5)
    assert stats.idle_gaps(iv, 0.0, 4.0) == [(0.0, 1.0), (2.0, 3.0), (3.2, 4.0)]
    assert stats.idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_routing_byte_counts():
    # 2^20 int64 keys in, int64 ids out, 1,000 int64 counts: 16 MiB + 8,000 B.
    assert stats.partition_bytes(1 << 20, 1, 1000) == 16 * (1 << 20) + 8000
    assert stats.partition_bytes(10, 3, 4) == 160 + 96
    # int16 codes up to 32,767 buckets, int32 above; int64 order.
    assert stats.sort_bytes(100, 16_000) == 1000
    assert stats.sort_bytes(100, 40_000) == 1200


def test_roofline_percent():
    # 3.35 GB at 3.35 TB/s is 1 ms: 1 ms measured is 100 %, 2 ms 50 %.
    assert stats.roofline_percent(3_350_000_000, 1e-3) == pytest.approx(100.0)
    assert stats.roofline_percent(3_350_000_000, 2e-3) == pytest.approx(50.0)
    assert stats.roofline_percent(0, 1e-3) is None
    assert stats.roofline_percent(10, 0.0) is None


def test_breakdown_names_idle_time_by_host_span():
    from chipbench.trace import breakdown

    device = [("k1", 1.0, 1.5), ("k2", 1.4, 2.0), ("memcpy", 3.0, 3.2), ("k1", 3.5, 3.6)]
    spans = [("tick", 0.5, 2.5), ("push_source", 2.5, 2.9), ("end_period", 2.8, 3.4)]
    out = breakdown(device, spans, 0.0, 4.0)
    ops = dict(out["device_ops"])
    assert ops["k1"] == pytest.approx(0.6) and ops["k2"] == pytest.approx(0.6)
    # Idle: [0, 1], [2, 3], [3.2, 3.5], [3.6, 4]; end_period keeps only 2.9-3.4.
    idle = dict(out["idle_gaps"])
    assert idle["tick"] == pytest.approx(0.5 + 0.5)
    assert idle["push_source"] == pytest.approx(0.4)
    assert idle["end_period"] == pytest.approx(0.1 + 0.2)
    assert idle["harness"] == pytest.approx(0.5 + 0.1 + 0.4)
    assert [v for _, v in out["idle_gaps"]] == sorted(idle.values(), reverse=True)


def test_merged_timeline_gives_each_instant_to_the_innermost_span():
    """The harness's spans around the program's, through the program's
    ``flatten``: a tick's routing inside the harness's ``tick``, ALBIC's
    solves inside ``adapt``."""
    from repro_torch.engine.tracing import flatten

    harness = [("tick", 0.0, 10.0), ("adapt", 10.0, 14.0), ("solve", 11.0, 12.5),
               ("solve", 12.5, 13.0), ("end_period", 14.0, 15.0)]
    program = [("tick", 0.1, 9.9), ("route:extract", 1.0, 4.0), ("route.gather:extract", 2.0, 3.0),
               ("jit", 5.0, 6.5), ("flush:extract", 6.0, 7.0)]  # the last reaches past its parent
    got = flatten(harness + program)
    assert got == [("tick", 0.0, 0.1), ("tick", 0.1, 1.0), ("route:extract", 1.0, 2.0),
                   ("route.gather:extract", 2.0, 3.0), ("route:extract", 3.0, 4.0),
                   ("tick", 4.0, 5.0), ("jit", 5.0, 6.0), ("flush:extract", 6.0, 6.5),
                   ("tick", 6.5, 9.9), ("tick", 9.9, 10.0), ("adapt", 10.0, 11.0),
                   ("solve", 11.0, 12.5), ("solve", 12.5, 13.0), ("adapt", 13.0, 14.0),
                   ("end_period", 14.0, 15.0)]
    # Disjoint, in order, and covering exactly the top-level spans.
    assert all(a[2] <= b[1] for a, b in zip(got, got[1:]))
    assert sum(e - s for _, s, e in got) == pytest.approx(15.0)
    assert flatten([]) == []


def test_breakdown_over_the_merged_timeline_splits_the_controller_from_the_tick():
    """The merged split names the program's spans and the solves; the
    harness's own split, the breakdown's ``idle_gaps``, keeps ``adapt``
    whole and knows no program span."""
    from repro_torch.engine.tracing import flatten

    from chipbench.trace import breakdown

    device = [("k", 0.5, 1.0)]
    harness = [("tick", 0.0, 4.0), ("adapt", 4.0, 7.0), ("solve", 5.0, 6.0),
               ("end_period", 7.0, 8.0)]
    program = [("tick", 0.0, 4.0), ("route:airline", 1.0, 2.0), ("jit", 2.0, 3.0)]
    idle = dict(breakdown(device, flatten(harness + program), 0.0, 9.0)["idle_gaps"])
    assert idle == pytest.approx({"tick": 1.5, "route:airline": 1.0, "jit": 1.0, "adapt": 2.0,
                                  "solve": 1.0, "end_period": 1.0, "harness": 1.0})
    own = dict(breakdown(device, harness, 0.0, 9.0)["idle_gaps"])
    assert own == pytest.approx({"tick": 3.5, "adapt": 3.0, "end_period": 1.0, "harness": 1.0})
