"""The frozen hash against the port's, and the plain references against
hand-worked batches of Real Jobs 3 and 1."""

import numpy as np
import pytest

from chipbench.gen import streams
from chipbench.reference import hashing, real_job_1, real_job_3

LIMITS3 = {"count_err": 0, "arrival_err": 0, "key_err": 0, "sum_err": 1e-10}
LIMITS1 = {"count_err": 0, "arrival_err": 0, "state_err": 0, "ranking_err": 0}


def test_frozen_hash_equals_the_ports():
    topology = pytest.importorskip("repro_torch.engine.topology")
    keys = np.array([0, 1, 7, 4_000, 2**31 + 5, -3, 2**62 + 11], dtype=np.int64)
    assert np.array_equal(hashing.mix32(keys), topology.mix32(keys).astype(np.uint64))
    for k in keys.tolist() + ["gh7xy", "global", np.str_("u3buv")]:
        assert hashing.hash_key(k) == topology.hash_key(k)
    assert np.array_equal(hashing.int_keygroups(keys, 1000, 1000),
                          topology._mixed_keygroups(topology.mix32(keys), 1000, 1000))


def _airline(rows):
    v = np.zeros(len(rows), dtype=streams.AIRLINE_DTYPE)
    for i, (plane, origin, dest, dep, arr, year) in enumerate(rows):
        v[i] = (plane, origin, dest, dep, arr, year)
    return v["plane"].copy(), v, np.zeros(len(rows))


CFG3 = {"keygroups_per_op": 8,
        "generator": {"params": {"num_airplanes": 4000, "num_airports": 300}}}


def _job3_batch():
    return _airline([(1, 10, 20, 5.0, 1.5, 2004),
                     (1, 10, 21, -2.0, 0.25, 2004),
                     (1, 10, 20, 3.0, 3.0, 2005),
                     (2, 10, 20, 0.5, 0.5, 2004)])


def test_job3_reference_by_hand():
    ref = real_job_3.Reference(CFG3, np.zeros(32, dtype=np.int64))
    ref.admit(*_job3_batch())
    prog = ref.as_program()
    k = 8
    kg = lambda key, hop: hashing.keygroup_of(key, hop * k, k)  # noqa: E731
    want = {}
    for (plane, year), s in {(1, 2004): 6.5 + -1.75, (1, 2005): 6.0, (2, 2004): 1.0}.items():
        want.setdefault(kg(plane, 2), {}).setdefault("sums", {})[(plane, year)] = s
    for (o, d), s in {(10, 20): 6.5 + 6.0 + 1.0, (10, 21): -1.75}.items():
        want.setdefault(kg(o * 300 + d, 3), {}).setdefault("route_sums", {})[(o, d)] = s
    got = {i: st for i, st in enumerate(prog["states"]) if st}
    assert got == want
    arrivals = np.zeros(32, dtype=np.int64)
    for plane, o, d in ((1, 10, 20), (1, 10, 21), (1, 10, 20), (2, 10, 20)):
        for hop, key in enumerate((plane, plane, plane, o * 300 + d)):
            arrivals[kg(key, hop)] += 1
    assert np.array_equal(prog["arrivals"], arrivals)
    assert prog["counts"] == {"processed_tuples": 16, "emitted_tuples": 16, "sink_tuples": 8}
    assert all(v == 0 for _, v, _ in real_job_3.compare(prog, ref, LIMITS3))


def test_job3_compare_catches_each_fault():
    ref = real_job_3.Reference(CFG3, np.zeros(32, dtype=np.int64))
    ref.admit(*_job3_batch())

    def broken(edit):
        prog = ref.as_program()
        prog["states"] = [{f: dict(d) for f, d in st.items()} for st in prog["states"]]
        edit(prog)
        return {n: v for n, v, _ in real_job_3.compare(prog, ref, LIMITS3)}

    def holder(prog, field, key):
        return next(st[field] for st in prog["states"] if key in st.get(field, {}))

    assert broken(lambda p: p["counts"].update(sink_tuples=7))["count_err"] == 1
    assert broken(lambda p: p["arrivals"].__setitem__(0, 99))["arrival_err"] == 1
    assert broken(lambda p: holder(p, "sums", (1, 2005)).pop((1, 2005)))["key_err"] == 1
    assert broken(lambda p: holder(p, "route_sums", (10, 20)).update({(10, 20): 13.5 + 1e-6}))[
        "sum_err"] > 1e-10


def test_job1_reference_by_hand():
    """One key group an operator: articles 3, 5, 3 at tick 0; 5, 7 at 1; 9 at 2."""
    cfg = {"keygroups_per_op": 1, "topology": {"kwargs": {"topk": 10, "window_ticks": 1.0}},
           "generator": {"params": {"num_articles": 10}}}
    ref = real_job_1.Reference(cfg, np.zeros(4, dtype=np.int64))
    for t, arts in enumerate(([3, 5, 3], [5, 7], [9])):
        a = np.array(arts, dtype=np.int64)
        v = np.zeros(len(a), dtype=streams.WIKI_DTYPE)
        v["article"] = a
        ref.admit(a, v, np.full(len(a), float(t)))
    ref.finish()
    # TopK: tick 1's first tuple (5) closes {3: 2, 5: 2}; tick 2's (9)
    # closes {7: 1, 9: 1}.  Global: opens on the first ranking at ts 1; the
    # second (ts 2) closes it.
    assert ref.windows == 2
    assert ref.rankings == [("global", {"top": [(3, 2), (5, 2), (7, 1), (9, 1)]}, 2.0)]
    assert ref.states[2] == {"counts": {}, "w_start": 2.0}
    assert ref.states[3] == {"counts": {}, "w_start": 2.0}
    assert ref.arrivals.tolist() == [6, 6, 6, 2]
    prog = ref.as_program()
    assert prog["counts"] == {"processed_tuples": 20, "emitted_tuples": 15, "sink_tuples": 1}
    assert all(v == 0 for _, v, _ in real_job_1.compare(prog, ref, LIMITS1))
    prog["sink_outputs"] = [("global", {"top": [(3, 2), (5, 2), (9, 1), (7, 1)]}, 2.0)]
    assert dict((n, v) for n, v, _ in real_job_1.compare(prog, ref, LIMITS1))["ranking_err"] == 1


def test_job1_reference_matches_the_engine_by_hand():
    """The same three ticks through the port's engine on the CPU."""
    pytest.importorskip("torch")
    from repro_torch.data.jobs import make_real_job_1
    from repro_torch.engine import Engine, ExecutionConfig

    eng = Engine(make_real_job_1(keygroups_per_op=1, topk=10, window_ticks=1.0), 1,
                 config=ExecutionConfig.typed(), initial_alloc=np.zeros(4, dtype=np.int64),
                 service_rate=1e12, device="cpu")
    for t, arts in enumerate(([3, 5, 3], [5, 7], [9])):
        a = np.array(arts, dtype=np.int64)
        v = np.zeros(len(a), dtype=streams.WIKI_DTYPE)
        v["article"] = a
        eng.push_source("wiki", a, v, np.full(len(a), float(t)))
        eng.tick()
    for _ in range(4):
        eng.tick()
    assert eng.metrics.sink_outputs == [("global", {"top": [(3, 2), (5, 2), (7, 1), (9, 1)]},
                                         2.0)]
    assert eng.store.get(2) == {"counts": {}, "w_start": 2.0}
