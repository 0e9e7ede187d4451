"""The port engine's spans and layer counters (``Engine.spans``,
``EngineMetrics``' host seconds, ``repro_torch.engine.tracing``) on the CPU.

Real Job 3 under ``.jit()`` and Real Job 1 under ``.typed()`` at a small
size: each counter runs where its work ran and reads 0 where none did;
each equals the sum of its spans' durations, or their self time; every
span lies inside a ``tick`` or ``admit`` span; ``flatten`` lays them out
disjoint and complete; recording spans changes no result; and a
two-worker engine folds every worker's ``route_seconds``.
"""

from __future__ import annotations

import pickle

import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import jobs, synthetic  # noqa: E402
from repro_torch.engine import Engine, ExecutionConfig, make_engine  # noqa: E402
from repro_torch.engine.tracing import flatten  # noqa: E402

TICKS = 6  # the four-operator pipelines fill by the fifth tick
JIT_COUNTERS = ("jit_seconds", "jit_put_seconds", "jit_call_seconds", "jit_fetch_seconds")


def _job(name: str, service_rate: float = 1e9):
    """A small engine on one of the two jobs, and its source's feed."""
    spec = synthetic.StreamSpec(rate=600.0, seed=5)
    if name == "job3":
        topo = jobs.real_job_3(keygroups_per_op=8)
        cfg, feed, src = ExecutionConfig.jit(), synthetic.airline_stream(spec), "airline"
    else:
        topo = jobs.real_job_1(keygroups_per_op=8, window_ticks=1.0)
        cfg, feed, src = ExecutionConfig.typed(), synthetic.wiki_edit_stream(spec), "wiki"
    eng = Engine(topo, 4, config=cfg, service_rate=service_rate, seed=0, device="cpu")
    return eng, feed, src


def _drive(eng, feed, src, ticks: int = TICKS, spans: bool = True):
    if spans:
        eng.spans = []
    for _ in range(ticks):
        eng.push_source(src, *next(feed))
        eng.tick()
    return eng


def _traced(name: str, service_rate: float = 1e9):
    return _drive(*_job(name, service_rate))


def _dur(spans) -> float:
    return sum(e - s for _, s, e in spans)


def _parents(spans) -> list:
    """Each span's parent: the smallest other span that encloses it."""
    out = []
    for i, (_, s, e) in enumerate(spans):
        enclosing = [j for j, (_, s2, e2) in enumerate(spans)
                     if j != i and s2 <= s and e <= e2 and (e2 - s2, j) > (e - s, i)]
        out.append(min(enclosing, key=lambda j: spans[j][2] - spans[j][1], default=None))
    return out


def _named(spans, prefix: str) -> list:
    return [sp for sp in spans if sp[0] == prefix or sp[0].startswith(prefix + ":")]


def _approx(x):
    return pytest.approx(x, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("name", ["job3", "job1"])
def test_counters_run_where_their_work_ran(name):
    eng = _traced(name)
    m = eng.metrics
    ops = range(len(eng.topology.operators))
    assert m.admit_seconds > 0 and m.flush_seconds > 0
    assert set(m.route_seconds) == set(m.routed_batches) == set(ops)
    assert all(v > 0 for v in m.route_seconds.values())
    assert sum(m.route_seconds.values()) > m.device_route_seconds > 0
    if name == "job3":
        assert m.op_seconds == {}  # every body runs in the compiled tier
        assert all(getattr(m, f) > 0 for f in JIT_COUNTERS)
        assert m.jit_seconds > m.jit_put_seconds + m.jit_call_seconds + m.jit_fetch_seconds
    else:
        bodies = {i for i, o in enumerate(eng.topology.operators) if o.fn_seg is not None}
        assert set(m.op_seconds) == bodies and all(v > 0 for v in m.op_seconds.values())
        assert all(getattr(m, f) == 0.0 for f in JIT_COUNTERS)


# job3 at a binding service rate: segments split by the budget take the
# per-run path, whose fallbacks force the compiled tier's flush inside an
# operator body's span.
CASES = [("job3", 1e9), ("job1", 1e9), ("job3", 300.0)]


@pytest.mark.parametrize("name,service_rate", CASES)
def test_counters_equal_their_spans(name, service_rate):
    eng = _traced(name, service_rate)
    m, spans = eng.metrics, eng.spans
    names = [o.name for o in eng.topology.operators]
    parent = _parents(spans)

    def self_time(prefix):
        own = _named(spans, prefix)
        kids = [sp for sp, p in zip(spans, parent) if p is not None and spans[p] in own]
        return _dur(own) - _dur(kids)

    assert m.admit_seconds == _approx(self_time("admit"))
    for f in ("jit", "jit.put", "jit.call", "jit.fetch", "flush"):
        assert getattr(m, f.replace(".", "_") + "_seconds") == _approx(_dur(_named(spans, f)))
    assert m.device_route_seconds == _approx(_dur(_named(spans, "route.device")))
    assert m.gather_seconds == _approx(self_time("route.gather"))
    for op, secs in m.route_seconds.items():
        assert secs == _approx(_dur(_named(spans, f"route:{names[op]}")))
    for op, secs in m.op_seconds.items():
        assert secs == _approx(self_time(f"op:{names[op]}"))
    assert {sp[0] for sp in spans} >= {"tick", "admit"}
    if service_rate < 1e3:
        # The per-run fallback ran: a jit span inside an operator body's.
        assert any(sp[0] == "jit" and p is not None and spans[p][0].startswith("op:")
                   for sp, p in zip(spans, parent))


@pytest.mark.parametrize("name,service_rate", CASES)
def test_spans_nest_and_flatten_lays_them_out(name, service_rate):
    spans = _traced(name, service_rate).spans
    parent = _parents(spans)
    tops = [sp for sp, p in zip(spans, parent) if p is None]
    assert {sp[0] for sp in tops} == {"tick", "admit"}
    for sp, p in zip(spans, parent):
        if p is not None:  # a child lies wholly inside its parent
            assert spans[p][1] <= sp[1] and sp[2] <= spans[p][2]
    flat = flatten(spans)
    assert all(s < e for _, s, e in flat)
    assert all(a[2] <= b[1] for a, b in zip(flat, flat[1:]))  # disjoint, in order
    assert _dur(flat) == pytest.approx(_dur(tops), rel=1e-12)
    assert {n for n, _, _ in flat} <= {sp[0] for sp in spans}
    # Each instant goes to the innermost open span: a route's device round
    # trip keeps its whole interval, its enclosing route keeps none of it.
    dev = _named(spans, "route.device")
    assert _dur(_named(flat, "route.device")) == pytest.approx(_dur(dev), rel=1e-9)


def test_flatten_by_hand():
    spans = [("tick", 0.0, 10.0), ("route:a", 1.0, 4.0), ("route.device:a", 2.0, 3.0),
             ("jit", 5.0, 9.0), ("jit.put:b", 5.0, 6.0), ("admit", 11.0, 12.0)]
    assert flatten(spans) == [
        ("tick", 0.0, 1.0), ("route:a", 1.0, 2.0), ("route.device:a", 2.0, 3.0),
        ("route:a", 3.0, 4.0), ("tick", 4.0, 5.0), ("jit.put:b", 5.0, 6.0),
        ("jit", 6.0, 9.0), ("tick", 9.0, 10.0), ("admit", 11.0, 12.0)]
    assert flatten([]) == []


@pytest.mark.parametrize("name,service_rate", CASES)
def test_spans_change_no_result(name, service_rate):
    def result(spans):
        eng, feed, src = _job(name, service_rate)
        _drive(eng, feed, src, spans=spans)
        eng.end_period()  # the compiled tier's columns fold into the store
        m = eng.metrics
        return ((m.processed_tuples, m.emitted_tuples, m.sink_tuples),
                pickle.dumps([st for _, st in eng.store.items()]),
                pickle.dumps(m.sink_outputs))

    on, off = result(True), result(False)
    assert on[0][0] > 0 and on[0][1] > 0
    assert on == off


def test_two_workers_fold_route_seconds():
    topo = jobs.real_job_3(keygroups_per_op=8)
    eng = make_engine(topo, 4, config=ExecutionConfig.workers(2, shm=0), service_rate=1e9,
                      seed=0, device="cpu", timeout=60.0)
    try:
        feed = synthetic.airline_stream(synthetic.StreamSpec(rate=600.0, seed=5))
        for _ in range(3):
            eng.push_source("airline", *next(feed))
            eng.tick()
        eng.end_period()
    finally:
        eng.finalize()
    m = eng.metrics
    ops = set(range(len(topo.operators)))
    assert set(m.routed_batches) == ops
    assert set(m.route_seconds) == ops and all(v > 0 for v in m.route_seconds.values())
    assert sum(m.route_seconds.values()) > m.device_route_seconds > 0
    assert m.flush_seconds > 0
    bodies = {i for i, o in enumerate(topo.operators) if o.fn_seg is not None}
    assert set(m.op_seconds) == bodies and all(v > 0 for v in m.op_seconds.values())
