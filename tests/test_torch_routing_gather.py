"""Routing's gather after the composite sort (``repro_torch.engine.permute``)
on the CPU.

``permute_columns`` against ``col[order]``, byte for byte and dtype for
dtype, for every column a cell routes, on both sides of the size at which
the gather splits over threads; its results own their memory; the engine
counts which path each column took, and the gather's seconds as the self
time of its spans; a forked child and concurrent callers gather right.
"""

from __future__ import annotations

import multiprocessing
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import jobs, synthetic  # noqa: E402
from repro_torch.engine import Engine, ExecutionConfig, make_engine, permute  # noqa: E402
from repro_torch.engine.permute import permute_columns, takes_view  # noqa: E402

CHUNK = permute.CHUNK_MIN_TUPLES
# Empty, one tuple, small, just under and at the size that splits over two
# threads, and one split over three.
SIZES = [0, 1, 37, 2 * CHUNK - 1, 2 * CHUNK, 3 * CHUNK + 5]

DTYPES = {
    "int64": np.dtype(np.int64),
    "int32": np.dtype(np.int32),
    "float64": np.dtype(np.float64),
    "airline": synthetic.AIRLINE_DTYPE,
    "extract": jobs.EXTRACT_SCHEMA.value,
    "route": jobs.ROUTE_SCHEMA.value,
    "wiki": synthetic.WIKI_DTYPE,
    "geo": jobs.GEO_SCHEMA.value,
    "U5": np.dtype("U5"),
}


def _column(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """A column of ``n`` items: random bytes in a native dtype, Python
    objects, or a strided view of a wider record."""
    if kind == "object":
        col = np.empty(n, dtype=object)
        col[:] = [{"top": [(int(i), 1)]} if i % 2 else (i, "x") for i in range(n)]
        return col
    if kind == "strided":
        wide = _column("airline", n, rng)
        return wide["dep_delay"]
    dtype = DTYPES[kind]
    col = np.empty(n, dtype)
    raw = col.view(np.uint8).reshape(n, dtype.itemsize)
    raw[:] = rng.integers(0, 256, raw.shape, dtype=np.uint8)
    if kind == "U5":  # valid code points, some strings shorter than 5
        col[:] = rng.integers(0, 10**5, n).astype("U5")
    return col


def _order(n: int, rng: np.random.Generator, kind: str) -> np.ndarray:
    if kind == "perm":  # what the composite sort gives: a stable argsort
        return np.argsort(rng.integers(0, 64, n), kind="stable")
    return rng.integers(-n, n, n) if n else np.zeros(0, np.int64)  # repeats, negatives


KINDS = [*DTYPES, "object", "strided"]


@pytest.mark.parametrize("order_kind", ["perm", "any"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_gather_is_fancy_indexing_byte_for_byte(kind, n, order_kind):
    rng = np.random.default_rng([n, len(kind)])
    col = _column(kind, n, rng)
    order = _order(n, rng, order_kind)
    (got,) = permute_columns(order, col)
    want = col[order]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", SIZES)
def test_three_columns_at_once(n):
    rng = np.random.default_rng(n)
    cols = (_column("int64", n, rng), _column("airline", n, rng), _column("float64", n, rng))
    order = _order(n, rng, "perm")
    got = permute_columns(order, *cols)
    assert [(g.dtype, g.tobytes()) for g in got] == [(c.dtype, c[order].tobytes()) for c in cols]


@pytest.mark.parametrize("n", [1, 2 * CHUNK])
@pytest.mark.parametrize("kind", ["int64", "airline", "geo", "object", "strided"])
def test_results_own_their_memory(kind, n):
    rng = np.random.default_rng(n)
    col = _column(kind, n, rng)
    keys = _column("int64", n, rng)
    order = _order(n, rng, "perm")
    outs = permute_columns(order, keys, col)
    for out, src in zip(outs, (keys, col)):
        assert out.base is None and out.flags.owndata
        assert not np.shares_memory(out, src)
    assert not np.shares_memory(outs[0], outs[1])


@pytest.mark.parametrize(
    "kind,view",
    [("int64", True), ("airline", True), ("wiki", True), ("geo", True), ("U5", True),
     ("object", False), ("strided", False)],
)
def test_which_columns_take_the_view(kind, view):
    assert takes_view(_column(kind, 8, np.random.default_rng(0))) is view


def _engine(name: str, cfg: ExecutionConfig) -> Engine:
    """A small engine on Real Job 3 or 1, driven for six ticks."""
    spec = synthetic.StreamSpec(rate=600.0, seed=5)
    if name == "job3":
        topo, feed, src = jobs.real_job_3(keygroups_per_op=8), synthetic.airline_stream(spec), "airline"
    else:
        topo = jobs.real_job_1(keygroups_per_op=8, window_ticks=1.0)
        feed, src = synthetic.wiki_edit_stream(spec), "wiki"
    eng = Engine(topo, 4, config=cfg, service_rate=1e9, seed=0, device="cpu")
    for _ in range(6):
        eng.push_source(src, *next(feed))
        eng.tick()
    return eng


# Job 3 and job 1 as their cells run them route native columns only (job
# 1's global TopK has one key, so its hop needs no permutation); job 1 on
# the untyped path routes object values.
@pytest.mark.parametrize(
    "name,cfg,objects",
    [("job3", ExecutionConfig.jit(), False), ("job1", ExecutionConfig.typed(), False),
     ("job1", ExecutionConfig.seg(), True)],
)
def test_engine_counts_each_path(name, cfg, objects):
    m = _engine(name, cfg).metrics
    gathers = sum(m.sort_kernel_batches.values())
    assert gathers > 0 and m.gather_seconds > 0
    assert m.gather_view_columns + m.gather_object_columns == 3 * gathers
    assert m.gather_view_columns > 0
    assert (m.gather_object_columns > 0) is objects


def test_two_workers_fold_the_gather_counters():
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
    assert m.gather_seconds > 0 and m.gather_view_columns > 0
    assert m.gather_object_columns == 0


def _child_gathers(conn) -> None:
    rng = np.random.default_rng(1)
    col = _column("airline", 4 * CHUNK, rng)
    order = _order(4 * CHUNK, rng, "perm")
    (got,) = permute_columns(order, col)
    conn.send((got.tobytes() == col[order].tobytes(), permute._pool[0]))
    conn.close()


@pytest.mark.skipif(sys.platform != "linux", reason="fork start method")
def test_forked_child_builds_its_own_pool():
    rng = np.random.default_rng(0)
    col = _column("airline", 4 * CHUNK, rng)
    permute_columns(_order(4 * CHUNK, rng, "perm"), col)  # the parent's pool
    ctx = multiprocessing.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_child_gathers, args=(send,))
    proc.start()
    send.close()
    assert recv.poll(60), "the child gave no answer"
    same, pool_pid = recv.recv()
    proc.join(30)
    assert not proc.is_alive() and proc.exitcode == 0
    assert same and pool_pid == proc.pid


def test_concurrent_callers_share_the_pool():
    rng = np.random.default_rng(2)
    n = 3 * CHUNK
    cols = (_column("int64", n, rng), _column("extract", n, rng), _column("float64", n, rng))
    orders = [_order(n, np.random.default_rng(i), "perm") for i in range(16)]
    wrong, errors = [], []

    def gather(order):
        try:
            got = permute_columns(order, *cols)
            if [g.tobytes() for g in got] != [c[order].tobytes() for c in cols]:
                wrong.append(order)
        except Exception as e:  # surfaced below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=gather, args=(o,)) for o in orders]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and wrong == []
