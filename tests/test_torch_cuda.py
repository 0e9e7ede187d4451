"""The port's CUDA kernels and engine on the card (marked ``gpu``).

The routing kernels are held bit-exact against their plain PyTorch versions
(integer outputs: no tolerance) at the engine's shapes, and a small Real
Job 3 run on the card against the port's CPU engine.  The attention kernels
are held against their plain versions at small shapes, in bf16 and f32, at
``tests/test_kernels.py``'s tolerances (f32 3e-5; bf16 3e-2, which also
covers the flash kernel's bf16 rounding of P before P·V), and one GLM-4-9B
SMOKE decode step on the card against ``device="cpu"``.  The radix sort is
also held on adversarial orders, across tile edges and back to back on one
stream.  The RG-LRU scan is held bit for bit against its plain version
(both round each product and sum to f32), the expert matmul at the bf16/f32
tolerances above, at ragged and full shapes and once per body of
``kernel_path``, and RecurrentGemma and Moonlight SMOKE prefill + decode on
the card against ``device="cpu"``.  The compiled tier's
``keyed_running_sum`` is held against its CPU run at 2^16 tuples through
table growth, and a ``.jit()`` engine ticks under
``torch.cuda.set_sync_debug_mode("error")``: only its declared reads (the
runtime's one per call, routing's downloads) may synchronize.  The fused
superstep (a record pipeline, both routing modes) equals the card's
``.jit()`` engine through fused ticks, a migration and K-tick scans; its
captured scan replays bit-identical to the same loop run eagerly, with both
routing kernels inside the graph held against their plain versions; and
its ticks and scans raise nothing under the sync debug mode.  The
multi-worker runtime routes on the card from four worker processes, forked
in a fresh interpreter, equal to the single-process card engine, and
refuses ``device="cuda"`` once its caller has initialized CUDA.  Without a
card every test here skips.  On
the card: ``python -m pytest -m gpu tests/test_torch_cuda.py`` (this file
imports neither jax nor the reference package).
"""

import pickle

import numpy as np
import pytest

# CI's tier-1 job installs no torch: skip this module there, not fail collection.
torch = pytest.importorskip("torch")

from repro_torch.kernels import (
    bucket_argsort,
    decode_attention,
    flash_attention,
    keygroup_partition,
    launch_counts,
    moe_gemm,
    reset_launch_counts,
    rglru_scan,
)
from repro_torch.kernels.keygroup_partition import fold_keys64
from repro_torch.kernels.keygroup_partition.ref import keygroup_partition_ref
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.moe_gemm.ops import kernel_path
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.radix_sort.ops import plan as radix_plan
from repro_torch.kernels.radix_sort.ref import bucket_argsort_ref
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _keys(n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int64:
        return torch.randint(-(2**63), 2**63 - 1, (n,), dtype=torch.int64, generator=g)
    return torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int64, generator=g).to(
        torch.int32
    )


def _partition_equal(keys, nkg, base=0):
    """One launch on the card, ids and histogram equal to the plain version."""
    reset_launch_counts()
    ids, hist = keygroup_partition(keys, nkg, base=base)
    assert launch_counts()["keygroup_partition"] == 1
    r_ids, r_hist = keygroup_partition_ref(fold_keys64(keys.cpu()), nkg)
    assert torch.equal(ids.cpu(), r_ids + base)
    assert torch.equal(hist.cpu(), r_hist)
    return ids, hist


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32], ids=["i8", "i4"])
@pytest.mark.parametrize(
    "n,nkg,base",
    [(1, 1, 0), (7, 3, 0), (257, 32, 32), (2000, 257, 5), (4096, 4096, 0),
     (100_000, 60_000, 1), (1 << 20, 1000, 3000),
     # n of 1-3 and one off a multiple of either vector width (2 or 4 keys);
     # nkg either side of the shared-memory limit (51,200) and far past it.
     (2, 2, 0), (3, 3, 7), (4095, 1000, 0), (4097, 1000, 1), (8191, 2, 0),
     (70_001, 51_199, 0), (70_001, 51_200, 2), (70_001, 51_201, 0), (50_000, 65_537, 0)],
)
def test_partition_kernel_matches_plain(cuda, n, nkg, base, dtype):
    _partition_equal(_keys(n, dtype, n + nkg).to(cuda), nkg, base)


def _unmix32(h):
    """The inverse of the murmur3 finisher (each step is a bijection of
    uint32): keys whose hash is ``h``, as non-negative int64."""
    inv1, inv2, m = pow(0x85EBCA6B, -1, 2**32), pow(0xC2B2AE35, -1, 2**32), 2**32 - 1
    h = np.asarray(h, dtype=np.uint64)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(inv2)) & np.uint64(m)
    h ^= (h >> np.uint64(13)) ^ (h >> np.uint64(26))
    h = (h * np.uint64(inv1)) & np.uint64(m)
    h ^= h >> np.uint64(16)
    return torch.from_numpy(h.astype(np.int64))


@pytest.mark.parametrize("nkg", [1, 2, 3, 1000, 51_200, 65_537, 1_000_003])
def test_partition_kernel_edge_dividends(cuda, nkg):
    """Keys whose masked hash is 0, 2^31 - 1 and multiples of nkg +- 1 (with
    and without the masked top bit): the magic division's edges."""
    k = np.arange(0, 2**31 // nkg + 1, max(1, 2**31 // nkg // 300), dtype=np.int64) * nkg
    x = np.concatenate([[0, 1, 2**31 - 2, 2**31 - 1], k, k - 1, k + 1])
    x = x[(x >= 0) & (x < 2**31)]
    keys = _unmix32(np.concatenate([x, x + 2**31]))
    ids, _ = _partition_equal(keys.to(cuda), nkg)
    assert torch.equal(ids.cpu()[: len(x)], torch.from_numpy(x % nkg))


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32], ids=["i8", "i4"])
@pytest.mark.parametrize("kind", ["all_equal", "zipf", "airline"])
@pytest.mark.parametrize("nkg", [1000, 60_000])
def test_partition_kernel_skewed_keys(cuda, kind, nkg, dtype):
    """Every key equal (one bucket takes every warp's whole count), Zipf
    1.1 keys, and phase 3's airline plane ids (Zipf 1.2)."""
    n = 300_001
    rng = np.random.default_rng(nkg)
    if kind == "all_equal":
        keys = np.full(n, -12345, dtype=np.int64)
    elif kind == "zipf":
        keys = np.minimum(rng.zipf(1.1, size=n), 10**6).astype(np.int64) * 7919 - 10**6
    else:
        from repro_torch.data import StreamSpec, airline_stream

        keys = next(airline_stream(StreamSpec(rate=n, fluctuation=0.0, seed=0)))[0]
    _partition_equal(torch.from_numpy(keys).to(dtype).to(cuda), nkg, base=5)


@pytest.mark.parametrize("dtype,offset", [(torch.int64, 1), (torch.int32, 1), (torch.int32, 2),
                                          (torch.int32, 3)])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 10_001])
def test_partition_kernel_takes_unaligned_slices(cuda, dtype, offset, n):
    """A slice that starts off a 16-byte boundary: a scalar head, ids lined
    up with the keys."""
    from repro_torch.kernels.keygroup_partition.ops import kernel_path

    keys = _keys(n + offset, dtype, n).to(cuda)[offset:]
    assert keys.data_ptr() % 16 != 0
    assert kernel_path(1000, keys.element_size(), n, keys.data_ptr()) == "shared/scalar edges"
    _partition_equal(keys, 1000, base=3)


def test_partition_kernel_back_to_back_and_on_two_streams(cuda):
    """The kernel's scratch words (a ready flag, an arrival count) are 0
    again after every launch: launches queued without a sync, on one stream
    and on two, with each body."""
    keys = [_keys(n, torch.int64, n).to(cuda) for n in (1 << 20, 12_345, 777)]
    outs = [keygroup_partition(k, nkg) for k, nkg in zip(keys, (1000, 1000, 60_000))]
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        side_out = keygroup_partition(keys[0], 999)
    torch.cuda.synchronize()
    for k, nkg, (ids, hist) in zip(keys, (1000, 1000, 60_000), outs):
        r_ids, r_hist = keygroup_partition_ref(fold_keys64(k.cpu()), nkg)
        assert torch.equal(ids.cpu(), r_ids) and torch.equal(hist.cpu(), r_hist)
    r_ids, r_hist = keygroup_partition_ref(fold_keys64(keys[0].cpu()), 999)
    assert torch.equal(side_out[0].cpu(), r_ids) and torch.equal(side_out[1].cpu(), r_hist)


def test_partition_kernel_planted_flush_fault_shows(cuda):
    """A block's slice of its cluster's flush dropped: the ids stay right,
    the histogram does not (and the next launch is right again)."""
    from repro_torch.kernels.keygroup_partition import ops

    keys = _keys(1 << 20, torch.int64, 5).to(cuda)
    ids, hist = ops.launch(keys, 1000, drop_block=3)
    r_ids, r_hist = keygroup_partition_ref(fold_keys64(keys.cpu()), 1000)
    assert torch.equal(ids.cpu(), r_ids)
    assert not torch.equal(hist.cpu(), r_hist) and int(hist.sum()) < keys.numel()
    _partition_equal(keys, 1000)


@pytest.mark.parametrize(
    "n,nb,dtype",
    [(1, 1, torch.int32), (7, 3, torch.int32), (513, 16, torch.int32),
     (1024, 2, torch.int16), (2000, 257, torch.int32), (5000, 70_000, torch.int64),
     (1 << 20, 16_000, torch.int16), (1 << 20, 40_000, torch.int32),
     # Less than one tile (8,192 codes), either side of one tile, not a
     # multiple of the tile, and the digit widths of 1, 256, 257, 65,536
     # and 70,000 buckets.
     (100, 256, torch.int16), (8191, 2, torch.int32), (8193, 257, torch.int16),
     (50_000, 1, torch.int32), (100_001, 256, torch.int32), (100_001, 257, torch.int32),
     (200_000, 65_536, torch.int32), (300_007, 70_000, torch.int64)],
)
def test_sort_kernel_matches_plain(cuda, n, nb, dtype):
    g = torch.Generator().manual_seed(n + nb)
    codes = torch.randint(0, nb, (n,), generator=g).to(dtype)
    reset_launch_counts()
    order = bucket_argsort(codes.to(cuda), nb)
    # One bucket needs no pass: the order is arange, and nothing launches.
    assert launch_counts()["radix_sort"] == (1 if nb > 1 else 0)
    assert torch.equal(order.cpu(), bucket_argsort_ref(codes, nb))


def test_sort_kernel_all_equal_and_empty(cuda):
    codes = torch.full((5000,), 3, dtype=torch.int16, device=cuda)
    assert torch.equal(bucket_argsort(codes, 4).cpu(), torch.arange(5000))
    assert bucket_argsort(torch.empty(0, dtype=torch.int32, device=cuda), 4).numel() == 0


@pytest.mark.parametrize("nb", [256, 65_536, 70_000])
@pytest.mark.parametrize("kind", ["one_digit", "sorted", "reversed", "all_equal"])
def test_sort_kernel_adversarial_orders(cuda, kind, nb):
    """Every code in one digit of the first pass (its look-back carries one
    digit's whole count and every warp's lanes match), already sorted,
    reverse sorted, all equal."""
    n = 250_000
    g = torch.Generator().manual_seed(nb)
    if kind == "one_digit":
        bits = radix_plan(nb)[1]
        codes = (torch.randint(0, nb >> bits, (n,), generator=g) << bits) + 5
    elif kind == "sorted":
        codes = torch.sort(torch.randint(0, nb, (n,), generator=g)).values
    elif kind == "reversed":
        codes = torch.sort(torch.randint(0, nb, (n,), generator=g), descending=True).values
    else:
        codes = torch.full((n,), nb - 1)
    codes = codes.to(torch.int32)
    order = bucket_argsort(codes.to(cuda), nb)
    assert torch.equal(order.cpu(), bucket_argsort_ref(codes, nb))


def test_sort_kernel_back_to_back_on_one_stream(cuda):
    """Two sorts queued without a sync in between (and a third of another
    size): each starts from its own clean look-back state."""
    g = torch.Generator().manual_seed(7)
    a = torch.randint(0, 16_000, (1 << 20,), generator=g).to(torch.int16)
    b = torch.randint(0, 16_000, (1 << 20,), generator=g).to(torch.int16)
    c = torch.randint(0, 40_000, (12_345,), generator=g).to(torch.int32)
    orders = [bucket_argsort(x.to(cuda), nb) for x, nb in ((a, 16_000), (b, 16_000), (c, 40_000))]
    torch.cuda.synchronize()
    for x, nb, order in zip((a, b, c), (16_000, 16_000, 40_000), orders):
        assert torch.equal(order.cpu(), bucket_argsort_ref(x, nb))


def test_sort_kernel_skips_out_of_range_codes(cuda):
    """Codes outside [0, nb) take no slot: the in-range ones fill the first."""
    codes = torch.tensor([5, -1, 2, 9, 2, 0, 7], dtype=torch.int32)
    order = bucket_argsort(codes.to(cuda), 6).cpu()
    assert order[:4].tolist() == [5, 2, 4, 0]


def test_engine_on_card_matches_cpu(cuda):
    from repro_torch.data import StreamSpec, airline_stream, real_job_3
    from repro_torch.engine import Engine

    engines = [
        Engine(real_job_3(keygroups_per_op=50), 8, service_rate=1e9, device=d)
        for d in ("cuda", "cpu")
    ]
    feed = airline_stream(StreamSpec(rate=3000.0, seed=1))
    reset_launch_counts()
    for _ in range(6):
        k, v, ts = next(feed)
        for eng in engines:
            eng.push_source("airline", k, v, ts)
            eng.tick()
    for _ in range(4):
        for eng in engines:
            eng.tick()
    gpu, cpu = engines
    counts = launch_counts()
    assert counts["keygroup_partition"] > 0 and counts["radix_sort"] > 0
    assert gpu.metrics.sink_outputs == cpu.metrics.sink_outputs
    assert [pickle.dumps(s) for _, s in gpu.store.items()] == [
        pickle.dumps(s) for _, s in cpu.store.items()
    ]
    assert np.array_equal(gpu.window.kg_arrivals, cpu.window.kg_arrivals)
    assert gpu.metrics.partition_kernel_batches == gpu.metrics.routed_batches


def test_keyed_running_sum_on_card_matches_cpu(cuda):
    """2^16 tuples a call, four calls, the table grown before each as the
    runtime grows it (64 → 2^16 → 2^17 → 2^18 slots): integers equal, floats
    at the tier's rtol 1e-9 (the card's kernels may associate differently)."""
    from repro_torch.engine import jitexec as jx

    rng = np.random.default_rng(11)
    nb = 1 << 16
    tables = {d: jx.empty_table(jx._MIN_TABLE_CAP, np.float64, d) for d in ("cpu", cuda)}
    cnt = 0
    for call in range(4):
        hot = np.minimum(rng.zipf(1.3, size=nb), 10**6)  # hits across calls
        codes = np.where(rng.random(nb) < 0.5, hot, rng.integers(0, 400_000, size=nb))
        codes = codes.astype(np.int64)
        kg = codes % 1000
        add = rng.normal(14.0, 32.0, size=nb)
        valid = np.arange(nb) < nb - 100
        cap = jx._bucket(cnt + nb, jx._MIN_TABLE_CAP)
        out = {}
        for d, t in tables.items():
            if cap > t.codes.shape[0]:
                t = jx.grown_table(t, cap)
            args = [torch.from_numpy(a).to(d) for a in (codes, kg, add, valid)]
            tables[d], run = jx.keyed_running_sum(t, *args)
            out[d] = run.cpu().numpy()
        a, b = tables["cpu"], tables[cuda]
        for name in ("codes", "seq", "owner", "perm", "cnt", "epoch"):
            assert torch.equal(getattr(a, name), getattr(b, name).cpu()), name
        np.testing.assert_allclose(b.vals.cpu().numpy(), a.vals.numpy(), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(out[cuda][valid], out["cpu"][valid], rtol=1e-9, atol=1e-9)
        cnt = int(a.cnt)
    assert a.codes.shape[0] == 1 << 18 and cnt > 1 << 16


def test_jit_engine_tick_has_no_undeclared_sync(cuda):
    """Real Job 3 under ``.jit()`` on the card: after warm-up, ticks run
    under ``set_sync_debug_mode("error")`` — a boolean mask, ``.item()`` or
    ``nonzero`` in a body or helper would raise; the runtime's one read per
    call and routing's downloads are declared.  States then match the CPU
    ``.jit()`` engine's."""
    from repro_torch.data import StreamSpec, airline_stream, real_job_3
    from repro_torch.engine import Engine, ExecutionConfig

    engines = [
        Engine(real_job_3(keygroups_per_op=50), 8, service_rate=1e9, device=d,
               config=ExecutionConfig.jit())
        for d in ("cuda", "cpu")
    ]
    gpu, cpu = engines
    feed = airline_stream(StreamSpec(rate=3000.0, seed=1))
    batches = [next(feed) for _ in range(8)]
    for t, (k, v, ts) in enumerate(batches):
        for eng in engines:
            eng.push_source("airline", k, v, ts)
            if t >= 3 and eng is gpu:
                calls = gpu.metrics.jit_calls
                torch.cuda.set_sync_debug_mode("error")
                try:
                    eng.tick()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                assert gpu.metrics.jit_calls > calls
            else:
                eng.tick()
    for _ in range(4):
        for eng in engines:
            eng.tick()
    assert gpu.metrics.jit_host_syncs == gpu.metrics.jit_calls
    for field in ("jit_calls", "jit_compiles", "sink_tuples", "processed_tuples"):
        assert getattr(gpu.metrics, field) == getattr(cpu.metrics, field), field
    assert np.array_equal(gpu.window.kg_arrivals, cpu.window.kg_arrivals)
    gpu.end_period(), cpu.end_period()
    for (_, a), (_, b) in zip(gpu.store.items(), cpu.store.items()):
        assert list(a) == list(b)
        for name in a:
            assert list(a[name]) == list(b[name])
            np.testing.assert_allclose(list(a[name].values()), list(b[name].values()),
                                       rtol=1e-9, atol=1e-9)


ATTN_TOL = {torch.float32: dict(atol=3e-5, rtol=3e-5),
            torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


# ---------------------------------------------------------------------------
# The fused superstep on the card.
# ---------------------------------------------------------------------------

_REC = np.dtype([("a", "i8"), ("b", "f8")])


def _record_chain(kgs, *, key_map):
    """The benchmark's record pipeline at depth 3 (src → two record stages
    → sink), the sink emitting ``keys * 2`` so sink outputs come back too;
    ``key_map`` declares the stages' ``jit_key_map`` (the static schedule)."""
    from repro_torch.engine import jitexec as jx
    from repro_torch.engine.topology import (
        OperatorSpec,
        Schema,
        StateField,
        StateSchema,
        Topology,
    )

    schema = Schema.record([("a", "i8"), ("b", "f8")])
    count = StateSchema((StateField("n", "scalar", dtype=np.int64, py=int),))

    def seg(shift):
        def fn_seg(store, run_kgs, starts, ends, keys, values, ts):
            for kg, a, z in zip(run_kgs, starts, ends):
                store[kg]["n"] = store[kg].get("n", 0) + (z - a)
            out = np.empty(len(values), dtype=_REC)
            out["a"], out["b"] = values["a"], values["b"] + values["a"]
            return (keys * 2 if shift is None else keys + shift, out, ts), None

        def fn_jit(state, run_kgs, starts, ends, keys, values, ts):
            out = {"a": values["a"], "b": values["b"] + values["a"]}
            k = keys * 2 if shift is None else keys + shift
            return {"n": jx.count_runs(state["n"], run_kgs, starts, ends)}, (k, out, ts), None

        return fn_seg, fn_jit

    t = Topology()
    t.add_operator(OperatorSpec("src", None, num_keygroups=kgs, is_source=True, schema=schema))
    for name, shift in (("stage0", 17), ("stage1", 34), ("sink", None)):
        fn_seg, fn_jit = seg(shift)
        kmap = (lambda k, s=shift: k + s) if key_map and shift is not None else None
        t.add_operator(OperatorSpec(
            name, lambda st, k, v, ts: (st, None), num_keygroups=kgs, fn_seg=fn_seg,
            fn_jit=fn_jit, jit_fusible=True, jit_key_map=kmap, state_schema=count,
            schema=schema, out_schema=schema, is_sink=shift is None,
        ))
    t.connect("src", "stage0")
    t.connect("stage0", "stage1")
    t.connect("stage1", "sink")
    return t


def _record_batches(count, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(count):
        values = np.empty(n, dtype=_REC)
        values["a"] = rng.integers(0, 1000, size=n)
        values["b"] = rng.random(n)
        out.append((rng.integers(0, 10**6, size=n), values, np.full(n, float(t))))
    return out


def _ss_engine(dev, superstep, key_map=True, kgs=64):
    from repro_torch.engine import Engine, ExecutionConfig

    cfg = ExecutionConfig.superstep() if superstep else ExecutionConfig.jit()
    eng = Engine(_record_chain(kgs, key_map=key_map), 8, service_rate=1e12, seed=0,
                 config=cfg, device=dev)
    eng.backpressure.full_credit = 1 << 20
    return eng


def _ss_result(eng):
    arrivals, usage = eng._arrivals.tolist(), eng._cpu_usage.tolist()
    snap = eng.end_period()
    fields = ("processed_tuples", "emitted_tuples", "sink_tuples", "cross_node_tuples",
              "intra_node_tuples", "dropped_credits")
    return {
        "metrics": {f: getattr(eng.metrics, f) for f in fields},
        "sink_outputs": list(eng.metrics.sink_outputs),
        "states": [pickle.dumps(s) for _, s in eng.store.items()],
        "pairs": (snap.out_pairs.src.tolist(), snap.out_pairs.dst.tolist(),
                  snap.out_pairs.rate.tolist()),
        "arrivals": arrivals,
        "usage": usage,
        "queue_costs": eng.queue_costs(),
        "alloc": eng.router.table.tolist(),
    }


def _drained(eng):
    while any(eng.queue_costs()):
        eng.tick()


@pytest.mark.parametrize("route", ["device", "static"])
def test_superstep_engine_on_card_matches_jit_engine(cuda, route):
    """Fused ticks with a migration mid-run, then a K-tick scan (captured
    and replayed), against the card's ``.jit()`` engine on the same
    batches: every pinned field equal, the migration blob bytes identical,
    one host sync per fused tick and per scan."""
    key_map = route == "static"
    ss, jit = _ss_engine(cuda, True, key_map), _ss_engine(cuda, False, key_map)
    rt = ss._superstep_rt()
    fused_syncs = []
    fused_tick = rt.try_fused_tick

    def counted():
        syncs, busy = ss.metrics.jit_host_syncs, any(ss.queue_costs())
        fused = fused_tick()
        if fused and busy:
            fused_syncs.append(ss.metrics.jit_host_syncs - syncs)
        return fused

    rt.try_fused_tick = counted
    batches = _record_batches(8, 3000, seed=2)
    blobs = {}
    for eng in (ss, jit):
        blobs[eng] = []
        for t, (k, v, ts) in enumerate(batches):
            if t == 2:
                eng.redirect(70, 3)
            eng.push_source("src", k, v, ts)
            eng.tick()
            if t == 3:
                blobs[eng].append(eng.serialize(70))
                eng.install(70, 3, blobs[eng][-1])
        _drained(eng)
    assert blobs[ss] == blobs[jit]
    # The migration's ticks fall back to the classic tick; every other tick
    # fuses, with one host crossing each.
    assert len(fused_syncs) >= 6 and set(fused_syncs) == {1}
    scan_batches = _record_batches(5, 2500, seed=3)
    for rep in range(2):  # the capture, then a replay
        syncs = ss.metrics.jit_host_syncs
        assert ss.run_supersteps(scan_batches) == 5
        assert ss.metrics.jit_host_syncs - syncs == 1
        _drained(ss)
        for k, v, ts in scan_batches:
            jit.push_source("src", k, v, ts)
            jit.tick()
        _drained(jit)
    scan = ss._superstep.last_scan
    assert scan.graph is not None and scan.replays == 2
    a, b = _ss_result(ss), _ss_result(jit)
    for field in a:
        assert a[field] == b[field], field


def _all_equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_all_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_all_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("route", ["device", "static"])
def test_superstep_replay_matches_eager_loop(cuda, route):
    """The captured K-step loop, replayed, against the same loop run
    eagerly on the same staged inputs: states, pendings, pair matrices and
    sink outputs bit-identical.  With routing in the body both kernels run
    inside the graph; the last step's ids and orders (the graph's outputs)
    equal the kernels' plain versions."""
    ss = _ss_engine(cuda, True, key_map=route == "static")
    reset_launch_counts()
    ss.run_supersteps(_record_batches(6, 4000, seed=5))
    scan = ss._superstep.last_scan
    graphed = scan.outs
    eager = scan.body()
    assert _all_equal(graphed, eager)
    if route == "static":
        assert not graphed["taps"] and not scan.graph_launches
        return
    assert scan.graph_launches["keygroup_partition"] == 6 * 2  # K steps x 2 hops
    assert scan.graph_launches["radix_sort"] == 6 * 2
    nodes = ss.num_nodes
    for ok, comp, dst, order in graphed["taps"]:
        ref_dst, _ = keygroup_partition_ref(fold_keys64(ok.cpu()), 64)
        assert torch.equal(dst.cpu(), ref_dst)
        ref_order = bucket_argsort_ref(comp.cpu(), nodes * 64 + 1)
        assert torch.equal(order.cpu(), ref_order)


def test_superstep_tick_and_scan_have_no_undeclared_sync(cuda):
    """Fused ticks and scans (the first, captured, and a replay) under
    ``set_sync_debug_mode("error")``: only declared reads synchronize."""
    ss = _ss_engine(cuda, True, key_map=False)
    batches = _record_batches(4, 2000, seed=7)
    ss.push_source("src", *batches[0])
    ss.tick()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k, v, ts in batches[1:]:
            ss.push_source("src", k, v, ts)
            ss.tick()
        _drained(ss)
        for _ in range(2):
            ss.run_supersteps(batches)
            _drained(ss)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ss._superstep.last_scan.replays == 2
    assert ss.metrics.processed_tuples == 4 * (4 + 2 * 4) * 2000


def _close(out, ref, dtype):
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "b,s,h,kv,hd,causal,window",
    [(1, 256, 4, 2, 64, True, None), (2, 100, 8, 2, 16, True, None),
     (1, 300, 4, 4, 32, False, None), (1, 512, 8, 2, 64, True, 128),
     (2, 129, 32, 2, 128, True, None), (1, 200, 2, 1, 256, True, None),
     (1, 64, 4, 2, 24, True, 7), (1, 2049, 10, 1, 256, True, 2048),
     (2, 777, 16, 16, 128, True, None), (1, 300, 4, 1, 256, True, 100),
     (2, 130, 8, 2, 64, True, None)],
)
def test_flash_kernel_matches_plain(cuda, b, s, h, kv, hd, causal, window, dtype):
    g = torch.Generator().manual_seed(s + h + hd)
    q, k, v = (torch.randn(b, s, n, hd, generator=g).to(dtype) for n in (h, kv, kv))
    reset_launch_counts()
    out = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), causal=causal, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1 and out.dtype == dtype
    _close(out, attention_ref(q, k, v, causal=causal, window=window), dtype)


@pytest.mark.parametrize("hd,h,kv", [(128, 16, 2), (256, 10, 1)])
@pytest.mark.parametrize("s", [1, 70])
def test_flash_kernel_queries_shorter_than_keys(cuda, s, hd, h, kv):
    # chip_smoke.py's flash-vs-decode pairing: S queries over T = 2,064 keys,
    # no causal mask, through the wgmma body.
    g = torch.Generator().manual_seed(s + hd)
    q = torch.randn(2, s, h, hd, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(2, 2064, kv, hd, generator=g).to(torch.bfloat16) for _ in range(2))
    reset_launch_counts()
    out = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), causal=False)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    _close(out, attention_ref(q, k, v, causal=False), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "b,h,kv,hd,t",
    [(3, 8, 2, 64, 512), (1, 4, 4, 32, 256), (2, 16, 2, 128, 512), (4, 32, 2, 128, 1000),
     (2, 8, 2, 16, 64)],
)
def test_decode_kernel_matches_plain(cuda, b, h, kv, hd, t, dtype):
    g = torch.Generator().manual_seed(t + h)
    q = torch.randn(b, 1, h, hd, generator=g).to(dtype)
    kc, vc = (torch.randn(b, t, kv, hd, generator=g).to(dtype) for _ in range(2))
    lens = torch.randint(1, t + 1, (b,), generator=g, dtype=torch.int32)
    lens[0] = 1
    lens[-1] = t if b > 1 else lens[-1]
    reset_launch_counts()
    out = decode_attention(q.to(cuda), kc.to(cuda), vc.to(cuda), lens.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention"] == 1
    _close(out, decode_attention_ref(q, kc, vc, lens), dtype)


def _decode_case(b, h, kv, hd, t, seed, lens):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, 1, h, hd, generator=g).to(torch.bfloat16)
    kc, vc = (torch.randn(b, t, kv, hd, generator=g).to(torch.bfloat16) for _ in range(2))
    return q, kc, vc, torch.tensor(lens, dtype=torch.int32)


def _row_err(out, ref):
    ref = ref.float()
    return float(((out.float() - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("g", [1, 10, 16])
def test_decode_mma_body_at_the_models_group_sizes(cuda, g, hd):
    """The tensor-core body at G = 1 (Moonlight), 10 (RecurrentGemma) and 16
    (GLM-4-9B), hd 128 and 256, with kv_len 1, T, no tile multiple, one
    tile per split (every split ends on a tile's last key) and one key
    more; each row within 1e-2 of its norm as well (chip_smoke.py's row
    check)."""
    from repro_torch.kernels.decode_attention import ops

    b, kv, t = 5, 2, 1000
    nsplit = ops.plan(b, kv, t, torch.cuda.get_device_properties(cuda).multi_processor_count,
                      "mma", hd, g)
    assert ops.kernel_path(torch.bfloat16, g, hd) == "mma" and nsplit > 1
    edge = ops.TILE_KEYS["mma"] * nsplit
    q, kc, vc, lens = _decode_case(b, g * kv, kv, hd, t, g + hd, [1, t, 100, edge, edge + 1])
    reset_launch_counts()
    out = decode_attention(q.to(cuda), kc.to(cuda), vc.to(cuda), lens.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention"] == 1
    ref = decode_attention_ref(q, kc, vc, lens)
    _close(out, ref, torch.bfloat16)
    assert _row_err(out.cpu(), ref) <= 1e-2


def test_decode_kernel_takes_int64_lengths_on_the_card(cuda):
    q, kc, vc, lens = _decode_case(3, 16, 2, 128, 300, 3, [5, 300, 17])
    args = q.to(cuda), kc.to(cuda), vc.to(cuda)
    out64 = decode_attention(*args, lens.to(torch.int64).to(cuda))
    assert torch.equal(out64, decode_attention(*args, lens.to(cuda)))
    _close(out64, decode_attention_ref(q, kc, vc, lens), torch.bfloat16)


def test_decode_kernel_merge_counters_back_to_back_and_on_two_streams(cuda):
    """The split merge's arrival counters start every launch at 0: three
    launches queued on one stream with no sync between them, then launches
    on two streams at once, each held against the plain version."""
    cases = [_decode_case(4, 16, 2, 128, 700, seed, lens) for seed, lens in
             ((1, [700, 1, 333, 64]), (2, [17, 650, 700, 129]), (3, [512, 512, 1, 699]))]
    dev_cases = [tuple(x.to(cuda) for x in c) for c in cases]
    refs = [decode_attention_ref(*c) for c in cases]
    outs = [decode_attention(*c) for c in dev_cases + dev_cases[:1]]
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs + refs[:1]):
        _close(out, ref, torch.bfloat16)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(4):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i].append(decode_attention(*dev_cases[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for out in got[i]:
            _close(out, refs[i], torch.bfloat16)


def test_decode_kernel_planted_split_fault_shows(cuda):
    """The launcher's debug flag drops the last split to arrive from the
    merge: the row check chip_smoke.py uses must see it."""
    from repro_torch.kernels.decode_attention import ops

    b, kv, g, hd, t = 2, 2, 16, 128, 2064
    q, kc, vc, lens = _decode_case(b, g * kv, kv, hd, t, 9, [t, t])
    args = [x.to(cuda) for x in (q, kc, vc, lens)]
    nsplit = ops.plan(b, kv, t, torch.cuda.get_device_properties(cuda).multi_processor_count,
                      "mma", hd, g)
    out = torch.empty_like(args[0])
    ops.launch(*args, out, path="mma", nsplit=nsplit, drop_last_split=True)
    assert _row_err(out.cpu(), decode_attention_ref(q, kc, vc, lens)) > 1e-2


def test_glm4_smoke_decode_on_card_matches_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import Model, init_params
    from repro_torch.models.common import tree_map

    cfg = get_config("glm4_9b", smoke=True)
    params = init_params(cfg, 0, device="cpu")
    model = Model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(0))
    logits_c, cache_c, _ = model.forward(params, tokens=toks, build_cache=True,
                                         cache_capacity=32)
    params_g = tree_map(lambda a: a.to(cuda), params)
    reset_launch_counts()
    logits_g, cache_g, _ = model.forward(params_g, tokens=toks.to(cuda), build_cache=True,
                                         cache_capacity=32)
    assert launch_counts()["flash_attention"] == cfg.num_layers
    np.testing.assert_allclose(logits_g.cpu().numpy(), logits_c.numpy(), atol=0.75, rtol=0.15)
    nxt = torch.full((2, 1), 7)
    pos = torch.full((2,), 12)
    dec_c, _ = model.decode_step(params, cache_c, nxt, pos)
    dec_g, _ = model.decode_step(params_g, cache_g, nxt.to(cuda), pos.to(cuda))
    assert launch_counts()["decode_attention"] == cfg.num_layers
    dec_g, dec_c = dec_g.cpu().numpy()[:, 0], dec_c.numpy()[:, 0]
    np.testing.assert_allclose(dec_g, dec_c, atol=0.75, rtol=0.15)
    top2 = np.sort(dec_c, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * np.abs(dec_g - dec_c).max()
    assert np.array_equal(dec_g.argmax(-1)[clear], dec_c.argmax(-1)[clear])


def _scan_inputs(b, s, w, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    a = (0.2 + 0.799 * torch.rand(b, s, w, generator=g)).to(dtype)
    bb = (0.1 * torch.randn(b, s, w, generator=g)).to(dtype)
    return a, bb, torch.randn(b, w, generator=g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,w", [(1, 1, 1), (2, 17, 33), (3, 100, 260), (2, 256, 256),
                                   (8, 2048, 2560),
                                   # S below one stage (32 f32 / 64 bf16 steps) and
                                   # not a multiple of it; W a partial 160-channel tile.
                                   (2, 5, 8), (3, 33, 72), (1, 65, 136), (4, 1000, 200)])
def test_rglru_scan_kernel_matches_plain_bitwise(cuda, b, s, w, dtype):
    a, bb, h0 = _scan_inputs(b, s, w, dtype, b + s + w)
    reset_launch_counts()
    out = rglru_scan(a.to(cuda), bb.to(cuda), h0.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["rglru_scan"] == 1 and out.dtype == dtype
    assert torch.equal(out.cpu(), rglru_scan_ref(a, bb, h0))


@pytest.mark.parametrize("dtype,w,path", [
    (torch.float32, 4, "tma"), (torch.float32, 6, "direct"), (torch.float32, 68, "tma"),
    (torch.float32, 70, "direct"), (torch.bfloat16, 8, "tma"), (torch.bfloat16, 12, "direct"),
    (torch.bfloat16, 72, "tma"), (torch.bfloat16, 76, "direct")], ids=str)
@pytest.mark.parametrize("s", [3, 100])
def test_rglru_scan_each_body_either_side_of_the_tma_condition(cuda, dtype, w, path, s):
    """Rows of a whole number of 16 bytes take the tma body, others the
    direct one; each launched through ``ops.launch`` by name as well."""
    from repro_torch.kernels.rglru_scan import ops

    assert ops.kernel_path(dtype, w, True) == path
    a, bb, h0 = _scan_inputs(3, s, w, dtype, w + s)
    ref = rglru_scan_ref(a, bb, h0)
    ag, bg, hg = a.to(cuda), bb.to(cuda), h0.to(cuda)
    assert torch.equal(rglru_scan(ag, bg, hg).cpu(), ref)
    out = torch.empty_like(ag)
    ops.launch(ag, bg, hg, out, "direct")
    assert torch.equal(out.cpu(), ref)


def test_rglru_scan_takes_misaligned_inputs_on_the_direct_body(cuda):
    """A contiguous view 4 bytes into its storage: TMA cannot take it."""
    from repro_torch.kernels.rglru_scan import ops

    a, bb, h0 = _scan_inputs(2, 40, 64, torch.float32, 3)
    ag = torch.empty(a.numel() + 1, device=cuda)[1:].view(a.shape).copy_(a)
    assert ag.data_ptr() % 16 and ops.kernel_path(ag.dtype, 64, False) == "direct"
    assert torch.equal(rglru_scan(ag, bb.to(cuda), h0.to(cuda)).cpu(), rglru_scan_ref(a, bb, h0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rglru_scan_planted_stage_fault_shows(cuda, dtype):
    """A ring stage consumed twice: the outputs from that stage on differ."""
    from repro_torch.kernels.rglru_scan import ops

    a, bb, h0 = _scan_inputs(2, 300, 128, dtype, 9)
    ag, bg, hg = a.to(cuda), bb.to(cuda), h0.to(cuda)
    out = torch.empty_like(ag)
    ops.launch(ag, bg, hg, out, "tma", fault_stage=2)
    steps = ops.plan(2, 300, 128, dtype)[1]
    ref = rglru_scan_ref(a, bb, h0)
    assert torch.equal(out[:, : 2 * steps].cpu(), ref[:, : 2 * steps])
    assert not torch.equal(out[:, 2 * steps: 3 * steps].cpu(), ref[:, 2 * steps: 3 * steps])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "e,c,d,f",
    [(4, 128, 256, 128), (8, 64, 128, 256), (2, 256, 512, 128), (3, 5, 72, 44),
     (2, 70, 136, 200), (1, 1, 8, 8), (64, 8, 2048, 1408), (2, 33, 2048, 1408),
     # wgmma: ragged m tiles across experts (129 rows; 33 above runs
     # mma.sync), ragged depth (d = 72), a last n tile with one box (f =
     # 1,096 = 8.5 x 128), more items than SMs (E = 140), and the prefill's
     # shape.
     (3, 129, 256, 384), (4, 65, 72, 128), (2, 96, 1408, 1096), (140, 65, 128, 128),
     (64, 960, 2048, 1408)],
)
def test_moe_gemm_kernel_matches_plain(cuda, e, c, d, f, dtype):
    g = torch.Generator().manual_seed(e + c + d + f)
    x = torch.randn(e, c, d, generator=g).to(dtype)
    w = (0.05 * torch.randn(e, d, f, generator=g)).to(dtype)
    reset_launch_counts()
    out = moe_gemm(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["moe_gemm"] == 1 and out.shape == (e, c, f) and out.dtype == dtype
    _close(out, moe_gemm_ref(x, w), dtype)


BF16 = torch.bfloat16


@pytest.mark.parametrize(
    "e,c,d,f,dtype,path",
    [(64, 960, 2048, 1408, BF16, "wgmma"), (2, 97, 2048, 1408, BF16, "wgmma"),
     (3, 129, 72, 136, BF16, "wgmma"), (140, 70, 64, 128, BF16, "wgmma"),
     (2, 33, 2048, 1408, BF16, "mma"), (64, 8, 2048, 1408, BF16, "mma"),
     (64, 4, 1408, 2048, BF16, "mma"), (2, 70, 136, 200, torch.float32, "simt")],
)
def test_moe_gemm_kernel_each_body(cuda, e, c, d, f, dtype, path):
    """One case per body of ``kernel_path``, each row held to 1e-2 of its
    norm as well (chip_smoke.py's row check), with the wrapper's choice
    pinned."""
    assert kernel_path(e, c, d, f, dtype, True) == path
    g = torch.Generator(device=cuda).manual_seed(e * c + d + f)
    x = torch.randn(e, c, d, generator=g, device=cuda).to(dtype)
    w = (0.05 * torch.randn(e, d, f, generator=g, device=cuda)).to(dtype)
    out = moe_gemm(x, w)
    ref = moe_gemm_ref(x, w)
    _close(out, ref, dtype)
    rel = ((out.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1)).max()
    assert float(rel) <= 1e-2


def _dispatch_like(e, c, d, seed):
    """x (e, c, d) bf16 as a dispatch leaves it, and its live experts:
    experts 0, 5 and e - 1 have random rows, one of them zero; expert 2 is
    live through the last element of its last row alone; expert 1 is dead
    but holds -0.0; every other expert's rows are +0."""
    g = torch.Generator().manual_seed(seed)
    x = torch.zeros(e, c, d, dtype=torch.bfloat16)
    for ex in (0, 5, e - 1):
        x[ex] = torch.randn(c, d, generator=g).to(torch.bfloat16)
        x[ex, int(torch.randint(0, c, (1,), generator=g))] = 0
    x[1] = -0.0
    x[2, -1, -1] = 1.5
    return x, [0, 2, 5, e - 1]


@pytest.mark.parametrize("e,c,d,f", [(64, 4, 2048, 1408), (64, 8, 1408, 2048),
                                     (16, 24, 136, 200), (12, 40, 72, 264)])
def test_moe_gemm_mma_body_skips_dead_experts_exactly(cuda, e, c, d, f):
    """The mma body on dispatch-pattern x equals the same body with the
    skip turned off (torch.equal: the live experts' sums are the same), its
    dead experts' rows are +0, and the rest matches the plain version."""
    from repro_torch.kernels.moe_gemm import ops

    assert kernel_path(e, c, d, f, torch.bfloat16, True) == "mma"
    x, live = _dispatch_like(e, c, d, e + c + d)
    w = (0.05 * torch.randn(e, d, f, generator=torch.Generator().manual_seed(f))).to(
        torch.bfloat16)
    xg, wg = x.to(cuda), w.to(cuda)
    reset_launch_counts()
    out = moe_gemm(xg, wg)
    dense = torch.empty_like(out)
    ops.launch(xg, wg, dense, "mma", skip_dead=False)
    torch.cuda.synchronize()
    assert launch_counts()["moe_gemm"] == 1
    assert torch.equal(out, dense)
    dead = [ex for ex in range(e) if ex not in live]
    assert not bool(out[dead].any())
    assert not bool(torch.signbit(out[dead].float()).any())
    assert bool(out[2, -1].any())  # one nonzero element keeps an expert live
    _close(out, moe_gemm_ref(x, w), torch.bfloat16)
    faulty = torch.empty_like(out)
    ops.launch(xg, wg, faulty, "mma", dead_expert=5)
    assert not bool(faulty[5].any()) and torch.equal(faulty[0], out[0])


def test_moe_gemm_kernel_takes_misaligned_tensors(cuda):
    """A contiguous view two bytes into its storage: the kernel's CUDA-core
    path, which makes no 16-byte loads."""
    e, c, d, f = 2, 9, 64, 48
    x = torch.randn(e * c * d + 1, dtype=torch.bfloat16, device=cuda)[1:].view(e, c, d)
    w = torch.randn(e, d, f, dtype=torch.bfloat16, device=cuda)
    _close(moe_gemm(x, w), moe_gemm_ref(x.cpu(), w.cpu()), torch.bfloat16)


def test_new_wrappers_reject_noncontiguous_tensors(cuda):
    a = torch.zeros(2, 8, 6, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a, a, torch.zeros(2, 8, device=cuda))
    x = torch.zeros(2, 4, 6, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        moe_gemm(x, torch.zeros(2, 8, 6, device=cuda).transpose(1, 2))
    with pytest.raises(TypeError):
        moe_gemm(x, torch.zeros(2, 6, 8, device=cuda, dtype=torch.bfloat16))


# Moonlight in f32: in bf16 the card's and the CPU's router logits round
# differently and near-ties in the top-k pick other experts.
SMOKE_ON_CARD = [
    ("recurrentgemma_2b", "bfloat16", ("rglru_scan", "flash_attention"),
     dict(atol=0.75, rtol=0.15)),
    ("moonshot_v1_16b_a3b", "float32", ("moe_gemm", "flash_attention"),
     dict(atol=2e-3, rtol=2e-3)),
]


@pytest.mark.parametrize("arch,dtype,launched,tol", SMOKE_ON_CARD,
                         ids=[c[0] for c in SMOKE_ON_CARD])
def test_hybrid_and_moe_smoke_on_card_match_cpu(cuda, arch, dtype, launched, tol):
    """SMOKE prefill past RecurrentGemma's window (64), so the ring wraps,
    and decode on the card against device="cpu"."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model, init_params
    from repro_torch.models.common import tree_map

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    params = init_params(cfg, 0, device="cpu")
    model = Model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(1))
    logits_c, cache_c, _ = model.forward(params, tokens=toks, build_cache=True,
                                         cache_capacity=96)
    params_g = tree_map(lambda a: a.to(cuda), params)
    reset_launch_counts()
    logits_g, cache_g, _ = model.forward(params_g, tokens=toks.to(cuda), build_cache=True,
                                         cache_capacity=96)
    counts = launch_counts()
    assert all(counts[name] > 0 for name in launched), counts
    np.testing.assert_allclose(logits_g.cpu().numpy(), logits_c.numpy(), **tol)
    for step in range(3):
        nxt = torch.full((2, 1), 7 + step)
        pos = torch.full((2,), 70 + step)
        dec_c, _ = model.decode_step(params, cache_c, nxt, pos)
        dec_g, _ = model.decode_step(params_g, cache_g, nxt.to(cuda), pos.to(cuda))
        np.testing.assert_allclose(dec_g.cpu().numpy(), dec_c.numpy(), **tol)


# ---------------------------------------------------------------------------
# The multi-worker runtime: card workers fork from a CUDA-free coordinator
# ---------------------------------------------------------------------------

_CLUSTER_ON_CARD = r"""
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.engine import ExecutionConfig

assert not torch.cuda.is_initialized()
batches = cs.airline_batches(5, 4096, 0)
eng = cs.job3_engine("cuda", batch=4096, config=ExecutionConfig.workers(4), kgs=50, nodes=8)
base = eng.topology.kg_base(eng.topology._resolve("sumdelay"))
kg = next(k for k in range(base, base + 50) if eng.node_worker[eng.router.node_of(k)] == 0)
mig = (2, kg, int(np.flatnonzero(eng.node_worker == 3)[0]))
try:
    cluster, _ = cs.drive_lockstep(eng, batches, mig=mig)
finally:
    eng.close()
launches = eng.kernel_launches
assert launches["keygroup_partition"] > 0 and launches["radix_sort"] > 0, launches
assert not torch.cuda.is_initialized()  # the coordinator's first CUDA call is next
single, _ = cs.drive_lockstep(
    cs.job3_engine(torch.device("cuda", 0), batch=4096, config=ExecutionConfig.typed(),
                   kgs=50, nodes=8), batches, mig=mig)
bad = cs.workers_diff(cluster, single)
assert not bad, bad
assert len(single["migration_blobs"]) == 1
print("OK", launches)
"""


def test_cluster_workers_route_on_the_card_in_a_fresh_interpreter(cuda):
    """chip_smoke.py phase 3w's (a)-(b) at a small size: four card workers
    on Real Job 3 with a migration from worker 0 to worker 3, every pinned
    field equal to the single-process card engine's (kg_load and pair_rate
    at rtol 1e-12), both routing kernels launched by the workers.  In a
    fresh interpreter: this process already holds a CUDA context, and a
    child forked from it could not use the card."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", _CLUSTER_ON_CARD, str(root / "src"), str(root)],
        capture_output=True, text=True, timeout=600, cwd=str(root),
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.startswith("OK"), out.stdout[-2000:]


def test_cluster_refuses_cuda_once_the_caller_initialized_it(cuda):
    """``ClusterEngine(device="cuda")`` in a process that initialized CUDA
    raises before it forks anything (never a hang, never a CPU fallback)."""
    import multiprocessing

    from repro_torch.data import real_job_3
    from repro_torch.engine import ExecutionConfig, make_engine

    torch.zeros(1, device=cuda)
    assert torch.cuda.is_initialized()
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match="has not initialized CUDA"):
        make_engine(real_job_3(keygroups_per_op=8), 4, config=ExecutionConfig.workers(2),
                    device="cuda")
    assert set(multiprocessing.active_children()) == before
