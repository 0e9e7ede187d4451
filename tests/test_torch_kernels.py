"""The port's routing kernels against the reference's, bit for bit.

Both kernels compute integers, so no tolerance applies anywhere here:

* ``keygroup_partition`` — the port's plain PyTorch version (what the
  wrapper runs on CPU tensors) against the reference's jnp oracle
  ``keygroup_partition_ref``, its Pallas kernel in interpret mode
  (``keygroup_partition(..., force_pallas=True)``) and the engine's numpy
  routing hash ``Topology.keygroups_of``, over the key dtypes and shapes of
  ``tests/test_kernels.py`` (negative int64 keys, sign-extended int32 keys,
  ``base`` offsets, skewed and all-equal keys, histogram wiring into the
  SPL window); and the CUDA kernel's plain-Python parts: the magic
  constants of its division, its launch plan and its ``kernel_path``;
* ``bucket_argsort`` — the port's plain version against the reference's
  ``bucket_argsort_pallas(interpret=True)`` and ``np.argsort(kind=
  "stable")``, over the shapes of ``tests/test_radix_sort.py`` plus the
  engine's int16 and wide composites; and the CUDA sort's plan (passes and
  digit widths) and scratch layout, which are plain Python.

The CUDA kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest

# CI's tier-1 job installs no torch: skip this module there, not fail collection.
torch = pytest.importorskip("torch")

from repro.engine.topology import OperatorSpec as RefOperatorSpec
from repro.engine.topology import Topology as RefTopology
from repro.kernels.keygroup_partition.ops import fold_keys64 as ref_fold_keys64
from repro.kernels.keygroup_partition.ops import (
    keygroup_partition as ref_keygroup_partition,
)
from repro.kernels.keygroup_partition.ref import (
    keygroup_partition_ref as ref_keygroup_partition_ref,
)
from repro.kernels.radix_sort.radix_sort import bucket_argsort_pallas

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
from repro_torch.kernels.keygroup_partition.ops import CLUSTER as PARTITION_CLUSTER
from repro_torch.kernels.keygroup_partition.ops import (
    SMEM_MAX_BUCKETS as PARTITION_SMEM_MAX_BUCKETS,
)
from repro_torch.kernels.keygroup_partition.ops import head_keys as partition_head_keys
from repro_torch.kernels.keygroup_partition.ops import kernel_path as partition_kernel_path
from repro_torch.kernels.keygroup_partition.ops import magic as partition_magic
from repro_torch.kernels.keygroup_partition.ops import plan as partition_plan
from repro_torch.kernels.keygroup_partition.ref import keygroup_partition_ref
from repro_torch.kernels.radix_sort.ops import TILE as RADIX_TILE
from repro_torch.kernels.radix_sort.ops import plan as radix_plan
from repro_torch.kernels.radix_sort.ops import scratch_bytes as radix_scratch_bytes
from repro_torch.kernels.radix_sort.ref import bucket_argsort_ref


def _keys(n, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int64:
        return rng.integers(-(2**63), 2**63 - 1, size=n, dtype=np.int64)
    return rng.integers(-(2**31), 2**31 - 1, size=n, dtype=np.int64).astype(np.int32)


# ---------------------------------------------------------------------------
# keygroup_partition
# ---------------------------------------------------------------------------

PARTITION_CASES = [
    (1, 1, 0),
    (7, 3, 0),
    (257, 32, 32),
    (1024, 1000, 2000),
    (2000, 257, 5),
    (4096, 4096, 0),
]


@pytest.mark.parametrize("dtype", [np.int64, np.int32], ids=["i8", "i4"])
@pytest.mark.parametrize("n,nkg,base", PARTITION_CASES)
def test_partition_matches_reference_oracle_and_host_hash(n, nkg, base, dtype):
    keys = _keys(n, dtype, seed=n * 7 + nkg)
    ids, hist = keygroup_partition(torch.from_numpy(keys), nkg, base=base)
    assert ids.dtype == torch.int64 and hist.dtype == torch.int64
    # The reference's host wrapper (jnp oracle on CPU) and its oracle.
    r_ids, r_hist = ref_keygroup_partition(keys, nkg, base=base)
    np.testing.assert_array_equal(ids.numpy(), r_ids)
    np.testing.assert_array_equal(hist.numpy(), r_hist)
    o_ids, o_hist = ref_keygroup_partition_ref(jnp.asarray(ref_fold_keys64(keys)), nkg)
    np.testing.assert_array_equal(ids.numpy() - base, np.asarray(o_ids))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(o_hist))
    # The engine's numpy routing hash of the same keys.
    topo = RefTopology()
    if base:
        topo.add_operator(RefOperatorSpec("pad", None, num_keygroups=base, is_source=True))
    topo.add_operator(RefOperatorSpec("op", None, num_keygroups=nkg, is_source=True))
    np.testing.assert_array_equal(
        ids.numpy(), topo.keygroups_of(topo.num_operators - 1, keys, None)
    )


@pytest.mark.parametrize("dtype", [np.int64, np.int32], ids=["i8", "i4"])
@pytest.mark.parametrize("n,nkg", [(300, 8), (1025, 64), (2048, 257)])
def test_partition_matches_pallas_interpret(n, nkg, dtype):
    keys = _keys(n, dtype, seed=n + nkg)
    ids, hist = keygroup_partition(torch.from_numpy(keys), nkg, base=11)
    p_ids, p_hist = ref_keygroup_partition(keys, nkg, base=11, force_pallas=True)
    np.testing.assert_array_equal(ids.numpy(), p_ids)
    np.testing.assert_array_equal(hist.numpy(), p_hist)


@pytest.mark.parametrize("dtype", [np.int64, np.int32], ids=["i8", "i4"])
def test_fold_keys64_matches_reference(dtype):
    keys = _keys(5000, dtype, seed=3)
    keys[:4] = [0, -1, np.iinfo(dtype).min, np.iinfo(dtype).max]
    folded = fold_keys64(torch.from_numpy(keys))
    assert folded.dtype == torch.int32
    np.testing.assert_array_equal(folded.numpy(), ref_fold_keys64(keys))


def test_partition_ref_signature_matches_reference_ref():
    keys32 = _keys(999, np.int32, seed=9)
    kg, hist = keygroup_partition_ref(torch.from_numpy(keys32), 97)
    r_kg, r_hist = ref_keygroup_partition_ref(jnp.asarray(keys32), 97)
    np.testing.assert_array_equal(kg.numpy(), np.asarray(r_kg))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(r_hist))


@pytest.mark.parametrize("dtype", [np.int64, np.int32], ids=["i8", "i4"])
@pytest.mark.parametrize("kind", ["zipf", "all_equal"])
def test_partition_skewed_keys_match_pallas_interpret(kind, dtype):
    """Zipf-skewed keys (a few key groups take most tuples, as the engine's
    airline plane ids do) and all-equal keys (one key group takes all)."""
    rng = np.random.default_rng(17)
    n = 3000
    if kind == "zipf":
        keys = (np.minimum(rng.zipf(1.2, size=n), 4000) * 104_729 - 77).astype(dtype)
    else:
        keys = np.full(n, -987_654_321, dtype=dtype)
    ids, hist = keygroup_partition(torch.from_numpy(keys), 1000, base=1000)
    p_ids, p_hist = ref_keygroup_partition(keys, 1000, base=1000, force_pallas=True)
    np.testing.assert_array_equal(ids.numpy(), p_ids)
    np.testing.assert_array_equal(hist.numpy(), p_hist)
    assert hist.max() >= (n if kind == "all_equal" else n // 10)


def _edge_dividends(d: int) -> np.ndarray:
    """0, 1, 2^31 - 2, 2^31 - 1, and multiples of d minus 1, exact, plus 1
    (sampled to about 3,000 when d is small), all below 2^31."""
    k = np.arange(0, 2**31 // d + 1, max(1, (2**31 // d) // 1000), dtype=np.uint64) * np.uint64(d)
    x = np.concatenate([np.array([0, 1, 2**31 - 2, 2**31 - 1], dtype=np.uint64), k,
                        k - np.uint64(1), k + np.uint64(1)])
    return x[x < 2**31]


def _magic_mod(x: np.ndarray, d: int) -> np.ndarray:
    m, shift = partition_magic(d)
    assert 0 < m < 2**32 and 31 <= shift <= 62
    return x - ((x * np.uint64(m)) >> np.uint64(shift)) * np.uint64(d)


def test_partition_magic_division_is_exact_for_every_small_nkg():
    for d in range(1, 4097):
        x = _edge_dividends(d)
        np.testing.assert_array_equal(_magic_mod(x, d), x % np.uint64(d), err_msg=f"nkg {d}")


@pytest.mark.parametrize("d", [4097, 51_199, 51_200, 51_201, 60_000, 65_537, 1_000_003,
                               2**30 - 1, 2**30, 2**30 + 1, 2**31 - 2, 2**31 - 1])
def test_partition_magic_division_is_exact_for_large_nkg(d):
    rng = np.random.default_rng(d)
    x = np.concatenate([_edge_dividends(d), rng.integers(0, 2**31, 100_000).astype(np.uint64)])
    np.testing.assert_array_equal(_magic_mod(x, d), x % np.uint64(d))


def test_partition_magic_rejects_out_of_range_nkg():
    for d in (0, -1, 2**31):
        with pytest.raises(ValueError):
            partition_magic(d)


@pytest.mark.parametrize("n,key_bytes,nkg,blocks", [
    (1 << 20, 8, 1000, 512),  # the engine's hops: one trip of 4 vectors a thread
    (1 << 20, 4, 1000, 256),  # int32 keys: 4 keys a vector
    (1, 8, 1, 8), (0, 4, 3, 8),  # at least one cluster
    (5 << 20, 8, 1000, 528),  # at most one wave: 4 blocks x 132 SMs
    (1 << 20, 8, 51_200, 128),  # one 200 KiB histogram a SM, whole clusters
    (1 << 20, 8, 51_201, 512), (100_000, 8, 60_000, 49),  # global body, no clusters
    (10 << 20, 4, 60_000, 528),
])
def test_partition_plan_at_the_main_shape_and_the_edges(n, key_bytes, nkg, blocks):
    got = partition_plan(n, key_bytes, nkg, 132)
    assert got == blocks
    if nkg <= PARTITION_SMEM_MAX_BUCKETS:
        assert got % PARTITION_CLUSTER == 0


@pytest.mark.parametrize("nkg,key_bytes,n,address,path", [
    (1000, 8, 1 << 20, 0x7F0000000000, "shared/vector"),  # the engine's hops
    (1000, 4, 1 << 20, 0x7F0000000200, "shared/vector"),
    (1000, 8, 1 << 20, 0x7F0000000008, "shared/scalar edges"),  # a slice: a head of 1
    (1000, 4, 4097, 0x7F0000000000, "shared/scalar edges"),  # a tail of 1
    (1000, 4, 4096, 0x7F000000000C, "shared/scalar edges"),  # a head of 1, a tail of 3
    (1000, 8, 2, 0x7F0000000000, "shared/vector"), (1000, 8, 1, 0x7F0000000000,
                                                    "shared/scalar edges"),
    (51_200, 8, 64, 0, "shared/vector"), (51_201, 8, 64, 0, "global/vector"),
    (60_000, 4, 3, 4, "global/scalar edges"),
])
def test_partition_kernel_path_names_the_body(nkg, key_bytes, n, address, path):
    assert partition_kernel_path(nkg, key_bytes, n, address) == path


def test_partition_head_keys_reach_the_first_16_byte_boundary():
    assert [partition_head_keys(0x1000 + off, 4, 100) for off in (0, 4, 8, 12)] == [0, 3, 2, 1]
    assert [partition_head_keys(0x1000 + off, 8, 100) for off in (0, 8)] == [0, 1]
    assert partition_head_keys(0x1004, 4, 2) == 2  # never past n


def test_partition_empty_and_bad_inputs():
    ids, hist = keygroup_partition(torch.empty(0, dtype=torch.int64), 5, base=3)
    assert ids.numel() == 0 and hist.tolist() == [0] * 5
    with pytest.raises(TypeError):
        keygroup_partition(torch.zeros(4, dtype=torch.float64), 5)
    with pytest.raises(TypeError):
        keygroup_partition(np.zeros(4, dtype=np.int64), 5)
    with pytest.raises(ValueError):
        keygroup_partition(torch.zeros(4, dtype=torch.int64), 0)


# ---------------------------------------------------------------------------
# bucket_argsort
# ---------------------------------------------------------------------------

SORT_CASES = [
    (1, 1, 512),
    (7, 3, 4),
    (512, 16, 512),
    (513, 16, 512),
    (1024, 2, 128),
    (2000, 257, 512),
]


@pytest.mark.parametrize("n,nb,block", SORT_CASES)
def test_sort_matches_pallas_interpret_and_numpy(n, nb, block):
    rng = np.random.default_rng(n * 31 + nb)
    codes = rng.integers(0, nb, size=n).astype(np.int32)
    order = bucket_argsort(torch.from_numpy(codes), nb)
    assert order.dtype == torch.int64
    np.testing.assert_array_equal(order.numpy(), np.argsort(codes, kind="stable"))
    pallas = bucket_argsort_pallas(
        jnp.asarray(codes), num_buckets=nb, block=block, interpret=True
    )
    np.testing.assert_array_equal(order.numpy(), np.asarray(pallas))


@pytest.mark.parametrize(
    "n,nb,dtype",
    [
        (5000, 4 * 12, np.int16),  # small engine composite (num_nodes * nkg)
        (40_000, 16 * 1000, np.int16),  # the chip-size composite
        (40_000, 40_000, np.int32),  # wide composite: > 32767 buckets
        (3000, 70_000, np.int64),
        (777, 40, np.int64),
    ],
)
def test_sort_engine_composites_match_numpy(n, nb, dtype):
    rng = np.random.default_rng(nb)
    codes = rng.integers(0, nb, size=n).astype(dtype)
    order = bucket_argsort(torch.from_numpy(codes), nb)
    np.testing.assert_array_equal(order.numpy(), np.argsort(codes, kind="stable"))


def test_sort_empty_and_all_equal():
    assert bucket_argsort(torch.empty(0, dtype=torch.int32), 4).numel() == 0
    codes = torch.zeros(300, dtype=torch.int16)
    np.testing.assert_array_equal(bucket_argsort(codes, 1).numpy(), np.arange(300))
    codes = torch.full((300,), 6, dtype=torch.int32)
    np.testing.assert_array_equal(bucket_argsort(codes, 7).numpy(), np.arange(300))


def test_sort_ref_is_stable_on_heavy_duplicates():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 3, size=4097)
    np.testing.assert_array_equal(
        bucket_argsort_ref(torch.from_numpy(codes), 3).numpy(),
        np.argsort(codes, kind="stable"),
    )


@pytest.mark.parametrize(
    "nb,passes,bits",
    [(1, 0, 0), (2, 1, 1), (255, 1, 8), (256, 1, 8), (257, 2, 5), (16_000, 2, 7),
     (40_000, 2, 8), (65_536, 2, 8), (70_000, 3, 6), (2**31 - 1, 4, 8)],
)
def test_radix_plan_passes_and_digit_widths(nb, passes, bits):
    assert radix_plan(nb) == (passes, bits)


@pytest.mark.parametrize("nb", [2, 3, 255, 256, 257, 4097, 16_000, 40_000, 65_537, 70_000])
def test_radix_plan_lsd_passes_give_the_stable_order(nb):
    """The plan's digits, sorted one stable pass at a time from the lowest
    (as the kernel's passes do), give np.argsort(kind="stable")."""
    passes, bits = radix_plan(nb)
    assert bits <= 8 and passes * bits >= (nb - 1).bit_length()
    rng = np.random.default_rng(nb)
    codes = rng.integers(0, nb, size=5000)
    order = np.arange(codes.size)
    for p in range(passes):
        digit = (codes[order] >> (p * bits)) & ((1 << bits) - 1)
        order = order[np.argsort(digit, kind="stable")]
    np.testing.assert_array_equal(order, np.argsort(codes, kind="stable"))


def test_radix_scratch_holds_ping_pong_buffers_only_between_passes():
    n = 1 << 20
    head = [radix_scratch_bytes(n, 2, p) for p in (1, 2, 3, 4)]
    tiles = -(-n // RADIX_TILE)
    assert head[0] >= tiles * 256 * 8  # one pass: status words, no buffer
    assert head[1] - head[0] >= n * (2 + 4)  # one int16 key and int32 index buffer
    assert head[2] - head[1] >= n * (2 + 4)  # a second buffer from three passes on
    assert head[3] - head[2] == tiles * 256 * 8  # a fourth pass adds status words only


def test_cpu_tensors_never_count_launches():
    reset_launch_counts()
    keygroup_partition(torch.arange(10), 4)
    bucket_argsort(torch.arange(10), 10)
    q, kv = torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 1, 8)
    flash_attention(q, kv, kv)
    decode_attention(q[:, :1], kv, kv, torch.ones(1, dtype=torch.int32))
    rglru_scan(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8), torch.zeros(1, 8))
    moe_gemm(torch.zeros(2, 3, 8), torch.zeros(2, 8, 4))
    assert launch_counts() == {"keygroup_partition": 0, "radix_sort": 0,
                               "flash_attention": 0, "decode_attention": 0,
                               "rglru_scan": 0, "moe_gemm": 0}


# ---------------------------------------------------------------------------
# Histogram wiring into the SPL window (tests/test_kernels.py's pipeline)
# ---------------------------------------------------------------------------


def _mk_pipeline(mod, kgs=32, key="i8"):
    def fwd(state, keys, values, ts):
        state["n"] = state.get("n", 0) + len(keys)
        return state, (keys + 5, values, ts)

    def sink(state, keys, values, ts):
        state["n"] = state.get("n", 0) + len(keys)
        return state, []

    schema = mod.Schema(np.dtype(np.float64), key=key)
    t = mod.Topology()
    t.add_operator(
        mod.OperatorSpec("src", None, num_keygroups=kgs, is_source=True, schema=schema)
    )
    t.add_operator(
        mod.OperatorSpec("mid", fwd, num_keygroups=kgs, schema=schema, out_schema=schema)
    )
    t.add_operator(
        mod.OperatorSpec("snk", sink, num_keygroups=kgs, is_sink=True, schema=schema)
    )
    t.connect("src", "mid")
    t.connect("mid", "snk")
    return t


@pytest.mark.parametrize("key", ["i8", "i4"])
def test_histogram_wiring_matches_reference_engine(key):
    """The partition kernel's histogram feeds the port's SPL window; routing,
    arrivals and folded statistics match the reference's numpy engine, for
    negative int64 keys and sign-extended int32 keys."""
    import repro.engine as ref_engine

    import repro_torch.engine as port_engine

    port = port_engine.Engine(
        _mk_pipeline(port_engine, key=key), 4, service_rate=1e9, seed=0, device="cpu"
    )
    ref = ref_engine.Engine(
        _mk_pipeline(ref_engine, key=key), 4, service_rate=1e9, seed=0,
        config=ref_engine.ExecutionConfig(kernel_stats=False),
    )
    rng = np.random.default_rng(5)
    lim = 2**62 if key == "i8" else 2**31 - 8
    for t in range(4):
        keys = rng.integers(-lim, lim, size=257, dtype=np.int64)
        vals = rng.random(257)
        for eng in (port, ref):
            eng.push_source("src", keys, vals, np.full(257, float(t)))
            eng.tick()
    for _ in range(3):
        port.tick()
        ref.tick()
    assert port.metrics.partition_kernel_batches == {0: 4, 1: 4, 2: 4}
    assert np.array_equal(port.window.kg_arrivals, ref.window.kg_arrivals)
    assert port.window.kg_arrivals.sum() > 0
    assert port.metrics.processed_tuples == ref.metrics.processed_tuples
    s1, s2 = port.end_period(), ref.end_period()
    assert np.array_equal(s1.kg_load, s2.kg_load)
    assert np.array_equal(s1.kg_tuple_rate, s2.kg_tuple_rate)
    assert np.array_equal(s1.out_rates, s2.out_rates)
    assert [port.store.get(k) for k in range(96)] == [ref.store.get(k) for k in range(96)]


def test_histogram_wiring_nonint_keys_hash_on_host():
    """String keys can't ride the integer-mix kernel: the port hashes them on
    the host and the statistics remain correct; the sort still runs."""
    import repro_torch.engine as port_engine

    def sink(state, keys, values, ts):
        return state, []

    t = port_engine.Topology()
    t.add_operator(port_engine.OperatorSpec("src", None, num_keygroups=8, is_source=True))
    t.add_operator(port_engine.OperatorSpec("snk", sink, num_keygroups=8, is_sink=True))
    t.connect("src", "snk")
    eng = port_engine.Engine(t, 2, service_rate=1e9, seed=0, device="cpu")
    keys = np.array([f"user-{i % 13}" for i in range(99)])
    eng.push_source("src", keys, np.ones(99), np.zeros(99))
    eng.tick()
    eng.tick()
    assert eng.metrics.processed_tuples == 2 * 99
    assert eng.window.kg_arrivals.sum() == 2 * 99
    assert eng.metrics.partition_kernel_batches == {}
    assert eng.metrics.sort_kernel_batches == {0: 1, 1: 1}


def test_window_record_arrivals_accumulates_histogram():
    """The port's SPLWindow.record_arrivals adds a histogram at the op's base."""
    from repro_torch.core.stats import SPLWindow

    w = SPLWindow(16)
    w.record_arrivals(4, np.array([1, 2, 3]))
    w.record_arrivals(4, np.array([1, 0, 1]))
    assert w.kg_arrivals[4:7].tolist() == [2.0, 2.0, 4.0]
    assert w.kg_arrivals.sum() == 8.0
    w.reset()
    assert w.kg_arrivals.sum() == 0.0
