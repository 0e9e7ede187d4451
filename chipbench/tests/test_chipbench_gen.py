"""The frozen generators against the port's, and the pool's replay.

The port's generators are read here only, as a test: the benchmark's load
stays what these copies draw."""

import numpy as np
import pytest

from chipbench.gen import streams
from chipbench.gen.pool import Pool


def _same(a, b, ticks=3):
    for _ in range(ticks):
        (k1, v1, t1), (k2, v2, t2) = next(a), next(b)
        assert np.array_equal(k1, k2) and np.array_equal(t1, t2)
        assert v1.dtype == v2.dtype and v1.tobytes() == v2.tobytes()


@pytest.mark.parametrize("name", ["airline_stream", "wiki_edit_stream"])
def test_frozen_streams_equal_the_ports(name):
    synthetic = pytest.importorskip("repro_torch.data.synthetic")
    for seed in (0, 2**31 + 17):
        for rate, fluct in ((300.0, 0.3), (5000.0, 0.0)):
            mine = getattr(streams, name)(streams.StreamSpec(rate=rate, fluctuation=fluct,
                                                             seed=seed))
            port = getattr(synthetic, name)(synthetic.StreamSpec(rate=rate, fluctuation=fluct,
                                                                 seed=seed))
            _same(mine, port)


def test_frozen_dtypes_equal_the_ports():
    synthetic = pytest.importorskip("repro_torch.data.synthetic")
    assert streams.AIRLINE_DTYPE == synthetic.AIRLINE_DTYPE
    assert streams.WIKI_DTYPE == synthetic.WIKI_DTYPE
    assert streams.AIRLINE_DTYPE.itemsize == 48


KEYS = {"airline_stream": ("num_airplanes", 4000, 1.2),
        "wiki_edit_stream": ("num_articles", 5000, 1.3)}


@pytest.mark.parametrize("seed", [0, 11, 2**31 + 5])
@pytest.mark.parametrize("name", sorted(KEYS))
def test_truncated_zipf_has_no_pile_on_the_last_key(name, seed):
    """The clamped draw puts every key past the range on the last one; the
    truncated draw keeps the law's own tail there."""
    field, n_keys, a = KEYS[name]
    spec = streams.StreamSpec(rate=200_000, fluctuation=0.0, seed=seed)
    clamp, _, _ = next(getattr(streams, name)(spec, **{field: n_keys, "zipf_a": a}))
    trunc, _, _ = next(getattr(streams, name)(spec, **{field: n_keys, "zipf_a": a},
                                              zipf_tail="truncate"))
    assert trunc.min() >= 0 and trunc.max() < n_keys and trunc.dtype == np.int64
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -a
    p /= p.sum()
    assert np.mean(clamp == n_keys - 1) > 0.05
    assert np.mean(trunc == n_keys - 1) < 10 * p[-1]
    got = np.bincount(trunc, minlength=n_keys)[:4] / len(trunc)
    assert np.allclose(got, p[:4], rtol=0.03)


def test_unknown_zipf_tail_is_refused():
    with pytest.raises(ValueError):
        next(streams.airline_stream(streams.StreamSpec(seed=1), zipf_tail="wrap"))


def test_pool_replays_with_advancing_time():
    pool = Pool("airline_stream", {}, 100, 3, seed=5)
    k0, v0, t0 = pool.batch(0)
    k3, v3, t3 = pool.batch(3)  # the first batch again, one cycle later
    assert np.array_equal(k0, k3) and np.array_equal(v0["plane"], v3["plane"])
    assert (t0 == 0).all() and (t3 == 3).all()
    k, v, t = pool.tuples(250, 720)  # spans batches 2..7, five of them cut
    assert len(k) == 470 and v.dtype == streams.AIRLINE_DTYPE
    assert t[0] == 2 and t[-1] == 7 and np.array_equal(k[:50], pool.batches[2][0][50:])
    k[:] = -1  # a fresh array: the pool keeps its own
    assert (pool.batches[2][0] >= 0).all()
    late = Pool("airline_stream", {}, 10, 2, seed=5)
    assert (late.batch(501)[1]["year"] == 2005).all()  # tick 501 is in year 2005
