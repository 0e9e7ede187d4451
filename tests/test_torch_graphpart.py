"""The port's balanced graph partitioner (``repro_torch.solver.graphpart``)
against the reference's, label for label: random graphs, graphs whose one
vertex outweighs a part (the rebalance's longest case) and graphs of equal
weights (its ties); and the edges of a key-group subset that ALBIC hands
it (``PairRates.symmetric_edges``) against the reference's."""

import numpy as np
import pytest

from repro.core import stats as ref_stats
from repro.solver import graphpart as ref
from repro_torch.core import stats as port_stats
from repro_torch.solver import graphpart as port


def graphs(seed: int):
    rng = np.random.default_rng(seed)
    for trial in range(40):
        n = int(rng.integers(2, 240))
        e = int(rng.integers(0, 6 * n))
        u, v = rng.integers(0, n, e), rng.integers(0, n, e)
        w = (rng.choice([0.5, 1.0, 2.0], e) if trial % 2 else rng.uniform(0.01, 10, e))
        vw = rng.uniform(0.1, 3, n)
        if trial % 3 == 0:
            vw[rng.integers(0, n)] = vw.sum() * rng.uniform(0.5, 3)
        if trial % 5 == 0:
            vw = np.ones(n)
        yield n, u, v, w, vw, int(rng.integers(1, 8)), int(rng.integers(0, 1000))


@pytest.mark.parametrize("seed", range(4))
def test_partition_equals_the_reference(seed):
    for n, u, v, w, vw, nparts, pseed in graphs(seed):
        want = ref.partition_graph(ref.Graph(n, u, v, w, vw), nparts, seed=pseed)
        got = port.partition_graph(port.Graph(n, u, v, w, vw), nparts, seed=pseed)
        assert np.array_equal(got, want), (n, nparts, pseed)


@pytest.mark.parametrize("seed", range(3))
def test_subset_edges_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        g = int(rng.integers(1, 300))
        nnz = int(rng.integers(0, 5 * g))
        dense = np.zeros((g, g))
        dense[rng.integers(0, g, nnz), rng.integers(0, g, nnz)] = rng.uniform(0.01, 5, nnz)
        index_map = -np.ones(g, dtype=np.int64)
        rows = np.flatnonzero(rng.random(g) < rng.random())
        index_map[rows] = rng.permutation(len(rows))
        for im in (index_map, None):
            want = ref_stats.PairRates.from_dense(dense).symmetric_edges(im)
            got = port_stats.PairRates.from_dense(dense).symmetric_edges(im)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)
