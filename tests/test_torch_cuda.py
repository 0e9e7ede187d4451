"""The port's CUDA kernels and engine on the card (marked ``gpu``).

Each kernel is held bit-exact against its plain PyTorch version (integer
outputs: no tolerance) at the engine's shapes, and a small Real Job 3 run
on the card against the port's CPU engine.  Without a card every test here
skips.  On the card: ``python -m pytest -m gpu tests/test_torch_cuda.py``
(this file imports neither jax nor the reference package).
"""

import pickle

import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    bucket_argsort,
    keygroup_partition,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels.keygroup_partition import fold_keys64
from repro_torch.kernels.keygroup_partition.ref import keygroup_partition_ref
from repro_torch.kernels.radix_sort.ref import bucket_argsort_ref

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


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32], ids=["i8", "i4"])
@pytest.mark.parametrize(
    "n,nkg,base",
    [(1, 1, 0), (7, 3, 0), (257, 32, 32), (2000, 257, 5), (4096, 4096, 0),
     (100_000, 60_000, 1), (1 << 20, 1000, 3000)],
)
def test_partition_kernel_matches_plain(cuda, n, nkg, base, dtype):
    keys = _keys(n, dtype, n + nkg)
    reset_launch_counts()
    ids, hist = keygroup_partition(keys.to(cuda), nkg, base=base)
    assert launch_counts()["keygroup_partition"] == 1
    r_ids, r_hist = keygroup_partition_ref(fold_keys64(keys), nkg)
    assert torch.equal(ids.cpu(), r_ids + base)
    assert torch.equal(hist.cpu(), r_hist)


@pytest.mark.parametrize(
    "n,nb,dtype",
    [(1, 1, torch.int32), (7, 3, torch.int32), (513, 16, torch.int32),
     (1024, 2, torch.int16), (2000, 257, torch.int32), (5000, 70_000, torch.int64),
     (1 << 20, 16_000, torch.int16), (1 << 20, 40_000, torch.int32)],
)
def test_sort_kernel_matches_plain(cuda, n, nb, dtype):
    g = torch.Generator().manual_seed(n + nb)
    codes = torch.randint(0, nb, (n,), generator=g).to(dtype)
    reset_launch_counts()
    order = bucket_argsort(codes.to(cuda), nb)
    assert launch_counts()["radix_sort"] == 1
    assert torch.equal(order.cpu(), bucket_argsort_ref(codes, nb))


def test_sort_kernel_all_equal_and_empty(cuda):
    codes = torch.full((5000,), 3, dtype=torch.int16, device=cuda)
    assert torch.equal(bucket_argsort(codes, 4).cpu(), torch.arange(5000))
    assert bucket_argsort(torch.empty(0, dtype=torch.int32, device=cuda), 4).numel() == 0


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
    assert all(c > 0 for c in launch_counts().values())
    assert gpu.metrics.sink_outputs == cpu.metrics.sink_outputs
    assert [pickle.dumps(s) for _, s in gpu.store.items()] == [
        pickle.dumps(s) for _, s in cpu.store.items()
    ]
    assert np.array_equal(gpu.window.kg_arrivals, cpu.window.kg_arrivals)
    assert gpu.metrics.partition_kernel_batches == gpu.metrics.routed_batches
