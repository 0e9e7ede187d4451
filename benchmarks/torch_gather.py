"""Routing's gather after the composite sort, timed on the host's CPU.

For job 3's hops (keys int64, airline or extract records, timestamps
float64) and job 1's wiki hop, at batch sizes from 2^10 to 2^20, times:

- ``fancy``: ``col[order]`` for each column, the gather before
  ``repro_torch.engine.permute``;
- ``view``: ``np.take`` of each column's fixed-width view on the calling
  thread alone;
- ``pool<k>``: the same takes split into ``k`` contiguous chunks of the
  order, ``k - 1`` of them on a thread pool;
- ``permute``: ``permute_columns`` as the engine calls it.

Each result is checked byte for byte against ``fancy``.  Outputs are fresh
arrays, as the engine's are.  Prints one JSON line per (hop, size) and
writes them all to ``--out``::

    PYTHONPATH=src python benchmarks/torch_gather.py --out build/gather.json
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.data import jobs, synthetic  # noqa: E402
from repro_torch.engine import permute  # noqa: E402

HOPS = {
    "airline": synthetic.AIRLINE_DTYPE,
    "extract": jobs.EXTRACT_SCHEMA.value,
    "wiki": synthetic.WIKI_DTYPE,
}


def _columns(dtype: np.dtype, n: int, rng: np.random.Generator):
    """Keys, records and timestamps of one batch, and the stable order of
    its (node, key group) composite: Zipf 1.2 keys over 4,000, 1,000 key
    groups on 16 nodes."""
    keys = np.minimum(rng.zipf(1.2, n) - 1, 3_999).astype(np.int64)
    values = np.zeros(n, dtype)
    raw = values.view(np.uint8).reshape(n, dtype.itemsize)
    raw[:] = rng.integers(0, 256, raw.shape, dtype=np.uint8)
    ts = rng.random(n)
    kg = keys % 1_000
    order = np.argsort((kg % 16) * 1_000 + kg, kind="stable")
    return (keys, values, ts), order


def _pooled(pool, k: int):
    def gather(order, cols):
        n = len(order)
        outs = [np.empty(n, c.dtype) for c in cols]
        pairs = [(c.view(np.dtype((np.void, c.itemsize))),
                  o.view(np.dtype((np.void, c.itemsize)))) for c, o in zip(cols, outs)]
        bounds = [n * i // k for i in range(k + 1)]

        def take(a, z):
            for src, dst in pairs:
                np.take(src, order[a:z], out=dst[a:z], mode="wrap")

        futures = [pool.submit(take, bounds[i], bounds[i + 1]) for i in range(1, k)]
        take(bounds[0], bounds[1])
        for f in futures:
            f.result()
        return outs

    return gather


def _ms(fn, order, cols, reps: int) -> tuple[float, list]:
    out = fn(order, cols)  # warm: the pool's threads, the allocator
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn(order, cols)
        times.append(time.perf_counter() - t)
    return 1e3 * statistics.median(times), out


def _host() -> dict:
    info = {"cpus": len(os.sched_getaffinity(0)), "machine": platform.processor()}
    try:
        with open("/proc/cpuinfo") as f:
            info["cpu"] = next(ln.split(":", 1)[1].strip() for ln in f
                               if ln.startswith("model name"))
    except (OSError, StopIteration):
        pass
    try:
        info["gpu"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["gpu"] = None
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--min-log2", type=int, default=10)
    ap.add_argument("--max-log2", type=int, default=20)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    cpus = len(os.sched_getaffinity(0))
    ks = [k for k in (2, 4, 8) if k <= cpus]
    pools = {k: ThreadPoolExecutor(k - 1) for k in ks}
    variants = {
        "fancy": lambda order, cols: [c[order] for c in cols],
        "view": _pooled(None, 1),
        **{f"pool{k}": _pooled(pools[k], k) for k in ks},
        "permute": lambda order, cols: permute.permute_columns(order, *cols),
    }
    rows = [{"host": _host(), "chunk_min_tuples": permute.CHUNK_MIN_TUPLES,
             "pool_max_threads": permute.POOL_MAX_THREADS}]
    print(json.dumps(rows[0]), flush=True)
    for hop, dtype in HOPS.items():
        for lg in range(args.min_log2, args.max_log2 + 1):
            n = 1 << lg
            cols, order = _columns(dtype, n, rng)
            want = None
            row = {"hop": hop, "n": n}
            for name, fn in variants.items():
                ms, out = _ms(fn, order, cols, args.reps)
                got = [(o.dtype, o.tobytes()) for o in out]
                if want is None:
                    want = got
                elif got != want:
                    raise AssertionError(f"{name} differs from fancy indexing at {hop}, n={n}")
                row[name + "_ms"] = ms
            print(json.dumps(row), flush=True)
            rows.append(row)
    for pool in pools.values():
        pool.shutdown()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
