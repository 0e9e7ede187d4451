"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card, end to end.

Run from the root of a checkout, with no arguments, on a machine with one
CUDA card (an H100; ``nvcc`` under ``$CUDA_HOME`` or ``/usr/local/cuda``):

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line) on any
error or mismatch:

1. build every kernel of the main path from ``src/repro_torch`` (one
   ``nvcc`` per source, all started together) and print the build time;
2. hold each CUDA kernel against its plain PyTorch version on the card, at
   the main path's shapes, bit-exact (integer outputs: no tolerance), and
   time kernel, plain version and the library yardstick with CUDA events;
3. the main path at full size: Real Job 3 (airline → extract → sumdelay →
   routedelay) with 1000 key groups per operator on 16 nodes, one 2^20-tuple
   airline batch per tick for 20 ticks, every routed hop through both
   kernels; the first 3 ticks are held bit-identical (sink counts and every
   key group's state) to the port's own ``device="cpu"`` engine on the same
   batches, tuple counts are conserved, and tuples/s is printed;
4. the ALBIC controller (``Controller.period()``) on Real Job 3 in the
   real-jobs benchmark's setup (anti-collocated start, ``max_migrations=10``,
   ``ser_cost=0.6``, ``service_rate=3000``) for 6 periods: each period's
   statistics snapshot is held against the CPU engine's, and the plan solved
   once on the card engine's snapshot is applied to both, whose routing
   tables and states must then agree;
5. one JSON line listing the kernels with their launches on the main path
   (phases 3-4), times, bounds and yardsticks;

then the card's name and power limit (``nvidia-smi``), and, last, the line
``{"ok": true, "device": {...}}``.  It exits nonzero without CUDA, and
outside a checkout that holds ``src/repro_torch``.
"""

from __future__ import annotations

import json
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Main-path shapes (phase 3) and the controller setup (phase 4).
BATCH = 1 << 20
NODES = 16
KGS = 1000
TICKS = 20
CHECK_TICKS = 3
DRAIN_TICKS = 4
CTL_KGS, CTL_NODES, CTL_RATE, CTL_TICKS, CTL_PERIODS = 30, 8, 220.0, 10, 6
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the 32-bit
# non-tensor-core rate, which bounds the kernels' integer lanes.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
FLOAT_RTOL = 1e-12


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls."""
    import torch

    fn(0)  # warm-up (builds, allocator)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- phase 2
def kernel_checks(dev, reps: int = 20) -> dict[str, dict]:
    """Each kernel against its plain version on the card, bit-exact; times.

    Inputs rotate over several copies (more than the 50 MB L2 cache holds),
    so each timed launch reads its inputs from device memory.
    """
    import torch

    from repro_torch.kernels import bucket_argsort, keygroup_partition
    from repro_torch.kernels.keygroup_partition import fold_keys64
    from repro_torch.kernels.keygroup_partition.ref import keygroup_partition_ref
    from repro_torch.kernels.radix_sort.ref import bucket_argsort_ref

    gen = torch.Generator().manual_seed(SEED)
    out = {}

    # keygroup_partition: 2^20 int64 keys over the full range (negatives
    # included), 1000 key groups, a nonzero base (extract's ids in job 3).
    nkg, base = KGS, KGS
    copies = [
        torch.randint(-(2**63), 2**63 - 1, (BATCH,), dtype=torch.int64, generator=gen)
        .to(dev)
        for _ in range(8)
    ]
    ids, hist = keygroup_partition(copies[0], nkg, base=base)
    r_ids, r_hist = keygroup_partition_ref(fold_keys64(copies[0]), nkg)
    r_ids = r_ids + base
    err = max(
        int((ids - r_ids).abs().max()),
        int((hist - r_hist).abs().max()),
    )
    check(err == 0, f"keygroup_partition disagrees with its plain version (err {err})")
    check(int(hist.sum()) == BATCH, "keygroup_partition histogram does not sum to n")
    # The int32 (sign-extended) key path of the same kernel.
    k32 = torch.randint(-(2**31), 2**31 - 1, (BATCH,), dtype=torch.int64, generator=gen)
    k32 = k32.to(torch.int32).to(dev)
    ids32, hist32 = keygroup_partition(k32, nkg, base=base)
    r32, rh32 = keygroup_partition_ref(fold_keys64(k32), nkg)
    check(
        torch.equal(ids32, r32 + base) and torch.equal(hist32, rh32),
        "keygroup_partition (int32 keys) disagrees with its plain version",
    )
    ms = cuda_ms(lambda i: keygroup_partition(copies[i % 8], nkg, base=base), reps)
    plain = cuda_ms(
        lambda i: keygroup_partition_ref(fold_keys64(copies[i % 8]), nkg), reps
    )
    b_ms, b_by = bound_ms(BATCH * 8 + BATCH * 8 + nkg * 8, BATCH * 14)
    out["keygroup_partition"] = dict(
        route="cuda",
        source="src/repro_torch/kernels/keygroup_partition/csrc/keygroup_partition.cu",
        replaces="src/repro/kernels/keygroup_partition/keygroup_partition.py:76",
        max_abs_err=float(err),
        ms=ms,
        plain_ms=plain,
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        shape=f"keys ({BATCH},) int64, nkg={nkg}, base={base}",
    )
    log(
        f"[kernel] keygroup_partition n={BATCH} nkg={nkg}: {ms:.4f} ms "
        f"(plain {plain:.4f} ms, bound {b_ms:.4f} ms by {b_by}), max_abs_err={err}"
    )

    # radix_sort: the engine's composite codes — int16 in [0, 16000)
    # (16 nodes x 1000 key groups, the main path) and int32 in [0, 40000).
    cases = []
    for nb, dtype, nbytes_code in ((NODES * KGS, torch.int16, 2), (40_000, torch.int32, 4)):
        codes = [
            torch.randint(0, nb, (BATCH,), generator=gen).to(dtype).to(dev)
            for _ in range(8)
        ]
        order = bucket_argsort(codes[0], nb)
        ref = bucket_argsort_ref(codes[0], nb)
        err = int((order - ref).abs().max())
        check(err == 0, f"radix_sort ({dtype}, {nb} buckets) disagrees (err {err})")
        lib = torch.argsort(codes[0], stable=True)
        check(torch.equal(lib, order), "radix_sort disagrees with torch.argsort")
        ms = cuda_ms(lambda i: bucket_argsort(codes[i % 8], nb), reps)
        plain = cuda_ms(lambda i: bucket_argsort_ref(codes[i % 8], nb), max(3, reps // 5))
        lib_ms = cuda_ms(lambda i: torch.argsort(codes[i % 8], stable=True), reps)
        b_ms, b_by = bound_ms(BATCH * nbytes_code + BATCH * 8, BATCH * 4)
        cases.append(
            dict(
                shape=f"codes ({BATCH},) {str(dtype).split('.')[-1]} in [0, {nb})",
                max_abs_err=float(err),
                ms=ms,
                plain_ms=plain,
                bound_ms=b_ms,
                bound_by=b_by,
                library_ms=lib_ms,
            )
        )
        log(
            f"[kernel] radix_sort n={BATCH} {dtype} nb={nb}: {ms:.4f} ms (plain "
            f"{plain:.4f} ms, torch.argsort {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"by {b_by}), max_abs_err={err}"
        )
    main = dict(cases[0])
    main.update(
        route="cuda",
        source="src/repro_torch/kernels/radix_sort/csrc/radix_sort.cu",
        replaces="src/repro/kernels/radix_sort/radix_sort.py:69",
        max_abs_err=max(c["max_abs_err"] for c in cases),
        cases=cases,
    )
    out["radix_sort"] = main
    return out


# --------------------------------------------------------------------- phase 3
def airline_batches(count: int, size: int, seed: int):
    """``count`` airline batches of exactly ``size`` tuples each."""
    from repro_torch.data import StreamSpec, airline_stream

    spec = StreamSpec(rate=size + 8 * size**0.5 + 64, fluctuation=0.0, seed=seed)
    stream = airline_stream(spec)
    out = []
    for _ in range(count):
        k, v, ts = next(stream)
        check(len(k) >= size, "airline stream produced a short batch")
        out.append((k[:size], v[:size], ts[:size]))
    return out


def state_bytes(eng) -> list[bytes]:
    return [pickle.dumps(s, protocol=pickle.HIGHEST_PROTOCOL) for _, s in eng.store.items()]


def run_engine(dev, *, batch: int, kgs: int, nodes: int, ticks: int, check_ticks: int):
    """Real Job 3 at full size on the card; the first ticks against the CPU."""
    import torch

    from repro_torch.data import real_job_3
    from repro_torch.engine import Engine

    batches = airline_batches(ticks, batch, SEED)

    def make(device):
        eng = Engine(
            real_job_3(keygroups_per_op=kgs),
            nodes,
            service_rate=1e12,
            seed=SEED,
            collect_sinks=False,
            device=device,
        )
        # Admit each whole batch: the credit controller's default cap
        # (10,000 tuples per push, scaled down by queued work) would
        # otherwise cut it; queued work here stays far below the watermark.
        eng.backpressure.full_credit = 2 * batch
        return eng

    gpu, cpu = make(dev), make("cpu")
    admitted = 0
    t_gpu = 0.0
    for t, (k, v, ts) in enumerate(batches):
        t0 = time.perf_counter()
        n = gpu.push_source("airline", k, v, ts)
        gpu.tick()
        torch.cuda.synchronize()
        t_gpu += time.perf_counter() - t0
        check(n == batch, f"tick {t}: admitted {n} of {batch} tuples")
        admitted += n
        if t < check_ticks:
            cpu.push_source("airline", k, v, ts)
            cpu.tick()
            check(
                gpu.metrics.sink_tuples == cpu.metrics.sink_tuples
                and gpu.metrics.processed_tuples == cpu.metrics.processed_tuples,
                f"tick {t}: sink/processed counts differ from the CPU engine",
            )
            check(
                state_bytes(gpu) == state_bytes(cpu),
                f"tick {t}: key-group state differs from the CPU engine",
            )
            check(
                np.array_equal(gpu.window.kg_arrivals, cpu.window.kg_arrivals),
                f"tick {t}: arrival histograms differ from the CPU engine",
            )
            log(f"[engine] tick {t}: card == cpu (sink_tuples={gpu.metrics.sink_tuples})")
    t0 = time.perf_counter()
    for _ in range(DRAIN_TICKS):
        gpu.tick()
    torch.cuda.synchronize()
    t_drain = time.perf_counter() - t0
    m = gpu.metrics
    check(not any(gpu.queue_costs()), "queues not drained")
    check(m.dropped_credits == 0, "tuples dropped by backpressure")
    # airline (pass-through) → extract → {sumdelay, routedelay}: every
    # admitted tuple is processed by four operators, two of them sinks.
    check(m.processed_tuples == 4 * admitted, "processed tuples not conserved")
    check(m.emitted_tuples == 4 * admitted, "emitted tuples not conserved")
    check(m.sink_tuples == 2 * admitted, "sink tuples not conserved")
    snap = gpu.end_period()
    check(np.isfinite(snap.kg_load).all(), "non-finite key-group load")
    check(round(snap.kg_tuple_rate.sum() * (ticks + DRAIN_TICKS)) == 4 * admitted,
          "arrival statistics do not count every routed tuple")
    ops = len(gpu.topology.operators)
    for field in ("partition_kernel_batches", "sort_kernel_batches"):
        per_op = getattr(m, field)
        check(
            all(per_op.get(op, 0) == m.routed_batches.get(op, -1) for op in range(ops)),
            f"{field} {per_op} != routed_batches {m.routed_batches}: a hop "
            "missed a kernel",
        )
    # Throughput counts every admitted tuple fully processed: the feeding
    # ticks plus the drain ticks that finish the last batches.
    tps = admitted / (t_gpu + t_drain)
    log(
        f"[engine] job3 kgs/op={kgs} nodes={nodes} batch={batch}: {admitted} "
        f"tuples in {ticks} ticks ({t_gpu:.3f} s) + {DRAIN_TICKS} drain ticks "
        f"({t_drain:.3f} s) = {tps:.0f} tuples/s ({admitted / t_gpu:.0f} over "
        f"the feeding ticks alone); device round trips "
        f"{m.device_route_seconds:.3f} s; routed_batches={m.routed_batches} "
        f"host_device_copies={m.host_device_copies} "
        f"host_device_bytes={m.host_device_bytes}"
    )
    return {
        "tuples_per_s": tps,
        "tick_seconds": t_gpu,
        "drain_seconds": t_drain,
        "admitted": admitted,
        "device_route_seconds": m.device_route_seconds,
        "host_device_copies": m.host_device_copies,
        "host_device_bytes": m.host_device_bytes,
    }


# --------------------------------------------------------------------- phase 4
def run_controller(dev, *, kgs: int, nodes: int, rate: float, ticks: int, periods: int):
    """ALBIC through Controller.period() on the card; the CPU engine mirrors."""
    from repro_torch.core import AdaptationFramework, AlbicParams
    from repro_torch.core.migration import execute_plan
    from repro_torch.data import StreamSpec, airline_stream, real_job_3
    from repro_torch.engine import Controller, ControllerConfig, Engine

    class SnapshotEngine(Engine):
        """Keeps every end_period() snapshot for the comparison."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.snapshots = []

        def end_period(self):
            snap = super().end_period()
            self.snapshots.append(snap)
            return snap

    class RecordingFramework(AdaptationFramework):
        """Keeps every adaptation result, to replay its plan on the mirror."""

        def adapt(self, state, **kw):
            res = super().adapt(state, **kw)
            self.results.append(res)
            return res

    def build(cls, device):
        topo = real_job_3(keygroups_per_op=kgs)
        alloc = np.zeros(topo.num_keygroups, dtype=np.int64)
        for op in range(topo.num_operators):
            base = topo.kg_base(op)
            n_op = topo.operators[op].num_keygroups
            alloc[base : base + n_op] = (np.arange(n_op) + op * (nodes // 2 + 1)) % nodes
        return cls(
            topo,
            nodes,
            initial_alloc=alloc,
            ser_cost=0.6,
            service_rate=3000.0,
            seed=SEED,
            collect_sinks=False,
            device=device,
        )

    gpu, cpu = build(SnapshotEngine, dev), build(Engine, "cpu")
    air = airline_stream(StreamSpec(rate=rate, seed=SEED))
    fed = []

    def feeder(engine, tick):
        batch = next(air)
        fed.append(batch)
        engine.push_source("airline", *batch)

    fw = RecordingFramework(
        mode="albic",
        max_migrations=10,
        albic_params=AlbicParams(max_ld=15.0, time_limit=1.5),
    )
    fw.results = []
    ctl = Controller(gpu, fw, ControllerConfig(ticks_per_period=ticks), feeder=feeder)
    total_migrations = 0
    for p in range(periods):
        n_res = len(fw.results)
        fed.clear()
        m = ctl.period()
        for batch in fed:
            cpu.push_source("airline", *batch)
            cpu.tick()
        snap_c, snap_g = cpu.end_period(), gpu.snapshots[-1]
        for name in ("kg_load", "kg_tuple_rate", "kg_state_bytes"):
            a, b = getattr(snap_g, name), getattr(snap_c, name)
            check(
                np.allclose(a, b, rtol=FLOAT_RTOL, atol=FLOAT_RTOL),
                f"period {p}: snapshot {name} differs (max {np.abs(a - b).max()})",
            )
        pg, pc = snap_g.out_pairs, snap_c.out_pairs
        check(
            np.array_equal(pg.src, pc.src)
            and np.array_equal(pg.dst, pc.dst)
            and np.allclose(pg.rate, pc.rate, rtol=FLOAT_RTOL, atol=FLOAT_RTOL),
            f"period {p}: pair rates differ",
        )
        check(np.array_equal(snap_g.alloc, snap_c.alloc), f"period {p}: alloc differs")
        if len(fw.results) > n_res:
            res = fw.results[-1]
            check(not res.scaling.add_nodes and not res.terminated,
                  "unexpected scaling in the controller phase")
            execute_plan(res.migration_plan, cpu)
        check(
            np.array_equal(gpu.router.table, cpu.router.table),
            f"period {p}: routing tables differ after the plan",
        )
        check(state_bytes(gpu) == state_bytes(cpu), f"period {p}: states differ")
        total_migrations += m.num_migrations
        log(
            f"[controller] period {p}: load_distance={m.load_distance:.6f} "
            f"collocation={m.collocation_factor:.6f} load_index={m.load_index:.6f} "
            f"migrations={m.num_migrations} migration_cost={m.migration_cost:.6f} "
            f"solver_seconds={m.solver_seconds:.3f} "
            f"migration_pause_s={m.migration_pause_s:.6f} latency={m.latency}"
        )
    check(total_migrations >= 1, "the controller ran no migration")
    return {"migrations": total_migrations}


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    dev = torch.device("cuda", 0)
    card = gpu_name_and_limit()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    try:
        t0 = time.perf_counter()
        built = _build.build()
        log(f"[build] {built} in {time.perf_counter() - t0:.2f} s wall")

        kernels = kernel_checks(dev)

        reset_launch_counts()
        engine = run_engine(
            dev, batch=BATCH, kgs=KGS, nodes=NODES, ticks=TICKS, check_ticks=CHECK_TICKS
        )
        controller = run_controller(
            dev, kgs=CTL_KGS, nodes=CTL_NODES, rate=CTL_RATE, ticks=CTL_TICKS,
            periods=CTL_PERIODS,
        )
        launches = launch_counts()
        for name, count in launches.items():
            check(count > 0, f"kernel {name} was not launched on the main path")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[summary] engine {engine}; controller {controller}; "
        f"{time.perf_counter() - t_start:.1f} s total")
    rows = [dict(name=name, launches=launches[name], **kernels[name]) for name in kernels]
    print(json.dumps({"kernels": rows}))
    print(f"{card}")
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
