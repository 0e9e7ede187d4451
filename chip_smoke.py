"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card, end to end.

Run from the root of a checkout, with no arguments, on a machine with one
CUDA card (an H100; ``nvcc`` under ``$CUDA_HOME`` or ``/usr/local/cuda``):

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line) on any
error or mismatch:

1. build every kernel from ``src/repro_torch`` (one ``nvcc`` per source,
   all started together) and print the build time;
2. hold each CUDA kernel against its plain PyTorch version on the card, at
   the main paths' shapes -- the routing kernels bit-exact (integer outputs),
   the attention kernels and moe_gemm in bf16 at atol = rtol = 3e-2
   (tests/test_kernels.py's bf16 tolerance) and, per output row, within 1e-2
   of the plain version's norm, rglru_scan at atol = rtol = 1e-5 (the
   reference's, and bit-identical); a planted fault per kernel (a block's
   slice of the partition's cluster flush dropped, two equal codes swapped
   in the sort's order, a dropped KV tile, the decode merge without its last
   split, the scan's carry reset halfway and a ring stage of its tma body
   consumed twice, a skipped K slice, a live expert treated as dead) must
   fail that check -- and time kernel, plain version and the library
   yardstick: keygroup_partition on uniform int64, int32 and phase 3's
   airline keys beside a same-bytes ``ids.copy_(keys)``, rglru_scan beside
   a same-bytes ``torch.add(a, b, out=o)`` (yardsticks only: no single call
   computes either function); flash at the GLM, Moonlight and RecurrentGemma
   (head_dim 256) prefills' shapes, with a planted fault at head_dim 128 and
   at 256;
   decode attention at the three models' decode shapes beside SDPA given the
   same length mask, and moe_gemm's decode and serve products (dense x, and
   x from a real top-6 dispatch, whose dead experts the kernel skips, held
   exactly equal to the same body without the skip) beside ``torch.bmm``.
   These decode-shape times, and the partition's and the scan's, are each
   given twice, in three rounds: device ms per call (``device_ms``,
   torch.profiler, every device op of a call) and host ms per call
   (``cuda_ms``, CUDA events around back-to-back calls), since a call of a
   few microseconds on the card can take longer than that on the host;
3. the engine path at full size: Real Job 3 (airline → extract → sumdelay →
   routedelay) with 1000 key groups per operator on 16 nodes, one 2^20-tuple
   airline batch per tick for 20 ticks, every routed hop through both
   routing kernels; the first 3 ticks are held bit-identical (sink counts
   and every key group's state) to the port's own ``device="cpu"`` engine
   on the same batches, tuple counts are conserved, and tuples/s and the
   device's busy share of 3 more steady ticks (torch.profiler) are printed;
3j. the same under ``ExecutionConfig.jit()``: the compiled tier keeps
   sumdelay's and routedelay's keyed running sums in device columns
   (``repro_torch.engine.jitexec``), every routed hop still through both
   routing kernels; the first 3 ticks are held against the CPU ``.jit()``
   engine and every tick's sink and processed counts, the arrival histograms
   and the final states against phase 3's ``.typed()`` engine (integers,
   keys and insertion order exactly; floats at the tier's rtol 1e-9);
   prints tuples/s beside phase 3's, the jit counters with the first calls'
   seconds apart, host↔device copies and bytes, the busy share, and
   ``keyed_running_sum``'s device and host ms per call at the steady
   segment size (3 rounds);
3s. the fused superstep (``ExecutionConfig.superstep()``) on the
   benchmark's record pipeline (``benchmarks/engine_throughput.py``'s
   record stages and counting sink at depth 4, ported) at phase 3's size:
   1000 key groups per operator, 16 nodes, 2^20-tuple batches, K = 20
   batches a scan.  (a) fused ``tick()`` calls with a redirect → serialize →
   install migration mid-run against the card's ``.jit()`` engine: every
   field ``tests/test_superstep.py::_result`` pins equal, the blob bytes
   identical, one host sync per fused tick; (b) ``run_supersteps(K)``,
   with the stages' ``jit_key_map`` (routing staged on the card) and
   without it (routing inside the scan), against the ``.jit()`` engine
   ticked over the same K batches until drained: equal, one host sync a
   scan; (c) the captured scan's replay bit-identical to the same loop run
   eagerly on its staged inputs; (d) each hop's key groups and order,
   computed inside the graph, bit for bit against the kernels' plain
   versions, and a swap of two equal codes rejected; (e) a scan and fused
   ticks under ``torch.cuda.set_sync_debug_mode("error")``.  Prints the
   fused tick's and the timed (replayed) scan's processed tuples/s, the
   ``.jit()`` engine's and ``vs_jit`` (as the reference's
   ``engine_throughput/superstep_jit`` row), the first call's warm-up and
   capture seconds, the replay alone (CUDA events), the device's busy share
   of the timed scan (``torch.profiler``), copies and bytes, host syncs,
   and the routing kernels' launches (wrapper counts, and per replay);
3w. the supervised multi-worker runtime (``repro_torch.engine.cluster``) at
   phase 3's size, in a fresh interpreter (``--workers``: the coordinator
   forks card workers, so it makes no CUDA call until its pools are
   closed): (a) ``.workers(4)`` driven in lockstep over 8 batches and the
   drain, every field ``tests/conformance.py`` pins for ``+workers`` held
   against the single-process card engine on the same batches (sink
   outputs and their order, state bytes, counts, arrivals exactly;
   kg_load and pair rates at rtol 1e-12, atol 1e-18) with (b) a key group
   migrated from worker 0 to worker 3, its blob bytes equal; (c) a planted
   non-contiguous node → worker map that (a)'s comparison must reject; (d)
   phase 4's controller over ``.workers(2)``, its ``PeriodMetrics``,
   snapshots, tables and states against the same plans on the
   single-process card engine; (e) phase 4's setup over four supervised
   workers with a checkpoint a period and a kill at period 2: one recovery,
   the respawned worker launching both kernels, converged to the oracle
   replayed from the checkpoint; (f) ``run_stream`` at 2 and 4 workers,
   at 1 MiB lanes and at lanes for two ticks, beside the single-process
   engine (tuples/s, ``w{n}_vs_single``, the exchange's transport counts,
   the coordinator's ingest seconds, per-worker device round trips); (g)
   the workers' launches folded into the kernels line, and the
   coordinator's ``torch.cuda.is_initialized()`` False before its first
   CUDA call;
4. the ALBIC controller (``Controller.period()``) on Real Job 3 in the
   real-jobs benchmark's setup (anti-collocated start, ``max_migrations=10``,
   ``ser_cost=0.6``, ``service_rate=3000``) for 6 periods, under ``.typed()``
   and again under ``.jit()``: each period's statistics snapshot is held
   against the CPU engine's in the same configuration, and the plan solved
   once on the card engine's snapshot is applied to both, whose routing
   tables and states must then agree (under ``.jit()`` floats at rtol
   1e-9, and every migrated key group of a table operator must have left
   the device columns);
5. the LM path at full width: GLM-4-9B (40 layers, d_model 4096, vocab
   151,552; ``max_seq_len`` cut to 4,096, the context) with random bf16
   weights from a seeded generator on the card; 8 prompts of 2,048 tokens
   prefilled through ``Model.forward(build_cache=True, cache_capacity=4096)``
   (40 flash-attention launches) and 16 tokens decoded greedily (40
   decode-attention launches per step); in one more bf16 prefill and one
   more decode step, each layer's kernel output is held against its plain
   version on the same activations (flash: ``attention_ref``; decode:
   ``decode_attention_ref`` on the same cache and kv_len);
   the first decoded token's logits are held against the last row of a
   full forward over the prompt plus that token (in float32 on two layers
   and two prompts: see ``check_prefill_decode`` for why not in bf16);
6. the serve loop (``repro_torch.launch.serve.serve_loop``) on the same
   model: 3 workers x 8 slots for 45 ticks, adapting every 15; sequences
   must complete, memory stay within the card, and every applied migration
   install exactly the cache rows it extracted, leaving the destination's
   other slots unchanged;
7. phases 5-6 for RecurrentGemma-2B at full width (26 layers, d_model
   2,560, vocab 256,000; context 4,096): 8 prompts of 2,048 tokens fill the
   2,048-slot LOCAL_ATTN ring (18 rglru_scan and 8 flash launches), 16
   decode steps run on the wrapped ring (8 decode launches each, no scan);
   rglru_scan is also held against its plain version in each RG-LRU layer
   of the extra prefill; the f32 check runs the first cycle (rglru, rglru,
   local_attn); the serve loop's migrations move ring, ``h`` and ``conv``
   rows;
8. phases 5-6 for Moonlight-16B-A3B at full width and depth (48 layers, 64
   experts top-6, d_model 2,048, vocab 163,840; context 2,560): 4 prompts
   of 2,048 tokens and 8 decode steps, 3 moe_gemm launches per layer and
   step; moe_gemm is held against its plain version in each of the 144
   expert products of the extra prefill and of the extra decode step; the
   serve loop runs 3 workers x 8 slots at context 1,024 (0.4 GB of cache
   per slot); the weights of the earlier models are freed first;

then one JSON line listing the kernels with their launches on the paths
that run them (phases 3, 3j, 3s, 3w and 4 for routing, 5-8 for the LM kernels), times,
bounds and yardsticks; the card's name and power limit (``nvidia-smi``);
and, last, the line ``{"ok": true, "device": {...}}``.  It exits nonzero
without CUDA, and outside a checkout that holds ``src/repro_torch``.

``python3 chip_smoke.py --host-us [SRC]`` runs none of that: it prints the
host microseconds per call of the decode path's kernel wrappers
(``host_us``), imported from SRC (default ``src``), so that two checkouts
can be compared in one call.  ``--kernel-ms [SRC]`` likewise prints only
keygroup_partition's and rglru_scan's phase-2 timings and yardsticks
(``kernel_ms``).  ``--workers`` runs phase 3w alone (the full run starts it
so, as a child, and relays its lines).
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
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

# LM path (phases 5-6): GLM-4-9B at full width, context cut to 4,096.
LM_ARCH = "glm4_9b"
LM_CONTEXT = 4096
LM_BATCH, LM_PROMPT, LM_DECODE_STEPS = 8, 2048, 16
SERVE = dict(ticks=45, workers=3, slots=8, arrival_rate=1.5, spl_ticks=15, hetero=0.5,
             seed=SEED)
ATTN_TOL = dict(atol=3e-2, rtol=3e-2)  # tests/test_kernels.py:47-50, bf16
# On unit-randn inputs attention's outputs have std ~sqrt(e/n) (~0.04 at
# n = 2048 keys), the size of ATTN_TOL itself, so a kernel that drops a
# KV tile or split passes it.  Each output row (b, position, head) is also
# held to |out - ref|_2 <= ROW_RTOL * |ref|_2: bf16 rounding of P and
# of the output gives ~3e-3, a dropped 16-key split at n = 2064 ~4e-2 or more.
ROW_RTOL = 1e-2
# The prefill/decode consistency check's tolerance: tests/test_models.py:105-106
# (bf16 parameters, different contraction orders), here at full width.
LM_TOL = dict(atol=0.75, rtol=0.15)
# Depth of the end-to-end check (full width, the first pattern cycles of the
# same weights): see check_prefill_decode.
CHECK_CYCLES = 2

# Phase 7: RecurrentGemma-2B at full width, context cut to 4,096.  Its
# prompts fill the 2,048-slot LOCAL_ATTN ring, so every decode step runs on
# a wrapped ring.
RG_ARCH, RG_CONTEXT = "recurrentgemma_2b", 4096
RG_BATCH, RG_PROMPT, RG_DECODE_STEPS = 8, 2048, 16
RG_CHECK_CYCLES = 1  # (rglru, rglru, local_attn): an attention layer included
# Phase 8: Moonlight-16B-A3B (the repo's moonshot_v1_16b_a3b) at full width
# and depth, context cut to 2,560 (4.0 GB of cache beside 56.1 GB of
# weights); its serve loop (SERVE's 3 workers x 8 slots) at context 1,024.
MOE_ARCH, MOE_CONTEXT, MOE_SERVE_CONTEXT = "moonshot_v1_16b_a3b", 2560, 1024
MOE_BATCH, MOE_PROMPT, MOE_DECODE_STEPS = 4, 2048, 8
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_kernels.py:149

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the 32-bit
# non-tensor-core rate, which bounds the routing kernels' integer lanes, and
# the dense bf16 tensor-core rate, which bounds attention's matrix products.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
FLOAT_RTOL = 1e-12
# The compiled tier's documented float tolerance (tests/conformance.py,
# JIT_FLOAT_RTOL/ATOL): running sums associate differently from the
# per-run oracle's left fold; everything else is compared exactly.
JIT_RTOL = 1e-9


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Host milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls.  When a call's host work outlasts its kernels (a
    launch of a few microseconds), this is the host's pace, not the
    device's: ``device_ms`` gives that."""
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


def device_kernels(prof) -> list[tuple[float, str, int]]:
    """(device µs, name, count) of every device-side event (kernels,
    copies, memsets) a torch.profiler run recorded, largest first.  A CPU
    op's device time repeats that of the kernels it launched, so CPU-side
    events are left out."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    return sorted(rows, reverse=True)


def device_ms(fn, reps: int, attempts: int = 3, lost: float = 0.0) -> float:
    """Device milliseconds per call of ``fn`` from torch.profiler over
    ``reps`` calls: for each kernel (or copy) the calls ran, its mean
    duration times its launches per call.  The host's time between launches
    is left out.  A trace can lose an event or two (one of 60 launches at
    times), so launches per call are counts over ``reps`` rounded; a trace
    whose counts are far from whole multiples of ``reps`` is taken again.
    ``lost`` widens "far" to that share of a kernel's launches, for a call
    of hundreds of launches, where a trace loses a few in every hundred."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    rows = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
        rows = device_kernels(prof)
        per_call = [max(1, round(n / reps)) for _, _, n in rows]
        if rows and all(abs(n - k * reps) <= max(1, reps // 20, lost * k * reps)
                        for (_, _, n), k in zip(rows, per_call)):
            return sum(us / n * k for (us, _, n), k in zip(rows, per_call)) / 1e3
    raise SmokeFailure(f"torch.profiler recorded no whole trace of {reps} calls in {attempts} "
                       f"attempts: {[(k, n) for _, k, n in rows]}")


ROUNDS = 3  # phase 2's decode-shape timings: rounds within the call, for the spread


def timed_rounds(fns: dict, rounds: int = ROUNDS, lost: float = 0.0) -> dict[str, dict]:
    """Device ms per call (``device_ms``) and host ms per call
    (``cuda_ms``) of each ``name -> (fn, reps)``, in ``rounds`` rounds that
    take the callables in turn; per name the median and the [min, max] of
    each."""
    runs = {name: ([], []) for name in fns}
    for _ in range(rounds):
        for name, (fn, reps) in fns.items():
            runs[name][0].append(device_ms(fn, reps, lost=lost))
            runs[name][1].append(cuda_ms(fn, reps))
    return {name: dict(device_ms=float(np.median(dev)), device_spread=[min(dev), max(dev)],
                       host_ms=float(np.median(host)), host_spread=[min(host), max(host)])
            for name, (dev, host) in runs.items()}


def fmt_rounds(t: dict) -> str:
    """'device d [lo-hi], host h [lo-hi] ms' for the log."""
    lo, hi = t["device_spread"]
    hlo, hhi = t["host_spread"]
    return (f"device {t['device_ms']:.4f} [{lo:.4f}-{hi:.4f}], host {t['host_ms']:.4f} "
            f"[{hlo:.4f}-{hhi:.4f}] ms")


def bound_ms(nbytes: int, ops: int, ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def max_err(out, ref, tol=ATTN_TOL) -> tuple[float, int]:
    """(max |out - ref|, elements outside atol + rtol * |ref|)."""
    diff = (out.float() - ref.float()).abs()
    return float(diff.max()), int((diff > tol["atol"] + tol["rtol"] * ref.float().abs()).sum())


def row_rel_err(out, ref) -> float:
    """Largest |out - ref|_2 / |ref|_2 over the rows of the last axis (one
    query position of one head)."""
    ref = ref.float()
    num = (out.float() - ref).norm(dim=-1)
    return float((num / ref.norm(dim=-1).clamp_min(1e-30)).max())


def row_check(what: str, out, ref, tol=ATTN_TOL) -> tuple[float, float]:
    """Hold a kernel output to ``tol`` elementwise and to ROW_RTOL per row
    (of its last axis); returns (max |out - ref|, largest row error)."""
    err, bad = max_err(out, ref, tol)
    rel = row_rel_err(out, ref)
    check(bad == 0, f"{what}: {bad} elements outside atol={tol['atol']:.4g} "
          f"rtol={tol['rtol']:.4g} (max err {err})")
    check(rel <= ROW_RTOL, f"{what}: a row is {rel:.3e} of its norm away "
          f"(limit {ROW_RTOL})")
    return err, rel


def planted_fault(what: str, faulty, ref) -> tuple[float, int]:
    """The row check must reject ``faulty``, a kernel output with terms
    missing; returns the row error it saw and the elements that ATTN_TOL
    alone would have flagged."""
    rel = row_rel_err(faulty, ref)
    check(rel > ROW_RTOL, f"the row check passes a planted fault ({what}): "
          f"row error {rel:.3e} <= {ROW_RTOL}")
    return rel, max_err(faulty, ref)[1]


# --------------------------------------------------------------------- phase 2
def partition_inputs(dev, count: int = 8) -> dict[str, list]:
    """The key sets keygroup_partition is timed on, each as ``count``
    batches of BATCH keys on the card (together past the 50 MB L2):
    uniform int64 over the full range (negatives included), uniform int32
    (sign-extended by the kernel), and the plane ids of phase 3's airline
    batches (Zipf 1.2 over 4,000 planes: plane 0 alone is ~18 % of them)."""
    import torch

    gen = torch.Generator().manual_seed(SEED)
    return {
        "uniform int64": [
            torch.randint(-(2**63), 2**63 - 1, (BATCH,), dtype=torch.int64, generator=gen).to(dev)
            for _ in range(count)],
        "int32": [
            torch.randint(-(2**31), 2**31 - 1, (BATCH,), dtype=torch.int64, generator=gen)
            .to(torch.int32).to(dev) for _ in range(count)],
        "airline": [torch.from_numpy(k).to(dev) for k, _, _ in airline_batches(count, BATCH, SEED)],
    }


def partition_timings(inputs: dict, nkg: int, base: int, reps: int = 50) -> dict[str, dict]:
    """``timed_rounds`` of keygroup_partition on each key set of
    ``partition_inputs``, beside its same-bytes yardstick ``ids.copy_(keys)``
    (each key read once, an int64 written per key; it hashes nothing, so it
    is a yardstick, not a library call computing the function)."""
    import torch

    from repro_torch.kernels import keygroup_partition

    out = {}
    for name, keys in inputs.items():
        ids = torch.empty(BATCH, dtype=torch.int64, device=keys[0].device)
        out[name] = timed_rounds({
            "kernel": (lambda i, k=keys: keygroup_partition(k[i % len(k)], nkg, base=base), reps),
            "copy": (lambda i, k=keys, o=ids: o.copy_(k[i % len(k)]), reps),
        })
    return out


def scan_inputs(dev):
    """RecurrentGemma's prefill scan inputs, (RG_BATCH, RG_PROMPT, lru_width)
    f32 (503 MB, far past L2): a ~ U(0.2, 0.999), b ~ 0.1 N(0,1), h0 ~
    N(0,1) (tests/test_kernels.py:143-146)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    b, s, w = RG_BATCH, RG_PROMPT, lm_config(RG_ARCH).lru_width
    a = torch.empty(b, s, w, device=dev).uniform_(0.2, 0.999, generator=gen)
    bb = 0.1 * torch.randn(b, s, w, generator=gen, device=dev)
    h0 = torch.randn(b, w, generator=gen, device=dev)
    return a, bb, h0


def scan_timings(a, bb, h0, reps: int = 20) -> dict[str, dict]:
    """``timed_rounds`` of rglru_scan beside its same-bytes yardstick
    ``torch.add(a, b, out=o)`` (two reads and one write of the shape)."""
    import torch

    from repro_torch.kernels import rglru_scan

    o = torch.empty_like(a)
    return timed_rounds({"kernel": (lambda i: rglru_scan(a, bb, h0), reps),
                         "add": (lambda i: torch.add(a, bb, out=o), reps)})


def kernel_ms() -> dict:
    """keygroup_partition (nkg KGS, base KGS, on each key set of
    ``partition_inputs``) and rglru_scan (``scan_inputs``) timed as
    imported, with their yardsticks (``--kernel-ms SRC`` imports them from
    SRC, so that two checkouts can be compared in one call)."""
    import torch

    dev = torch.device("cuda", 0)
    out = {"keygroup_partition": partition_timings(partition_inputs(dev), KGS, KGS)}
    gc.collect()
    torch.cuda.empty_cache()
    out["rglru_scan"] = scan_timings(*scan_inputs(dev))
    return out


def routing_kernel_checks(dev, reps: int = 20) -> dict[str, dict]:
    """Each kernel against its plain version on the card, bit-exact; times.

    Inputs rotate over several copies (more than the 50 MB L2 cache holds),
    so each timed launch reads its inputs from device memory.
    """
    import torch

    from repro_torch.kernels import bucket_argsort, keygroup_partition
    from repro_torch.kernels.keygroup_partition import fold_keys64
    from repro_torch.kernels.keygroup_partition.ref import keygroup_partition_ref
    from repro_torch.kernels.radix_sort.ops import plan as radix_plan
    from repro_torch.kernels.radix_sort.ref import bucket_argsort_ref

    gen = torch.Generator().manual_seed(SEED)
    out = {}

    # keygroup_partition: 2^20 keys, 1000 key groups, a nonzero base
    # (extract's ids in job 3), on each key set of partition_inputs; bit-
    # exact, ids and histogram.  Planted fault: one block's slice of its
    # cluster's histogram flush dropped.
    from repro_torch.kernels.keygroup_partition import ops as kg_ops

    nkg, base = KGS, KGS
    inputs = partition_inputs(dev)
    cases, err = [], 0
    for name, keys in inputs.items():
        ids, hist = keygroup_partition(keys[0], nkg, base=base)
        r_ids, r_hist = keygroup_partition_ref(fold_keys64(keys[0]), nkg)
        err = max(err, int((ids - r_ids - base).abs().max()), int((hist - r_hist).abs().max()))
        check(torch.equal(ids, r_ids + base) and torch.equal(hist, r_hist),
              f"keygroup_partition ({name} keys) disagrees with its plain version")
        check(int(hist.sum()) == BATCH, "keygroup_partition histogram does not sum to n")
        cases.append(dict(keys=name, body=kg_ops.kernel_path(nkg, keys[0].element_size(), BATCH,
                                                             keys[0].data_ptr())))
    keys = inputs["uniform int64"][0]
    f_ids, f_hist = kg_ops.launch(keys, nkg, base, drop_block=3)
    r_ids, r_hist = keygroup_partition_ref(fold_keys64(keys), nkg)
    check(torch.equal(f_ids, r_ids + base), "the planted flush fault changed the ids")
    check(not torch.equal(f_hist, r_hist), "the histogram check passes a planted fault (a "
          "block's slice of its cluster flush dropped)")
    lost = BATCH - int(f_hist.sum())
    del f_ids, f_hist
    times = partition_timings(inputs, nkg, base)
    plain = cuda_ms(
        lambda i: keygroup_partition_ref(fold_keys64(inputs["uniform int64"][i % 8]), nkg), reps)
    for case in cases:
        t = times[case["keys"]]
        key_bytes = inputs[case["keys"]][0].element_size()
        b_ms, b_by = bound_ms(BATCH * key_bytes + BATCH * 8 + nkg * 8, BATCH * 14)
        case.update(ms=t["kernel"]["device_ms"], host_ms=t["kernel"]["host_ms"],
                    yardstick_ms=t["copy"]["device_ms"], bound_ms=b_ms, bound_by=b_by, times=t)
        log(f"[kernel] keygroup_partition n={BATCH} nkg={nkg}, {case['keys']} keys, "
            f"{case['body']} body: kernel {fmt_rounds(t['kernel'])}; yardstick ids.copy_(keys) "
            f"{fmt_rounds(t['copy'])}; bound {b_ms:.5f} ms by {b_by} "
            f"({b_ms / case['ms']:.1%} of it on the device)")
    log(f"[kernel] keygroup_partition: plain {plain:.4f} ms, max_abs_err={err}; planted fault "
        f"(block 3's flush slice dropped): {lost} counts lost, rejected")
    main = {k: v for k, v in cases[0].items() if k not in ("keys", "times")}
    out["keygroup_partition"] = dict(
        route="cuda",
        source="src/repro_torch/kernels/keygroup_partition/csrc/keygroup_partition.cu",
        replaces="src/repro/kernels/keygroup_partition/keygroup_partition.py:76",
        max_abs_err=float(err),
        plain_ms=plain,
        library_ms=None,
        yardstick="ids.copy_(keys), same bytes (no single call computes the function)",
        planted_fault_lost_counts=lost,
        shape=f"keys ({BATCH},) int64, nkg={nkg}, base={base}",
        cases=cases,
        **main,
    )
    del inputs

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
        # Planted fault: the first two neighbours of equal code swapped.  The
        # codes stay in order, so only a check of stability rejects it.
        ranked = codes[0][order]
        i = int((ranked[1:] == ranked[:-1]).nonzero()[0])
        faulty = order.clone()
        faulty[[i, i + 1]] = order[[i + 1, i]]
        ranked = codes[0][faulty]
        check(bool((ranked[1:] >= ranked[:-1]).all()), "the planted sort fault broke the order")
        check(not torch.equal(faulty, ref), "the sort check passes a planted fault (two equal "
              "codes swapped)")
        passes, bits = radix_plan(nb)
        ms = cuda_ms(lambda i: bucket_argsort(codes[i % 8], nb), 5 * reps)
        plain = cuda_ms(lambda i: bucket_argsort_ref(codes[i % 8], nb), max(3, reps // 5))
        lib_ms = cuda_ms(lambda i: torch.argsort(codes[i % 8], stable=True), 5 * reps)
        nbytes = BATCH * nbytes_code + BATCH * 8
        b_ms, b_by = bound_ms(nbytes, BATCH * 4)
        cases.append(
            dict(
                shape=f"codes ({BATCH},) {str(dtype).split('.')[-1]} in [0, {nb})",
                passes=passes,
                digit_bits=bits,
                max_abs_err=float(err),
                ms=ms,
                plain_ms=plain,
                bound_ms=b_ms,
                bound_by=b_by,
                library_ms=lib_ms,
            )
        )
        log(
            f"[kernel] radix_sort n={BATCH} {dtype} nb={nb}, {passes} passes of {bits} bits: "
            f"{ms:.4f} ms (plain {plain:.4f} ms, torch.argsort {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}; {nbytes / ms / 1e6:.1f} GB/s of the bound's bytes), "
            f"max_abs_err={err}; planted fault (equal codes {i}, {i + 1} swapped) rejected"
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


def sdpa(q, k, v, **kw):
    """The library yardstick on pre-transposed (B, heads, S, hd) tensors."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, enable_gqa=q.shape[1] != k.shape[1], **kw)


ROTATE = 6  # decode timing: cache copies rotated past the L2 cache


def attention_kernel_checks(dev, *, batch=LM_BATCH, seq=LM_PROMPT, heads=32, kv=2, hd=128,
                            window_batch=1, window=512, reps: int = 10) -> dict[str, dict]:
    """Both attention kernels against their plain versions on the card, in
    bf16, at GLM-4-9B's main-path shapes (prefill: B=8, S=T=2048, H=32,
    KV=2, hd=128, causal; decode: B=8, T=4096, ``decode_timed_case``), plus
    a window=512 flash case.  Times: kernel, plain version and
    ``scaled_dot_product_attention`` on pre-transposed tensors."""
    import torch

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    out = {}
    # -- flash: causal at the prefill's shape, then a window=512 case.
    cases = []
    for b, causal, win in ((batch, True, None), (window_batch, True, window)):
        q, k, v = randn(b, seq, heads, hd), randn(b, seq, kv, hd), randn(b, seq, kv, hd)
        got = flash_attention(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        err, rel = row_check(f"flash_attention (B={b}, window={win}) against its plain version",
                              got, attention_ref(q, k, v, causal=causal, window=win))
        cases.append(dict(shape=f"q ({b},{seq},{heads},{hd}) k/v ({b},{seq},{kv},{hd}) bf16 "
                          f"causal window={win}", max_abs_err=err, max_row_rel_err=rel))
        if win is None:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            ms = cuda_ms(lambda i: flash_attention(q, k, v, causal=True), reps)
            plain = cuda_ms(lambda i: attention_ref(q, k, v, causal=True), max(2, reps // 5))
            lib = cuda_ms(lambda i: sdpa(qt, kt, vt, is_causal=True), reps)
            pairs = seq * (seq + 1) // 2  # causal (query, key) pairs per head
            flops = 4 * b * heads * hd * pairs
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
            main = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
            log(f"[kernel] flash_attention GLM prefill: B={b} S={seq} H={heads} KV={kv} hd={hd} "
                f"causal: {ms:.4f} ms (plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
                f"{b_ms:.4f} ms by {b_by}; {flash_rate(b, seq, heads, hd, ms, b_ms)}), "
                f"max_abs_err={err} max_row_rel_err={rel:.3e}")
        else:
            # Planted fault: a window of seq - 64 drops the first KV tile
            # (up to 64 keys) from the last rows; held against full causal.
            fault, fault_bad = planted_fault(
                "flash without the first KV tile of the last rows",
                flash_attention(q, k, v, causal=True, window=seq - 64),
                attention_ref(q, k, v, causal=True))
            main["planted_fault_row_rel_err"] = fault
            log(f"[kernel] flash_attention B={b} S={seq} window={win}: max_abs_err={err} "
                f"max_row_rel_err={rel:.3e}; planted fault (first KV tile dropped for the "
                f"last rows): row error {fault:.3e}, {fault_bad} elements outside ATTN_TOL")
        del q, k, v, got
    out["flash_attention"] = dict(
        route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:115",
        max_abs_err=max(c["max_abs_err"] for c in cases),
        max_row_rel_err=max(c["max_row_rel_err"] for c in cases),
        cases=cases,
        **main,
    )

    # -- decode at GLM's shape, held against flash on the same inputs too.
    case = decode_timed_case(dev, *DECODE_SHAPES[0], gen, pair_with_flash=True)
    out["decode_attention"] = dict(
        route="cuda",
        source="src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/decode_attention.py:84",
        cases=[case],
        **{k: case[k] for k in ("max_abs_err", "max_row_rel_err", "planted_fault_row_rel_err",
                                "ms", "host_ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "shape")},
    )
    return out


#: Decode shapes of the three models, timed in phase 2: (what, B, T, KV, G,
#: hd, kv_len of the timed rows).  GLM-4-9B after its prefill; Moonlight
#: (G = 1) likewise; RecurrentGemma's LOCAL_ATTN ring, full (its 2,048-slot
#: window wrapped: transformer.py's ring decode).
DECODE_SHAPES = (
    ("GLM-4-9B", LM_BATCH, LM_CONTEXT, 2, 16, 128, LM_PROMPT + LM_DECODE_STEPS),
    ("Moonlight", MOE_BATCH, MOE_CONTEXT, 16, 1, 128, MOE_PROMPT + MOE_DECODE_STEPS),
    ("RecurrentGemma ring", RG_BATCH, 2048, 1, 10, 256, 2048),
)


def decode_timed_case(dev, what: str, b: int, t: int, kv: int, g: int, hd: int, live_len: int,
                      gen, *, pair_with_flash: bool = False, reps: int = 50) -> dict:
    """The decode kernel at one model's shape, in bf16: rows with kv_len in
    [1, T] (1, T, lengths that are no tile multiple, the first split's end
    and one past it) and rows all at ``live_len`` against the plain
    version; two planted faults the row check must reject (the last 16 keys
    missing; the merge leaving out the last split to arrive, through the
    launcher's debug flag); then device and host ms per call of the kernel,
    SDPA given the same length mask, and the plain version, in ROUNDS
    rounds, with the caches rotated over ROTATE copies (more than the 50 MB
    L2 cache holds) as a decode step finds them."""
    import torch

    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    bf16, h = torch.bfloat16, kv * g

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    q = randn(b, 1, h, hd)
    kc, vc = randn(b, t, kv, hd), randn(b, t, kv, hd)
    path = dec_ops.kernel_path(bf16, g, hd)
    nsplit = dec_ops.plan(b, kv, t, torch.cuda.get_device_properties(dev).multi_processor_count,
                          path, hd, g)
    # One tile a split (every split ends on its tile's last key), and one key more.
    split_end = dec_ops.TILE_KEYS[path] * nsplit
    lens = torch.tensor([1, t, 63, split_end, split_end + 1, 1000, t - 1, 65][:b],
                        dtype=torch.int32, device=dev)
    got = decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    err, rel = row_check(f"decode_attention ({what}) against its plain version", got,
                          decode_attention_ref(q, kc, vc, lens))
    steady = torch.full((b,), live_len, dtype=torch.int32, device=dev)
    steady_ref = decode_attention_ref(q, kc, vc, steady)
    got = decode_attention(q, kc, vc, steady)
    err2, rel2 = row_check(f"decode_attention ({what}, kv_len {live_len})", got, steady_ref)
    # Planted faults: the last 16 keys missing; a split's partial that never
    # reaches the merge.
    fault, fault_bad = planted_fault(f"decode ({what}) without its last 16 keys",
                                     decode_attention(q, kc, vc, steady - 16), steady_ref)
    dropped = torch.empty_like(q)
    dec_ops.launch(q, kc, vc, steady, dropped, path=path, nsplit=nsplit, drop_last_split=True)
    fault2, fault2_bad = planted_fault(f"decode ({what}) without the last split to arrive",
                                       dropped, steady_ref)
    check(nsplit > 1, f"decode ({what}) ran one split: the dropped-split fault plants nothing")
    note = ""
    if pair_with_flash:
        # The two kernels against each other on the same inputs: flash over
        # the first kv_len keys without a causal mask computes what decode does.
        pair = flash_attention(q, kc[:, :live_len].contiguous(), vc[:, :live_len].contiguous(),
                               causal=False)
        err3, rel3 = row_check(f"flash_attention (causal=False) against decode_attention "
                                f"({what}) on the same inputs", pair, got)
        note = f"; flash vs decode on the same inputs: max err {err3}, row error {rel3:.3e}"
    del got, dropped
    copies = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(ROTATE - 1)]
    tcopies = [tuple(x.transpose(1, 2).contiguous() for x in (q, a, c)) for a, c in copies]
    mask = (torch.arange(t, device=dev)[None, :] < steady[:, None])[:, None, None, :]
    times = timed_rounds({
        "kernel": (lambda i: decode_attention(q, *copies[i % ROTATE], steady), reps),
        "sdpa": (lambda i: sdpa(*tcopies[i % ROTATE], attn_mask=mask), reps),
        "plain": (lambda i: decode_attention_ref(q, *copies[i % ROTATE], steady), 5),
    })
    live = int(steady.sum())
    nbytes = 2 * (2 * live * kv * hd + 2 * q.numel())
    b_ms, b_by = bound_ms(nbytes, 4 * h * hd * live, BF16_FLOPS_PER_S)
    kern_t = times["kernel"]
    log(f"[kernel] decode_attention {what}: B={b} T={t} H={h} KV={kv} G={g} hd={hd} "
        f"kv_len={live_len}, {path} body, {nsplit} splits: kernel {fmt_rounds(kern_t)}; sdpa "
        f"{fmt_rounds(times['sdpa'])}; plain {fmt_rounds(times['plain'])}; bound {b_ms:.4f} ms "
        f"by {b_by} ({b_ms / kern_t['device_ms']:.1%} of it on the device); caches rotated over "
        f"{ROTATE} copies, {ROUNDS} rounds; max_abs_err={max(err, err2)} "
        f"max_row_rel_err={max(rel, rel2):.3e} (kv_len {lens.tolist()}); planted faults: last "
        f"16 keys dropped, row error {fault:.3e} ({fault_bad} elements outside ATTN_TOL); last "
        f"split dropped from the merge, row error {fault2:.3e} ({fault2_bad} outside){note}")
    del copies, tcopies, q, kc, vc
    return dict(
        shape=f"{what}: q ({b},1,{h},{hd}) caches ({b},{t},{kv},{hd}) bf16 kv_len {live_len}",
        body=path, splits=nsplit, max_abs_err=max(err, err2), max_row_rel_err=max(rel, rel2),
        planted_fault_row_rel_err=min(fault, fault2), ms=kern_t["device_ms"],
        host_ms=kern_t["host_ms"], plain_ms=times["plain"]["device_ms"],
        library_ms=times["sdpa"]["device_ms"], bound_ms=b_ms, bound_by=b_by, times=times)


def flash_rate(b, s, h, hd, ms, b_ms) -> str:
    """Achieved TFLOP/s of causal flash at (b, s, h, hd) and its share of
    the bound, for the log."""
    flops = 4 * b * h * hd * (s * (s + 1) // 2)
    return f"{flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the bound"


def flash_timed_case(dev, what: str, b: int, s: int, h: int, kv: int, hd: int,
                     window: int | None, seed: int, reps: int = 5,
                     fault: bool = False) -> dict:
    """The flash kernel at a prefill's shape (causal, S = T, bf16) against
    its plain version, timed beside it and beside SDPA; with ``fault``, a
    planted fault (a window of S - 64 held against full causal) must fail
    the row check.  With S <= window the window masks nothing, so SDPA with
    ``is_causal`` is the same function."""
    import torch

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, s, n, hd, generator=gen, device=dev).to(torch.bfloat16)
               for n in (h, kv, kv))
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=True, window=window)
    err, rel = row_check(f"flash_attention ({what}) against its plain version", got, ref)
    case = dict(shape=f"q ({b},{s},{h},{hd}) k/v ({b},{s},{kv},{hd}) bf16 causal window={window}",
                max_abs_err=err, max_row_rel_err=rel)
    note = ""
    if fault:
        # Planted fault: a window of s - 64 drops up to 64 keys (the first
        # KV tile) from the last rows.
        full = ref if window is None or window >= s else attention_ref(q, k, v, causal=True)
        rel_f, bad_f = planted_fault(f"flash ({what}) without the first KV tile of the last rows",
                                     flash_attention(q, k, v, causal=True, window=s - 64), full)
        case["planted_fault_row_rel_err"] = rel_f
        note = (f"; planted fault (first KV tile dropped for the last rows): row error "
                f"{rel_f:.3e}, {bad_f} elements outside ATTN_TOL")
    del got, ref
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = cuda_ms(lambda i: flash_attention(q, k, v, causal=True, window=window), reps)
    plain = cuda_ms(lambda i: attention_ref(q, k, v, causal=True, window=window), 2)
    lib = cuda_ms(lambda i: sdpa(qt, kt, vt, is_causal=True), reps)
    flops = 4 * b * h * hd * (s * (s + 1) // 2)
    b_ms, b_by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()), flops, BF16_FLOPS_PER_S)
    log(f"[kernel] flash_attention {what}: B={b} S={s} H={h} KV={kv} hd={hd} window={window}: "
        f"{ms:.4f} ms (plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
        f"{flash_rate(b, s, h, hd, ms, b_ms)}), max_abs_err={err} max_row_rel_err={rel:.3e}"
        f"{note}")
    case.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    return case


def scan_and_expert_kernel_checks(dev, reps: int = 10) -> dict[str, dict]:
    """``rglru_scan`` and ``moe_gemm`` against their plain versions on the
    card at the main paths' shapes, each with a planted fault that its check
    must reject, and their times.

    * rglru_scan at RecurrentGemma's prefill, (8, 2048, 2560) f32, with a ~
      U(0.2, 0.999), b ~ 0.1 N(0,1), h0 ~ N(0,1) (tests/test_kernels.py:
      143-146), at atol = rtol = 1e-5 (the reference's; the kernel rounds as
      the plain version does, so it should agree exactly).  Planted fault:
      the carry reset to 0 at S/2.  No single library call computes it.
    * moe_gemm at every shape Moonlight's path gives it, in bf16: the rows
      of the prefill (4 prompts x capacity 240 = 960), of a decode step (4
      sequences x capacity 1) and of a serve tick (SERVE's 8 slots), each
      for the gate/up product (E, rows, 2048) x (E, 2048, 1408) and the
      down product (E, rows, 1408) x (E, 1408, 2048); x ~ N(0,1), w ~ 0.05
      N(0,1), at ATTN_TOL and ROW_RTOL per output row.  Planted fault: the
      last 32-deep slice of the contraction skipped.  Library yardstick:
      ``torch.bmm``; the decode and serve shapes timed on the device and on
      the host in rounds (``timed_rounds``).  Then the mma body on the x of
      a real dispatch (``moe_dispatch_cases``) and both tensor-core bodies
      at the row threshold of ``kernel_path`` (``moe_row_threshold``).
    """
    import torch

    from repro_torch.kernels import moe_gemm, rglru_scan
    from repro_torch.kernels.moe_gemm.ops import kernel_path as moe_kernel_path
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models.moe import capacity

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    out = {}

    a, bb, h0 = scan_inputs(dev)
    b, s, w = a.shape
    body = scan_ops.kernel_path(a.dtype, w, a.data_ptr() % 16 == 0 and bb.data_ptr() % 16 == 0)
    got = rglru_scan(a, bb, h0)
    ref = rglru_scan_ref(a, bb, h0)
    torch.cuda.synchronize()
    err, bad = max_err(got, ref, SCAN_TOL)
    check(bad == 0, f"rglru_scan: {bad} elements outside atol=rtol=1e-5 (max err {err})")
    check(torch.equal(got, ref), f"rglru_scan is not bit-identical to its plain version "
          f"(max err {err})")
    # Planted faults: the carry reset to 0 at S/2; a ring stage consumed
    # twice (the tma body).
    half = s // 2
    faulty = torch.cat([
        rglru_scan(a[:, :half].contiguous(), bb[:, :half].contiguous(), h0),
        rglru_scan(a[:, half:].contiguous(), bb[:, half:].contiguous(), torch.zeros_like(h0)),
    ], dim=1)
    fault_err, fault_bad = max_err(faulty, ref, SCAN_TOL)
    check(fault_bad > 0, "the scan check passes a planted fault (carry reset at S/2)")
    _, steps, _ = scan_ops.plan(b, s, w, a.dtype)
    scan_ops.launch(a, bb, h0, faulty, "tma", fault_stage=5)
    torch.cuda.synchronize()
    stage_err, stage_bad = max_err(faulty, ref, SCAN_TOL)
    check(stage_bad > 0 and not torch.equal(faulty, ref),
          "the scan check passes a planted fault (ring stage 5 consumed twice)")
    check(torch.equal(faulty[:, : 5 * steps], ref[:, : 5 * steps]),
          "the planted stage fault changed the steps before it")
    del faulty
    times = scan_timings(a, bb, h0)
    plain = cuda_ms(lambda i: rglru_scan_ref(a, bb, h0), 3)
    b_ms, b_by = bound_ms(4 * (3 * a.numel() + h0.numel()), 2 * a.numel(), F32_FLOPS_PER_S)
    ms = times["kernel"]["device_ms"]
    log(f"[kernel] rglru_scan B={b} S={s} W={w} f32, {body} body ({scan_ops.TILE}-channel "
        f"tiles): kernel "
        f"{fmt_rounds(times['kernel'])} ({4 * 3 * a.numel() / ms / 1e9:.3f} TB/s); yardstick "
        f"torch.add(a, b, out=o) {fmt_rounds(times['add'])}; plain {plain:.4f} ms; bound "
        f"{b_ms:.4f} ms by {b_by} ({b_ms / ms:.1%} of it); bit-identical (max_abs_err={err}); "
        f"planted faults: carry reset at S/2, max err {fault_err}, {fault_bad} elements outside "
        f"SCAN_TOL; ring stage 5 consumed twice, max err {stage_err}, {stage_bad} outside")
    out["rglru_scan"] = dict(
        route="cuda",
        source="src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan/rglru_scan.py:45",
        max_abs_err=err,
        planted_fault_elements=min(fault_bad, stage_bad),
        body=body,
        tile=scan_ops.TILE,
        ms=ms,
        host_ms=times["kernel"]["host_ms"],
        plain_ms=plain,
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
        yardstick="torch.add(a, b, out=o), same bytes (no single call computes the function)",
        yardstick_ms=times["add"]["device_ms"],
        times=times,
        shape=f"a, b ({b},{s},{w}) h0 ({b},{w}) f32",
    )
    del a, bb, h0, got, ref

    moe_cfg = lm_config(MOE_ARCH)
    e = moe_cfg.moe.num_experts
    cases = []
    for label, rows, d, f in (
        (what, rows, d, f)
        for what, rows in (("prefill", MOE_BATCH * capacity(moe_cfg, MOE_PROMPT)),
                           ("decode", MOE_BATCH * capacity(moe_cfg, 1)),
                           ("serve decode", SERVE["slots"] * capacity(moe_cfg, 1)))
        for d, f in ((moe_cfg.d_model, moe_cfg.d_ff), (moe_cfg.d_ff, moe_cfg.d_model))
    ):
        label = f"{label}, {'gate/up' if d == moe_cfg.d_model else 'down'}"
        x = torch.randn(e, rows, d, generator=gen, device=dev).to(torch.bfloat16)
        wt = (0.05 * torch.randn(e, d, f, generator=gen, device=dev)).to(torch.bfloat16)
        got = moe_gemm(x, wt)
        torch.cuda.synchronize()
        ref = moe_gemm_ref(x, wt)
        err, rel = row_check(f"moe_gemm ({label}) against its plain version", got, ref)
        fault, fault_bad = planted_fault(
            "moe_gemm without its last 32-deep slice of the contraction",
            moe_gemm(x[..., : d - 32].contiguous(), wt[:, : d - 32].contiguous()), ref)
        body = moe_kernel_path(e, rows, d, f, torch.bfloat16, True)
        flops = 2 * e * rows * d * f
        b_ms, b_by = bound_ms(2 * (x.numel() + wt.numel() + e * rows * f), flops,
                              BF16_FLOPS_PER_S)
        case = dict(shape=f"x ({e},{rows},{d}) w ({e},{d},{f}) bf16 ({label})", body=body,
                    max_abs_err=err, max_row_rel_err=rel, planted_fault_row_rel_err=fault,
                    bound_ms=b_ms, bound_by=b_by)
        if body == "mma":
            # Decode and serve: device and host time apart, in rounds.
            times = timed_rounds({"kernel": (lambda i: moe_gemm(x, wt), 4 * reps),
                                  "bmm": (lambda i: torch.bmm(x, wt), 4 * reps),
                                  "plain": (lambda i: moe_gemm_ref(x, wt), 3)})
            case.update(ms=times["kernel"]["device_ms"], host_ms=times["kernel"]["host_ms"],
                        plain_ms=times["plain"]["device_ms"],
                        library_ms=times["bmm"]["device_ms"], times=times)
            timing = (f"kernel {fmt_rounds(times['kernel'])}; torch.bmm "
                      f"{fmt_rounds(times['bmm'])}; plain {fmt_rounds(times['plain'])}")
        else:
            case.update(ms=cuda_ms(lambda i: moe_gemm(x, wt), reps),
                        plain_ms=cuda_ms(lambda i: moe_gemm_ref(x, wt), max(2, reps // 5)),
                        library_ms=cuda_ms(lambda i: torch.bmm(x, wt), reps))
            timing = (f"{case['ms']:.4f} ms (plain {case['plain_ms']:.4f} ms, torch.bmm "
                      f"{case['library_ms']:.4f} ms)")
        log(f"[kernel] moe_gemm {label} ({e},{rows},{d})x({e},{d},{f}) bf16, {body} body: "
            f"{timing}, bound {b_ms:.4f} ms by {b_by}; {flops / case['ms'] / 1e9:.1f} TFLOP/s; "
            f"max_abs_err={err} max_row_rel_err={rel:.3e}; planted fault (last 32-deep K slice "
            f"skipped): row error {fault:.3e}, {fault_bad} elements outside ATTN_TOL")
        cases.append(case)
        del x, wt, got, ref
    dispatch = moe_dispatch_cases(dev, gen, moe_cfg, reps)
    threshold = moe_row_threshold(dev, gen, e, moe_cfg.d_model, moe_cfg.d_ff, reps)
    main = {k: v for k, v in cases[0].items() if k not in ("shape", "body")}
    main.update(max_abs_err=max(c["max_abs_err"] for c in cases),
                max_row_rel_err=max(c["max_row_rel_err"] for c in cases))
    out["moe_gemm"] = dict(
        route="cuda",
        source="src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu",
        replaces="src/repro/kernels/moe_gemm/moe_gemm.py:49",
        cases=cases,
        dispatch_cases=dispatch,
        row_threshold=threshold,
        **main,
    )
    return out


def moe_dispatch_cases(dev, gen, cfg, reps: int) -> list[dict]:
    """The mma body on the x a real top-k dispatch gives it (``_row_dispatch``
    from seeded router logits): a decode step's 4 rows and a serve tick's 8,
    for the gate/up product and for the down product on the activation of
    the gate/up outputs.  Experts that no row chose have all-zero rows,
    which the body skips.  Each output is held exactly equal (torch.equal)
    to the same body with the skip turned off (the live experts' sums are
    the same sums in the same order), to the plain version by the row
    check, and to zero on every dead expert's rows; a planted fault (a live
    expert treated as dead) must fail the row check.  Times: the kernel,
    the same body without the skip, ``torch.bmm`` and the plain version;
    bounds: the dense product's bytes, and the live experts' weights plus x
    and out (the bytes the skip leaves to read)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import moe_gemm
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    from repro_torch.models.moe import _row_dispatch

    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    bf16 = torch.bfloat16
    w_gate, w_up = ((0.05 * torch.randn(e, d, f, generator=gen, device=dev)).to(bf16)
                    for _ in range(2))
    w_down = (0.05 * torch.randn(e, f, d, generator=gen, device=dev)).to(bf16)
    router = (torch.randn(d, e, generator=gen, device=dev) / d**0.5).to(bf16)
    out = []
    for label, b in (("decode", MOE_BATCH), ("serve", SERVE["slots"])):
        tokens = torch.randn(b, 1, d, generator=gen, device=dev).to(bf16)
        tok_slot, _, used, _, chosen = _row_dispatch(cfg, tokens, router, 1)
        rows = torch.arange(b, device=dev)[:, None]
        xin = tokens[rows, tok_slot] * used[..., None].to(bf16)
        xin = xin.reshape(b, e, 1, d).transpose(0, 1).reshape(e, b, d).contiguous()
        h = F.silu(moe_gemm(xin, w_gate)) * moe_gemm(xin, w_up)
        for product, x, w in (("gate/up", xin, w_up), ("down", h, w_down)):
            what = f"moe_gemm {label} dispatch, {product}"
            live = (x.view(torch.int16) & 0x7FFF).ne(0).flatten(1).any(1)
            n_live = int(live.sum())
            check(n_live == int(torch.unique(chosen).numel()),
                  f"{what}: {n_live} experts with rows, {torch.unique(chosen).numel()} chosen")
            check(moe_ops.kernel_path(e, b, x.shape[2], w.shape[2], bf16, True) == "mma",
                  f"{what}: not the mma body")
            got = moe_gemm(x, w)
            dense = torch.empty_like(got)
            moe_ops.launch(x, w, dense, "mma", skip_dead=False)
            torch.cuda.synchronize()
            check(torch.equal(got, dense), f"{what}: the skip changed a live expert's output")
            check(not bool(got[~live].any()), f"{what}: a dead expert's rows are not zero")
            ref = moe_gemm_ref(x, w)
            scale = float(ref.float().abs().max())
            tol = dict(atol=ATTN_TOL["atol"] * scale, rtol=ATTN_TOL["rtol"])
            err, rel = row_check(f"{what} against its plain version", got, ref, tol)
            faulty = torch.empty_like(got)
            moe_ops.launch(x, w, faulty, "mma", dead_expert=int(live.nonzero()[0]))
            fault, _ = planted_fault(f"{what} with a live expert treated as dead", faulty, ref)
            del dense, faulty
            times = timed_rounds({
                "kernel": (lambda i, x=x, w=w: moe_gemm(x, w), 4 * reps),
                "no_skip": (lambda i, x=x, w=w, o=got: moe_ops.launch(x, w, o, "mma",
                                                                        skip_dead=False),
                            4 * reps),
                "bmm": (lambda i, x=x, w=w: torch.bmm(x, w), 4 * reps),
                "plain": (lambda i, x=x, w=w: moe_gemm_ref(x, w), 3)})
            io = 2 * (x.numel() + e * b * w.shape[2])
            b_ms, b_by = bound_ms(io + 2 * w.numel(), 2 * x.numel() * w.shape[2],
                                  BF16_FLOPS_PER_S)
            live_ms, _ = bound_ms(io + 2 * n_live * w[0].numel(),
                                  2 * n_live * b * x.shape[2] * w.shape[2], BF16_FLOPS_PER_S)
            kern_t = times["kernel"]
            log(f"[kernel] {what}: x ({e},{b},{x.shape[2]}) w ({e},{x.shape[2]},{w.shape[2]}) "
                f"bf16, {n_live} of {e} experts live: kernel {fmt_rounds(kern_t)}; same body "
                f"without the skip {fmt_rounds(times['no_skip'])}; torch.bmm "
                f"{fmt_rounds(times['bmm'])}; plain {fmt_rounds(times['plain'])}; bound "
                f"{b_ms:.4f} ms dense, {live_ms:.4f} ms live by bytes "
                f"({live_ms / kern_t['device_ms']:.1%} of it on the device); equal to the dense "
                f"body (torch.equal), dead rows 0, max_abs_err={err} (max |out| {scale}) "
                f"max_row_rel_err={rel:.3e}; planted fault (a live expert treated as dead): row "
                f"error {fault:.3e}")
            out.append(dict(shape=f"x ({e},{b},{x.shape[2]}) w ({e},{x.shape[2]},{w.shape[2]}) "
                                  f"bf16 ({label} dispatch, {product})",
                            live_experts=n_live, max_abs_err=err, max_row_rel_err=rel,
                            planted_fault_row_rel_err=fault, ms=kern_t["device_ms"],
                            host_ms=kern_t["host_ms"], plain_ms=times["plain"]["device_ms"],
                            library_ms=times["bmm"]["device_ms"], bound_ms=b_ms, bound_by=b_by,
                            live_bound_ms=live_ms, times=times))
            del got, ref
        del tokens, xin, h
    del w_gate, w_up, w_down
    return out


def moe_row_threshold(dev, gen, e: int, d_model: int, d_ff: int, reps: int) -> list[dict]:
    """Both tensor-core bodies of moe_gemm, launched directly, at one row
    below and at ``WGMMA_MIN_ROWS`` (the rows where ``kernel_path`` turns
    from mma.sync to wgmma), for both products; each output is row-checked
    against the plain version.  These launches bypass the wrapper's count."""
    import torch

    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    rows_out = []
    for rows in (moe_ops.WGMMA_MIN_ROWS - 1, moe_ops.WGMMA_MIN_ROWS):
        for d, f in ((d_model, d_ff), (d_ff, d_model)):
            x = torch.randn(e, rows, d, generator=gen, device=dev).to(torch.bfloat16)
            wt = (0.05 * torch.randn(e, d, f, generator=gen, device=dev)).to(torch.bfloat16)
            ref = moe_gemm_ref(x, wt)
            row = dict(rows=rows, d=d, f=f, chosen=moe_ops.kernel_path(
                e, rows, d, f, torch.bfloat16, True))
            for body in ("mma", "wgmma"):
                got = torch.empty(e, rows, f, dtype=torch.bfloat16, device=dev)

                def launch(i, body=body, got=got, x=x, wt=wt):
                    moe_ops.launch(x, wt, got, body)

                launch(0)
                torch.cuda.synchronize()
                row_check(f"moe_gemm's {body} body at {rows} rows", got, ref)
                row[f"{body}_ms"] = cuda_ms(launch, reps)
            log(f"[kernel] moe_gemm row threshold ({e},{rows},{d})x({e},{d},{f}): mma.sync body "
                f"{row['mma_ms']:.4f} ms, wgmma body {row['wgmma_ms']:.4f} ms; kernel_path picks "
                f"{row['chosen']}")
            rows_out.append(row)
            del x, wt, ref
    return rows_out


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


def synced_states(eng) -> list[dict]:
    """Every key group's state dict, the compiled tier's device columns
    materialized into the store first (``sync_store``)."""
    if getattr(eng, "_jit", None) is not None:
        eng._jit.sync_store()
    return [s for _, s in eng.store.items()]


def _close(a, b) -> bool:
    """Structure, keys, insertion order and integers equal; floats within
    JIT_RTOL (tests/conformance.py's approx_equal)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or math.isclose(a, b, rel_tol=JIT_RTOL, abs_tol=JIT_RTOL)
    if isinstance(a, dict):
        return list(a) == list(b) and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


def states_close(a: list, b: list) -> bool:
    return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))


def profile_ticks(eng, batches) -> dict:
    """The device's busy share of steady ticks (push + tick each): the
    ticks run once plain, timed on the host clock, and once more under
    torch.profiler, whose device events (every kernel, copy and memset)
    give the busy time; busy over the plain wall time is the share (the
    profiled wall time, inflated by the profiler, is given apart)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def ticks():
        for k, v, ts in batches:
            eng.push_source("airline", k, v, ts)
            eng.tick()
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ticks()
        wall_prof = time.perf_counter() - t0
    rows = device_kernels(prof)
    busy = sum(r[0] for r in rows) / 1e6
    return dict(ticks=len(batches), wall_s=wall, busy_s=busy,
                busy_share=busy / wall if rows else None, profiled_wall_s=wall_prof,
                top=[(k, round(us / 1e3, 3), n) for us, k, n in rows[:8]])


def host_profile_call(fn, top: int = 12) -> list:
    """cProfile's cumulative seconds of the port's own functions over one
    call of ``fn`` (then a synchronization), largest first, as (function,
    seconds, calls)."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    rows = [(f"{Path(f).stem}.{name}", ct, nc)
            for (f, _, name), (_, nc, _, ct, _) in pstats.Stats(prof).stats.items()
            if "repro_torch" in f]
    return [(name, round(ct, 4), nc) for name, ct, nc in sorted(rows, key=lambda r: -r[1])[:top]]


def host_profile(eng, batches, top: int = 12) -> list:
    """Where the host's time goes in steady ticks (push + tick each, then a
    synchronization): cProfile's cumulative seconds of the port's own
    functions, largest first, as (function, seconds, calls).  cProfile
    charges every Python call, so the Python-heavy parts read high."""

    def ticks():
        for k, v, ts in batches:
            eng.push_source("airline", k, v, ts)
            eng.tick()

    return host_profile_call(ticks, top)


def time_keyed_running_sum(eng, batch) -> dict:
    """``keyed_running_sum`` (the compiled tier's keyed running sum, torch
    ops) at the steady segment size: sumdelay's table as the run left it
    (grown as the runtime would for one more call) and one batch's (plane,
    year) codes, device and host ms per call in ROUNDS rounds, beside the
    bytes bound of its inputs and outputs."""
    import torch

    from repro_torch.engine import jitexec as jx

    op = eng.topology._resolve("sumdelay")
    ost = eng._jit._by_op[op]
    k, v, _ = batch
    n = len(k)
    dev = eng.device
    table, cnt = ost.cols["sums"], ost.cnt_host["sums"]
    if cnt + n > table.codes.shape[0]:
        table = jx.grown_table(table, jx._bucket(cnt + n, jx._MIN_TABLE_CAP))
    cap = table.codes.shape[0]
    planes = v["plane"].astype(np.int64)
    local = eng.topology.keygroups_of(op, planes, None) - ost.base
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        (planes << 32) | v["year"].astype(np.int64), local,
        v["dep_delay"] + v["arr_delay"], np.ones(n, dtype=bool))]
    # ≈150 launches a call: the trace loses a few in every hundred.
    t = timed_rounds({"krs": (lambda i: jx.keyed_running_sum(table, *args), 10)},
                     lost=0.05)["krs"]
    # Inputs (codes, key groups, addends: 8 B; valid: 1 B) and the running
    # sums (8 B) per tuple; the table's five leaves (8+8+8+4+4 B a slot)
    # read once and written once.
    nbytes = n * (8 + 8 + 8 + 1 + 8) + 2 * cap * 32
    b_ms, _ = bound_ms(nbytes, 0)
    t.update(tuples=n, table_cap=cap, table_cnt=cnt, bound_ms=b_ms)
    log(f"[engine/jit] keyed_running_sum at {n} tuples against a {cnt}-entry table "
        f"(capacity {cap}): {fmt_rounds(t)}; bytes bound {b_ms:.4f} ms")
    return t


def run_engine(dev, *, batch: int, kgs: int, nodes: int, ticks: int, check_ticks: int,
               config=None, typed=None):
    """Real Job 3 at full size on the card; the first ticks against the
    port's CPU engine in the same configuration.  With ``typed`` (the
    result of a ``.typed()`` run on the same batches) every tick's counts,
    the final arrival histogram and states are held against it too."""
    import torch

    from repro_torch.data import real_job_3
    from repro_torch.engine import Engine, ExecutionConfig

    config = config or ExecutionConfig.typed()
    jit = config.use_fn_jit
    tag = "engine/jit" if jit else "engine"
    batches = airline_batches(ticks, batch, SEED)

    def make(device):
        eng = Engine(
            real_job_3(keygroups_per_op=kgs),
            nodes,
            config=config,
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
    counts = []
    for t, (k, v, ts) in enumerate(batches):
        t0 = time.perf_counter()
        n = gpu.push_source("airline", k, v, ts)
        gpu.tick()
        torch.cuda.synchronize()
        t_gpu += time.perf_counter() - t0
        check(n == batch, f"tick {t}: admitted {n} of {batch} tuples")
        admitted += n
        counts.append((gpu.metrics.sink_tuples, gpu.metrics.processed_tuples))
        if typed is not None:
            check(counts[t] == typed["counts"][t],
                  f"tick {t}: sink/processed counts {counts[t]} differ from .typed()'s "
                  f"{typed['counts'][t]}")
        if t < check_ticks:
            cpu.push_source("airline", k, v, ts)
            cpu.tick()
            check(
                gpu.metrics.sink_tuples == cpu.metrics.sink_tuples
                and gpu.metrics.processed_tuples == cpu.metrics.processed_tuples,
                f"tick {t}: sink/processed counts differ from the CPU engine",
            )
            if jit:
                check(states_close(synced_states(gpu), synced_states(cpu)),
                      f"tick {t}: key-group state differs from the CPU engine's beyond "
                      f"rtol {JIT_RTOL}")
            else:
                check(
                    state_bytes(gpu) == state_bytes(cpu),
                    f"tick {t}: key-group state differs from the CPU engine",
                )
            check(
                np.array_equal(gpu.window.kg_arrivals, cpu.window.kg_arrivals),
                f"tick {t}: arrival histograms differ from the CPU engine",
            )
            log(f"[{tag}] tick {t}: card == cpu (sink_tuples={gpu.metrics.sink_tuples})")
    del cpu
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
    arrivals = gpu.window.kg_arrivals.copy()
    snap = gpu.end_period()
    check(np.isfinite(snap.kg_load).all(), "non-finite key-group load")
    check(round(snap.kg_tuple_rate.sum() * (ticks + DRAIN_TICKS)) == 4 * admitted,
          "arrival statistics do not count every routed tuple")
    states = synced_states(gpu)
    if typed is not None:
        check(np.array_equal(arrivals, typed["arrivals"]),
              "arrival histograms differ from .typed()'s")
        check(states_close(states, typed["states"]),
              f"key-group state differs from .typed()'s beyond rtol {JIT_RTOL}")
        log(f"[{tag}] counts of every tick, arrival histograms and states == .typed()'s")
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
    res = {
        "tuples_per_s": tps,
        "tick_seconds": t_gpu,
        "drain_seconds": t_drain,
        "admitted": admitted,
        "device_route_seconds": m.device_route_seconds,
        "host_device_copies": m.host_device_copies,
        "host_device_bytes": m.host_device_bytes,
    }
    log(
        f"[{tag}] job3 kgs/op={kgs} nodes={nodes} batch={batch}: {admitted} "
        f"tuples in {ticks} ticks ({t_gpu:.3f} s) + {DRAIN_TICKS} drain ticks "
        f"({t_drain:.3f} s) = {tps:.0f} tuples/s ({admitted / t_gpu:.0f} over "
        f"the feeding ticks alone); device round trips "
        f"{m.device_route_seconds:.3f} s; routed_batches={m.routed_batches} "
        f"host_device_copies={m.host_device_copies} "
        f"host_device_bytes={m.host_device_bytes}"
    )
    if jit:
        comp = gpu._jit.compile_seconds
        check(m.jit_calls > 0 and m.jit_host_syncs == m.jit_calls,
              f"jit_calls {m.jit_calls}, jit_host_syncs {m.jit_host_syncs}")
        res.update(jit_calls=m.jit_calls, jit_compiles=m.jit_compiles,
                   jit_host_syncs=m.jit_host_syncs, jit_tuples=m.jit_tuples,
                   compile_seconds=comp,
                   steady_tuples_per_s=admitted / (t_gpu + t_drain - comp))
        log(f"[{tag}] jit_calls={m.jit_calls} jit_compiles={m.jit_compiles} "
            f"jit_host_syncs={m.jit_host_syncs} jit_tuples={m.jit_tuples}; first calls per "
            f"bucket (compile_seconds) {comp:.3f} s; without them "
            f"{res['steady_tuples_per_s']:.0f} tuples/s")
        res["keyed_running_sum"] = time_keyed_running_sum(gpu, batches[-1])
    else:
        # Kept for the .jit() run on the same batches (copied: the
        # profiled ticks below go on mutating the store's dicts).
        res.update(counts=counts, arrivals=arrivals,
                   states=pickle.loads(pickle.dumps(states, protocol=pickle.HIGHEST_PROTOCOL)))
    prof = profile_ticks(gpu, batches[:3])
    res["profile"] = prof
    res["host_profile"] = host_profile(gpu, batches[3:5])
    log(f"[{tag}] host cProfile of 2 steady ticks, cumulative s (calls): {res['host_profile']}")
    share = prof["busy_share"]
    log(f"[{tag}] {prof['ticks']} steady ticks: wall {prof['wall_s']:.3f} s, device busy "
        f"{prof['busy_s'] * 1e3:.3f} ms ("
        + ("not measured" if share is None else f"{100 * share:.3f} %")
        + f"; profiled wall {prof['profiled_wall_s']:.3f} s); top device events (ms, count): "
        f"{prof['top']}")
    return res


# --------------------------------------------------------------------- phase 3s
# The fused superstep on the benchmark's record pipeline
# (benchmarks/engine_throughput.py:150-265) at phase 3's deployment size:
# BATCH-tuple batches, KGS key groups per operator, NODES nodes.
SS_DEPTH = 4  # src → stage0 → stage1 → stage2 → sink
SS_K = 20  # batches per run_supersteps scan
SS_FUSED_TICKS = 6  # fused tick() batches in check (a); a migration at ticks 2-3
SS_MIGRATE_KG = 1007  # a key group of stage0 (global id)
REC_FIELDS = [("a", "i8"), ("b", "f8")]


def record_pipeline(kgs: int, depth: int, *, key_map: bool):
    """``benchmarks/engine_throughput.py``'s ``make_record_pipeline_job``
    (``_REC_SCHEMA``, ``_COUNT_STATE``, ``_record_stage(17 * (i + 1))``,
    ``_counting_sink*``) on the port's classes, with torch ``fn_jit``
    bodies; ``key_map`` declares the stages' ``jit_key_map`` (over key
    tensors), which puts the scan's routing into staging."""
    from repro_torch.engine import jitexec as jx
    from repro_torch.engine.topology import (
        OperatorSpec,
        Schema,
        StateField,
        StateSchema,
        Topology,
    )

    schema = Schema.record(REC_FIELDS)
    count = StateSchema((StateField("n", "scalar", dtype=np.int64, py=int),))

    def stage(shift):
        def fn(state, keys, values, ts):
            state["n"] = state.get("n", 0) + len(keys)
            return state, [(k, (v[0], v[1] + v[0]), t)
                           for k, v, t in zip(keys.tolist(), values.tolist(), ts.tolist())]

        def fn_seg(store, run_kgs, starts, ends, keys, values, ts):
            for kg, a, z in zip(run_kgs, starts, ends):
                store[kg]["n"] = store[kg].get("n", 0) + (z - a)
            out = np.empty(len(values), dtype=schema.value)
            out["a"], out["b"] = values["a"], values["b"] + values["a"]
            return (keys + shift, out, ts), None

        def fn_jit(state, run_kgs, starts, ends, keys, values, ts):
            out = {"a": values["a"], "b": values["b"] + values["a"]}
            col = jx.count_runs(state["n"], run_kgs, starts, ends)
            return {"n": col}, (keys + shift, out, ts), None

        return fn, fn_seg, fn_jit, (lambda k: k + shift) if key_map else None

    def sink(state, keys, values, ts):
        state["n"] = state.get("n", 0) + len(keys)
        return state, []

    def sink_seg(store, run_kgs, starts, ends, keys, values, ts):
        for kg, a, z in zip(run_kgs, starts, ends):
            store[kg]["n"] = store[kg].get("n", 0) + (z - a)
        return None, None

    def sink_jit(state, run_kgs, starts, ends, keys, values, ts):
        return {"n": jx.count_runs(state["n"], run_kgs, starts, ends)}, None, None

    t = Topology()
    t.add_operator(OperatorSpec("src", None, num_keygroups=kgs, is_source=True, schema=schema))
    prev = "src"
    for i in range(depth - 1):
        fn, fn_seg, fn_jit, kmap = stage(17 * (i + 1))
        t.add_operator(OperatorSpec(
            f"stage{i}", fn, num_keygroups=kgs, fn_seg=fn_seg, fn_jit=fn_jit,
            jit_fusible=True, jit_key_map=kmap, state_schema=count, schema=schema,
            out_schema=schema,
        ))
        t.connect(prev, f"stage{i}")
        prev = f"stage{i}"
    t.add_operator(OperatorSpec(
        "sink", sink, num_keygroups=kgs, is_sink=True, fn_seg=sink_seg, fn_jit=sink_jit,
        jit_fusible=True, state_schema=count, schema=schema,
    ))
    t.connect(prev, "sink")
    return t


def record_batches(count: int, size: int, seed: int) -> list:
    """``count`` record batches of ``size`` tuples: keys uniform in
    [0, 10^6), ``a`` in [0, 1000), ``b`` in [0, 1), as the benchmark's
    ``_record_batch`` makes them."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(count):
        values = np.empty(size, dtype=REC_FIELDS)
        values["a"] = rng.integers(0, 1_000, size=size)
        values["b"] = rng.random(size)
        out.append((rng.integers(0, 1_000_000, size=size), values, np.full(size, float(t))))
    return out


def ss_result(eng) -> dict:
    """Every field ``tests/test_superstep.py::_result`` pins (arrivals and
    usage read before ``end_period`` zeroes them), on the host."""
    arrivals, usage = eng._arrivals.copy(), eng._cpu_usage.copy()
    snap = eng.end_period()
    m = eng.metrics
    return {
        "metrics": [getattr(m, f) for f in ("processed_tuples", "emitted_tuples", "sink_tuples",
                                            "cross_node_tuples", "intra_node_tuples",
                                            "dropped_credits")],
        "sink_outputs": list(m.sink_outputs),
        "states": state_bytes(eng),
        "pair_src": snap.out_pairs.src,
        "pair_dst": snap.out_pairs.dst,
        "pair_rate": snap.out_pairs.rate,
        "arrivals": arrivals,
        "usage": usage,
        "queue_costs": eng.queue_costs(),
        "alloc": eng.router.table.copy(),
    }


def check_same(what: str, a: dict, b: dict) -> None:
    bad = [f for f in a if not (np.array_equal(a[f], b[f]) if isinstance(a[f], np.ndarray)
                                else a[f] == b[f])]
    check(not bad, f"{what}: {bad} differ")


def same_tensors(a, b) -> bool:
    """Structure equal and every tensor ``torch.equal`` (dtype included)."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tensors(x, y) for x, y in zip(a, b))
    return a == b


def run_superstep(dev, card: str, *, batch: int = BATCH, kgs: int = KGS, nodes: int = NODES,
                  k: int = SS_K, fused_ticks: int = SS_FUSED_TICKS, migrate_kg=SS_MIGRATE_KG):
    """Phase 3s: fused ticks and K-tick scans of the record pipeline against
    the card's ``.jit()`` engine, the captured scan against its eager loop,
    the routing kernels inside the graph against their plain versions, and
    everything under the sync debug mode once more."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import Engine, ExecutionConfig
    from repro_torch.kernels.keygroup_partition import fold_keys64
    from repro_torch.kernels.keygroup_partition.ref import keygroup_partition_ref
    from repro_torch.kernels.radix_sort.ref import bucket_argsort_ref

    def make(config, key_map=True):
        eng = Engine(record_pipeline(kgs, SS_DEPTH, key_map=key_map), nodes, config=config,
                     service_rate=1e12, seed=SEED, collect_sinks=False, device=dev)
        eng.backpressure.full_credit = 2 * batch  # admit whole batches
        return eng

    def drain(eng):
        n = 0
        while any(eng.queue_costs()):
            eng.tick()
            n += 1
        torch.cuda.synchronize()
        return n

    batches = record_batches(k, batch, SEED + 5)
    res = {"card": card}

    # (a) fused tick() against the classic .jit() tick, with a migration.
    fused = []  # (seconds, processed tuples, host syncs) per non-empty fused tick
    blobs = {}
    dst = None
    for label in ("jit", "superstep"):
        eng = make(ExecutionConfig.superstep() if label == "superstep" else ExecutionConfig.jit())
        if label == "superstep":
            rt = eng._superstep_rt()
            inner = rt.try_fused_tick

            def timed(eng=eng, inner=inner):
                m = eng.metrics
                busy = any(eng.queue_costs())
                t0, p0, s0 = time.perf_counter(), m.processed_tuples, m.jit_host_syncs
                ok = inner()
                if ok and busy:
                    fused.append((time.perf_counter() - t0, m.processed_tuples - p0,
                                  m.jit_host_syncs - s0))
                return ok

            rt.try_fused_tick = timed
        blobs[label] = []
        dst = (eng.router.node_of(migrate_kg) + 1) % nodes
        for t in range(fused_ticks):
            if t == 2:
                eng.redirect(migrate_kg, dst)
            eng.push_source("src", *batches[t])
            eng.tick()
            if t == 3:
                blobs[label].append(eng.serialize(migrate_kg))
                eng.install(migrate_kg, dst, blobs[label][-1])
        drain(eng)
        res.setdefault("a", {})[label] = ss_result(eng)
        if label == "superstep":
            def two_ticks(eng=eng):
                for bt in batches[fused_ticks : fused_ticks + 2]:
                    eng.push_source("src", *bt)
                    eng.tick()

            res["fused_profile"] = host_profile_call(two_ticks)
        del eng
    check_same("(a) fused ticks vs .jit()", res["a"]["superstep"], res["a"]["jit"])
    check(blobs["jit"] and blobs["superstep"] == blobs["jit"],
          "(a) migration blobs differ from .jit()'s")
    check(len(fused) >= fused_ticks and {s for _, _, s in fused} == {1},
          f"(a) host syncs per fused tick {[s for _, _, s in fused]}, not one each")
    fused_s = sum(s for s, _, _ in fused)
    res["fused_tick"] = dict(ticks=len(fused), seconds=fused_s,
                             tuples_per_s=sum(p for _, p, _ in fused) / fused_s)
    del res["a"]
    log(f"[engine/superstep] (a) {len(fused)} fused ticks + a migration == .jit() (every "
        f"pinned field, blob bytes), one host sync each; fused tick() "
        f"{res['fused_tick']['tuples_per_s']:.0f} processed tuples/s; host cProfile of 2 more "
        f"fused ticks, cumulative s (calls) {res['fused_profile']}; {card}")

    # (b) run_supersteps(K) against .jit() ticked over the same K batches.
    jit = make(ExecutionConfig.jit())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bt in batches:
        jit.push_source("src", *bt)
        jit.tick()
    drained = drain(jit)
    jit_s = time.perf_counter() - t0
    res["jit"] = dict(ticks=k + drained, seconds=jit_s,
                      tuples_per_s=jit.metrics.processed_tuples / jit_s,
                      compile_seconds=jit._jit.compile_seconds)
    want = ss_result(jit)
    del jit
    log(f"[engine/superstep] .jit(): {k} ticks + {drained} drain ticks in {jit_s:.3f} s = "
        f"{res['jit']['tuples_per_s']:.0f} processed tuples/s; {card}")
    for mode in ("static", "device"):
        eng = make(ExecutionConfig.superstep(), key_map=mode == "static")
        m = eng.metrics
        rt = eng._superstep_rt()
        check(rt.plan.static_route == (mode == "static"), f"(b) plan's route is not {mode}")
        s0 = m.jit_host_syncs
        t0 = time.perf_counter()
        eng.run_supersteps(batches)
        first_s = time.perf_counter() - t0
        check(m.jit_host_syncs - s0 == 1, f"(b) {mode}: {m.jit_host_syncs - s0} host syncs a scan")
        drain(eng)
        check_same(f"(b) run_supersteps ({mode} routing) vs .jit()", ss_result(eng), want)
        scan = rt.last_scan
        # Steady state: the second call replays the graph (staging and the
        # fold included, as the reference's row times its scan).
        p0, s0, c0, b0 = m.processed_tuples, m.jit_host_syncs, m.host_device_copies, \
            m.host_device_bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_supersteps(batches)
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
        row = dict(first_call_s=first_s, warmup_s=scan.warmup_seconds,
                   capture_s=scan.capture_seconds, scan_s=scan_s,
                   tuples_per_s=(m.processed_tuples - p0) / scan_s,
                   source_tuples_per_s=k * batch / scan_s,
                   host_syncs=m.jit_host_syncs - s0, copies=m.host_device_copies - c0,
                   copy_bytes=m.host_device_bytes - b0, graph_launches=scan.graph_launches)
        check(row["host_syncs"] == 1, f"(b) {mode}: {row['host_syncs']} host syncs a scan")
        drain(eng)
        # (c) the replay against the same loop run eagerly on its inputs.
        eager = scan.body()
        check(same_tensors(scan.outs, eager),
              f"(c) {mode}: the captured replay differs from the eager K-step loop")
        if mode == "device":
            # (d) the routing kernels inside the graph against their plain
            # versions, on the last step's hops; the check must reject two
            # equal codes swapped in an order.
            routing = ("keygroup_partition", "radix_sort")
            check(all(scan.graph_launches.get(n) == k * (SS_DEPTH - 1) for n in routing),
                  f"(d) graph launches {scan.graph_launches}, not {k * (SS_DEPTH - 1)} each")
            for hop, (ok, comp, dst_ids, order) in enumerate(scan.outs["taps"]):
                ref_ids, _ = keygroup_partition_ref(fold_keys64(ok), kgs)
                check(torch.equal(dst_ids, ref_ids), f"(d) hop {hop}: key groups differ")
                ref_order = bucket_argsort_ref(comp, nodes * kgs + 1)
                check(torch.equal(order, ref_order), f"(d) hop {hop}: order differs")
            sorted_codes = comp[order]
            i = int(torch.nonzero(sorted_codes[1:] == sorted_codes[:-1])[0])
            faulty = order.clone()
            faulty[[i, i + 1]] = order[[i + 1, i]]
            check(not torch.equal(faulty, ref_order), "(d) the order check passes a swap of "
                  "two equal codes")
            del eager, ref_ids, ref_order, faulty
        # The busy share: one more scan under torch.profiler, its device
        # time over the unprofiled scan's wall time.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.run_supersteps(batches)
            torch.cuda.synchronize()
        rows = device_kernels(prof)
        busy = sum(r[0] for r in rows) / 1e6
        row.update(busy_s=busy, busy_share=busy / scan_s if rows else None,
                   top=[(kname, round(us / 1e3, 3), n) for us, kname, n in rows[:6]])
        drain(eng)
        row["host_profile"] = host_profile_call(lambda: eng.run_supersteps(batches))
        drain(eng)
        # The graph alone, by CUDA events.
        row["replay_ms"] = cuda_ms(lambda i: scan.graph.replay(), 5)
        if mode == "static":
            # (e) a scan (replayed) and fused ticks under the sync debug mode.
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.run_supersteps(batches)
                eng.push_source("src", *batches[0])
                drain(eng)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        row["replays"] = scan.replays
        res[mode] = row
        share = row["busy_share"]
        log(f"[engine/superstep] (b) {mode} routing: run_supersteps({k}) == .jit() (every pinned "
            f"field), 1 host sync a scan; first call {first_s:.3f} s (warm-up "
            f"{scan.warmup_seconds:.3f} s, capture {scan.capture_seconds:.3f} s); timed scan "
            f"{scan_s:.4f} s = {row['tuples_per_s']:.0f} processed tuples/s "
            f"({row['source_tuples_per_s']:.0f} source tuples/s), vs_jit "
            f"{row['tuples_per_s'] / res['jit']['tuples_per_s']:.2f}; replay alone "
            f"{row['replay_ms']:.3f} ms; device busy {busy * 1e3:.3f} ms ("
            + ("not measured" if share is None else f"{100 * share:.3f} %")
            + f"); {row['copies']} copies, {row['copy_bytes']} bytes; graph launches per "
            f"replay {scan.graph_launches}; top device events (ms, count) {row['top']}; host "
            f"cProfile of one more scan, cumulative s (calls) {row['host_profile']}; "
            f"(c) replay == eager loop" + ("; (d) routing in the graph == plain versions, "
                                           "planted swap rejected" if mode == "device" else
                                           "; (e) no undeclared sync") + f"; {card}")
        del eng, scan
        gc.collect()
        torch.cuda.empty_cache()
    res["vs_jit"] = res["static"]["tuples_per_s"] / res["jit"]["tuples_per_s"]
    return res


# --------------------------------------------------------------------- phase 4
def run_controller(dev, *, kgs: int, nodes: int, rate: float, ticks: int, periods: int,
                   config=None):
    """ALBIC through Controller.period() on the card; the CPU engine in the
    same configuration mirrors.  Under ``.jit()`` each migration moves a
    key group's table rows out of the device columns (``ensure_dict``) and,
    at its next call, back in (``invalidate``, then the push)."""
    from repro_torch.core import AdaptationFramework, AlbicParams
    from repro_torch.core.migration import execute_plan
    from repro_torch.data import StreamSpec, airline_stream, real_job_3
    from repro_torch.engine import Controller, ControllerConfig, Engine, ExecutionConfig

    config = config or ExecutionConfig.typed()
    jit = config.use_fn_jit
    tag = "controller/jit" if jit else "controller"

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
        return cls(
            topo,
            nodes,
            config=config,
            initial_alloc=ctl_alloc(topo, nodes),
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
    moved_tables = 0
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
            if jit and gpu._jit is not None:
                # Each moved key group of a table operator left the device
                # columns: its installed dict is authoritative until its
                # next call pushes it back.
                for mv in res.migration_plan.moves:
                    ost = gpu._jit._by_op.get(int(gpu._kg_op[mv.keygroup]))
                    if ost is not None and ost.fields:
                        check(not ost.col_auth[mv.keygroup - ost.base],
                              f"period {p}: key group {mv.keygroup} still column-"
                              "authoritative after its migration")
                        moved_tables += 1
        check(
            np.array_equal(gpu.router.table, cpu.router.table),
            f"period {p}: routing tables differ after the plan",
        )
        if jit:
            check(states_close(synced_states(gpu), synced_states(cpu)),
                  f"period {p}: states differ beyond rtol {JIT_RTOL}")
        else:
            check(state_bytes(gpu) == state_bytes(cpu), f"period {p}: states differ")
        total_migrations += m.num_migrations
        log(
            f"[{tag}] period {p}: load_distance={m.load_distance:.6f} "
            f"collocation={m.collocation_factor:.6f} load_index={m.load_index:.6f} "
            f"migrations={m.num_migrations} migration_cost={m.migration_cost:.6f} "
            f"solver_seconds={m.solver_seconds:.3f} "
            f"migration_pause_s={m.migration_pause_s:.6f} latency={m.latency}"
        )
    check(total_migrations >= 1, "the controller ran no migration")
    res = {"migrations": total_migrations}
    if jit:
        check(moved_tables >= 1, "no migration moved a table operator's key group")
        check(gpu.metrics.jit_calls > 0, "the .jit() controller engine made no jit call")
        res.update(moved_table_keygroups=moved_tables, jit_calls=gpu.metrics.jit_calls)
    return res


# --------------------------------------------------------------------- phase 3w
# The multi-worker runtime (repro_torch.engine.cluster) at phase 3's
# deployment, run by ``python3 chip_smoke.py --workers`` in a fresh
# interpreter: its coordinator forks card workers, so it must make no CUDA
# call before every pool is closed (a child forked from a process that
# initialized CUDA cannot use it).  Phase 3w's own card engines (the
# single-process references) run after that, in the same interpreter.
W_WORKERS = 4
W_TICKS = 8  # lockstep ticks of (a) (phase 3 runs 20), then DRAIN_TICKS
W_MIG_TICK = 3  # (b): redirect at this tick, serialize + install at the next
W_FAULT_BATCH, W_FAULT_TICKS = 1 << 14, 3  # (c): the planted map, at a cut depth
W_STREAM_WORKERS = (2, 4)  # (f)
W_STREAM_BATCHES = 8
# tests/conformance.py:131-133, the +workers configuration's statistics
# tolerance (per-worker partial sums of the usage windows).
WORKERS_RTOL, WORKERS_ATOL = 1e-12, 1e-18
W_CHILD_TIMEOUT_S = 660
W_RESULT_TAG = "PHASE3W "
W_METRICS = ("processed_tuples", "emitted_tuples", "sink_tuples", "cross_node_tuples",
             "intra_node_tuples", "dropped_credits")


def workers_result(eng, snap, blobs) -> dict:
    """Every field tests/conformance.py pins for the ``+workers``
    configuration, from a finalized engine and its last snapshot."""
    m = eng.metrics
    return {
        "metrics": [getattr(m, f) for f in W_METRICS],
        "sink_outputs": m.sink_outputs,
        "states": state_bytes(eng),
        "kg_load": snap.kg_load,
        "kg_tuple_rate": snap.kg_tuple_rate,
        "kg_state_bytes": snap.kg_state_bytes,
        "pair_src": snap.out_pairs.src,
        "pair_dst": snap.out_pairs.dst,
        "pair_rate": snap.out_pairs.rate,
        "alloc": eng.router.table.copy(),
        "queue_costs": eng.queue_costs(),
        "migration_blobs": blobs,
    }


def workers_close(a, b) -> bool:
    """tests/conformance.py's approx_equal on floats: |a - b| <= max(rtol *
    max(|a|, |b|), atol) elementwise, shapes equal."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return a.shape == b.shape and bool(np.all(
        (a == b) | (np.abs(a - b) <= np.maximum(
            WORKERS_RTOL * np.maximum(np.abs(a), np.abs(b)), WORKERS_ATOL))))


def workers_diff(a: dict, b: dict) -> list:
    """The fields of two ``workers_result``s that differ: every field exact
    (sink outputs and their order, state bytes, counts, arrivals, routing,
    queues, blobs) but ``kg_load`` and ``pair_rate`` (WORKERS_RTOL/ATOL)."""
    bad = []
    for f in a:
        x, y = a[f], b[f]
        if f in ("kg_load", "pair_rate"):
            same = workers_close(x, y)
        elif isinstance(x, np.ndarray):
            same = np.array_equal(x, y)
        else:
            same = x == y
        if not same:
            bad.append(f)
    return bad


def drained(eng) -> bool:
    cost = getattr(eng, "worst_queue_cost", None)
    return cost() == 0.0 if cost is not None else not any(eng.queue_costs())


def drive_lockstep(eng, batches, *, mig=None, drain: int = DRAIN_TICKS) -> tuple[dict, float]:
    """push + tick per batch (``mig = (tick, kg, dst)``: redirect at that
    tick, serialize and install at the next), drain, fold, finalize; the
    ``workers_result`` and the wall seconds until the fold."""
    blobs = []
    t0 = time.perf_counter()
    for t, (k, v, ts) in enumerate(batches):
        if mig is not None and t == mig[0]:
            eng.redirect(mig[1], mig[2])
        n = eng.push_source("airline", k, v, ts)
        check(n == len(k), f"tick {t}: admitted {n} of {len(k)} tuples")
        eng.tick()
        if mig is not None and t == mig[0] + 1:
            blobs.append(eng.serialize(mig[1]))
            eng.install(mig[1], mig[2], blobs[-1])
    for _ in range(drain):
        eng.tick()
    check(drained(eng), "queues not drained")
    snap = eng.end_period()
    seconds = time.perf_counter() - t0
    eng.finalize()
    return workers_result(eng, snap, blobs), seconds


def job3_engine(device, *, batch: int, config, kgs: int = KGS, nodes: int = NODES,
                collect_sinks: bool = True, **kw):
    """Real Job 3 at phase 3's deployment through ``make_engine``."""
    from repro_torch.data import real_job_3
    from repro_torch.engine import make_engine

    eng = make_engine(real_job_3(keygroups_per_op=kgs), nodes, config=config,
                      service_rate=1e12, seed=SEED, collect_sinks=collect_sinks,
                      device=device, **kw)
    eng.backpressure.full_credit = 2 * batch
    return eng


@contextlib.contextmanager
def interleaved_node_workers():
    """Phase 3w (c)'s planted fault: node i on worker i % n, a map that is
    not contiguous, so the exchange's worker-ordered merge is no longer the
    single-process engine's node order."""
    from repro_torch.engine import cluster

    contiguous = cluster.contiguous_node_worker
    cluster.contiguous_node_worker = lambda n, w: np.arange(n) % w
    try:
        yield
    finally:
        cluster.contiguous_node_worker = contiguous


def lane_bytes_per_tick(topo, batch: int, n: int) -> int:
    """Bytes one (sender → receiver) lane carries in a tick at this size:
    every hop moves ``batch`` tuples a tick, a sender emits 1/n of them and
    sends 1/n of those to each receiver, each as its destination's key and
    value records, the f8 timestamp and the two i8 source columns."""
    total = 0
    for op, dops in topo.downstream().items():
        for dop in dops:
            schema = topo.operators[dop].schema
            total += (schema.key.itemsize + schema.value.itemsize + 8 + 16) * batch
    return -(-total // (n * n))


def timed_ingest(eng) -> list:
    """Wrap a cluster's ingest split (schema conversion, host hashing,
    per-worker slicing and shipping of each admitted batch) to sum its
    wall seconds into the returned one-element list."""
    split = eng._split_and_push
    spent = [0.0]

    def split_and_push(*args):
        t0 = time.perf_counter()
        split(*args)
        spent[0] += time.perf_counter() - t0

    eng._split_and_push = split_and_push
    return spent


def shm_free_bytes() -> int:
    import os

    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def ctl_alloc(topo, nodes: int) -> np.ndarray:
    """Phase 4's anti-collocated start: each operator's key groups dealt
    round robin over the nodes from its own offset."""
    alloc = np.zeros(topo.num_keygroups, dtype=np.int64)
    for op in range(topo.num_operators):
        base = topo.kg_base(op)
        n_op = topo.operators[op].num_keygroups
        alloc[base:base + n_op] = (np.arange(n_op) + op * (nodes // 2 + 1)) % nodes
    return alloc


def ctl_engine(device, config, **kw):
    from repro_torch.data import real_job_3
    from repro_torch.engine import make_engine

    topo = real_job_3(keygroups_per_op=CTL_KGS)
    return make_engine(topo, CTL_NODES, config=config, initial_alloc=ctl_alloc(topo, CTL_NODES),
                       ser_cost=0.6, service_rate=3000.0, seed=SEED, device=device, **kw)


def run_ctl(eng, results=None) -> dict:
    """Phase 4's controller over ``eng`` (ALBIC; ``results``: replay these
    adaptation results instead of solving, each on this engine's own
    snapshot) for CTL_PERIODS periods; snapshots, tables and history."""
    import dataclasses

    from repro_torch.core import AdaptationFramework, AlbicParams
    from repro_torch.data import StreamSpec, airline_stream
    from repro_torch.engine import Controller, ControllerConfig

    class Recording(AdaptationFramework):
        def adapt(self, state, **kw):
            if results is not None:
                res = results[len(self.results)]
                own = state.copy()
                own.alloc = res.state.alloc.copy()
                res = dataclasses.replace(res, state=own)
            else:
                res = super().adapt(state, **kw)
            self.results.append(res)
            return res

    air = airline_stream(StreamSpec(rate=CTL_RATE, seed=SEED))
    fw = Recording(mode="albic", max_migrations=10,
                   albic_params=AlbicParams(max_ld=15.0, time_limit=1.5))
    fw.results = []
    snaps, tables = [], []
    fold = eng.end_period

    def end_period():
        snaps.append(fold())
        return snaps[-1]

    eng.end_period = end_period
    ctl = Controller(eng, fw, ControllerConfig(ticks_per_period=CTL_TICKS),
                     feeder=lambda e, t: e.push_source("airline", *next(air)))
    for _ in range(CTL_PERIODS):
        ctl.period()
        tables.append(eng.router.table.copy())
    eng.finalize()
    return dict(history=ctl.history, results=fw.results, snaps=snaps, tables=tables,
                states=state_bytes(eng))


def ctl_diff(a: dict, b: dict) -> list:
    """Where two controller runs differ: each period's snapshot (kg_load and
    pair rates at the workers tolerance, the rest exact), routing table
    after the plan, PeriodMetrics (counts exact, floats and latency at the
    workers tolerance; the solver's and the pause's wall seconds apart), and
    the final states' bytes."""
    bad = []
    for p, (sa, sb) in enumerate(zip(a["snaps"], b["snaps"])):
        for f in ("kg_tuple_rate", "kg_state_bytes", "alloc", "alive"):
            if not np.array_equal(getattr(sa, f), getattr(sb, f)):
                bad.append(f"period {p} snapshot {f}")
        if not workers_close(sa.kg_load, sb.kg_load):
            bad.append(f"period {p} snapshot kg_load")
        pa, pb = sa.out_pairs, sb.out_pairs
        if not (np.array_equal(pa.src, pb.src) and np.array_equal(pa.dst, pb.dst)
                and workers_close(pa.rate, pb.rate)):
            bad.append(f"period {p} pair rates")
    for p, (ta, tb) in enumerate(zip(a["tables"], b["tables"])):
        if not np.array_equal(ta, tb):
            bad.append(f"period {p} routing table")
    for ma, mb in zip(a["history"], b["history"]):
        for f in ("num_migrations", "num_nodes_alive", "scaling_added", "scaling_marked",
                  "period"):
            if getattr(ma, f) != getattr(mb, f):
                bad.append(f"period {ma.period} {f}")
        for f in ("load_distance", "collocation_factor", "system_load", "load_index",
                  "migration_cost"):
            if not workers_close(getattr(ma, f), getattr(mb, f)):
                bad.append(f"period {ma.period} {f}")
        la, lb = ma.latency, mb.latency
        if la.keys() != lb.keys() or not all(workers_close(la[k], lb[k]) for k in la):
            bad.append(f"period {ma.period} latency")
    if len(a["history"]) != len(b["history"]):
        bad.append("period count")
    if a["states"] != b["states"]:
        bad.append("final states")
    return bad


def run_workers_child(device: str = "cuda", *, batch: int = BATCH, kgs: int = KGS,
                      nodes: int = NODES, ticks: int = W_TICKS,
                      fault_batch: int = W_FAULT_BATCH,
                      stream_batches: int = W_STREAM_BATCHES) -> dict:
    """Phase 3w, in this (fresh) interpreter: the pools (a)-(f) first, with
    no CUDA call here; then this process's own card engines, the
    single-process references; then every comparison.  ``device="cpu"``
    (with small sizes) rehearses it on the host: the plain versions launch
    nothing, so the launch checks are the card's only."""
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import StreamSpec, airline_stream
    from repro_torch.engine import CheckpointPolicy, ExecutionConfig, SupervisionPolicy
    from repro_torch.engine.checkpointing import payload_from_tree, restore_engine
    from repro_torch.engine.faults import FaultPlan
    from repro_torch.kernels import _build

    check(not torch.cuda.is_initialized(), "the coordinator starts with CUDA initialized")
    card = device == "cuda"
    t_start = time.perf_counter()
    if card:
        built = _build.build(["keygroup_partition", "radix_sort"])  # nvcc: no CUDA call
        log(f"[workers] routing kernels built or found: {built}")
    size = dict(kgs=kgs, nodes=nodes)
    launches = {"keygroup_partition": 0, "radix_sort": 0}

    @contextlib.contextmanager
    def pool(eng, what: str):
        """Close ``eng`` whatever happens; fold its workers' launches."""
        try:
            yield eng
        finally:
            eng.close()
        check(not any(p.is_alive() for p in eng.pool.processes),
              f"{what}: worker processes outlived close()")
        for name in launches:
            launches[name] += eng.kernel_launches.get(name, 0)

    # (a) + (b): lockstep at full size, a migration from worker 0 to worker 3.
    batches = airline_batches(ticks, batch, SEED)
    eng = job3_engine(device, batch=batch, config=ExecutionConfig.workers(W_WORKERS), **size)
    topo = eng.topology
    sum_op = topo._resolve("sumdelay")
    base = topo.kg_base(sum_op)
    mig_kg = next(kg for kg in range(base, base + kgs)
                  if eng.node_worker[eng.router.node_of(kg)] == 0)
    mig_dst = int(np.flatnonzero(eng.node_worker == W_WORKERS - 1)[0])
    mig = (W_MIG_TICK, mig_kg, mig_dst)
    mig_src = eng.router.node_of(mig_kg)
    with pool(eng, "lockstep"):
        cluster_a, secs_a = drive_lockstep(eng, batches, mig=mig)
    check(eng.worker_of_node(eng.router.node_of(mig_kg)) == W_WORKERS - 1,
          "(b) the migrated key group is not on the last worker")
    log(f"[workers] (a) .workers({W_WORKERS}) lockstep: {ticks} x {batch} tuples + "
        f"{DRAIN_TICKS} drain ticks in {secs_a:.3f} s (sinks collected); (b) key "
        f"group {mig_kg} moved from node {mig_src} (worker 0) to node {mig_dst} (worker "
        f"{W_WORKERS - 1}) at ticks {W_MIG_TICK}-{W_MIG_TICK + 1}")

    # (c): the planted non-contiguous map, and its control, at a cut depth.
    fault_batches = airline_batches(W_FAULT_TICKS, fault_batch, SEED + 1)
    small = {}
    for label, planted in (("control", False), ("planted", True)):
        with interleaved_node_workers() if planted else contextlib.nullcontext():
            eng = job3_engine(device, batch=fault_batch,
                              config=ExecutionConfig.workers(W_WORKERS), **size)
        check(planted == bool(np.any(np.diff(eng.node_worker) < 0)),
              f"(c) {label}: node → worker map {eng.node_worker.tolist()}")
        with pool(eng, f"fault-{label}"):
            small[label] = drive_lockstep(eng, fault_batches)[0]

    # (d): phase 4's controller over .workers(2).
    eng = ctl_engine(device, ExecutionConfig.workers(2), collect_sinks=False)
    with pool(eng, "controller"):
        ctl_w = run_ctl(eng)
    log(f"[workers] (d) controller over .workers(2): migrations per period "
        f"{[m.num_migrations for m in ctl_w['history']]}")

    # (e): supervision, a planted kill at the end of period 2.
    ck_dir = ROOT / "build" / "smoke_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    sup_cfg = ExecutionConfig.workers(
        W_WORKERS, checkpoint=CheckpointPolicy(str(ck_dir), every=1, keep=CTL_PERIODS),
        supervision=SupervisionPolicy())
    air = airline_stream(StreamSpec(rate=CTL_RATE, seed=SEED + 7))
    sup_batches = [next(air) for _ in range(CTL_PERIODS * CTL_TICKS)]
    eng = ctl_engine(device, sup_cfg, collect_sinks=True, faults=FaultPlan.kill_at_period(1, 2))
    with pool(eng, "supervised"):
        it = iter(sup_batches)
        for _ in range(CTL_PERIODS):
            for _ in range(CTL_TICKS):
                eng.push_source("airline", *next(it))
                eng.tick()
            eng.end_period()
        for _ in range(60):
            if drained(eng):
                break
            eng.tick()
        check(drained(eng), "(e) queues not drained")
        eng.finalize()
    supervised = eng
    reports = supervised.recoveries
    check(len(reports) == 1, f"(e) expected one recovery, got {reports}")
    rep = reports[0]
    check(rep.cause == "kill" and rep.worker == 1 and not rep.gave_up,
          f"(e) unexpected recovery {rep}")
    reborn = [life for life in supervised.worker_stats
              if life["worker"] == 1 and life["incarnation"] == 1 and not life["died"]]
    check(len(reborn) == 1, f"(e) respawned worker's lifetime missing: {supervised.worker_stats}")
    reborn_launches = {k: reborn[0]["launches"].get(k, 0) for k in launches}
    check(not card or all(n > 0 for n in reborn_launches.values()),
          f"(e) the respawned worker launched {reborn_launches}: it did not route on the card")
    log(f"[workers] (e) recovery: worker {rep.worker} ({rep.cause}), checkpoint step "
        f"{rep.restored_step}, cursor {rep.restored_cursor}, orphans {rep.orphans}, rehomed "
        f"{rep.rehomed}, replayed {rep.replayed_batches}, mttr {rep.mttr_s:.3f} s; the "
        f"respawned worker's launches {reborn_launches}")

    # (f): pipelined throughput, default lanes and lanes sized for a tick.
    n_stream = stream_batches
    stream_batches = airline_batches(n_stream, batch, SEED + 2)
    total = n_stream * batch
    free = shm_free_bytes()
    stream = {"dev_shm_free_bytes": free, "tuples": total}
    for n in W_STREAM_WORKERS:
        need = lane_bytes_per_tick(topo, batch, n)
        big = min(-(-2 * need // (1 << 20)) << 20, (free // (2 * n * (n - 1))) >> 20 << 20)
        stream[f"w{n}_lane_bytes_per_tick"] = need
        stream[f"w{n}_big_lane_bytes"] = big
        for label, shm in (("1MiB", 1 << 20), ("big", big)):
            eng = job3_engine(device, batch=batch, collect_sinks=False,
                              config=ExecutionConfig.workers(n, shm=shm), **size)
            with pool(eng, f"stream-w{n}-{label}"):
                eng.run_stream("airline", stream_batches[:1], window=2 * n)  # warm-up
                while not drained(eng):
                    eng.tick()
                ingest = timed_ingest(eng)
                t0 = time.perf_counter()
                accepted = eng.run_stream("airline", stream_batches, window=2 * n)
                while not drained(eng):
                    eng.tick()
                wall = time.perf_counter() - t0
                eng.finalize()
            check(accepted == total, f"(f) w{n} {label}: accepted {accepted} of {total}")
            check(eng.metrics.sink_tuples == 2 * (total + batch), f"(f) w{n} {label}: sink "
                  f"tuples {eng.metrics.sink_tuples}")
            rate = total / wall
            stream[f"w{n}_{label}"] = dict(
                tuples_per_s=rate, wall_s=wall, coordinator_ingest_s=ingest[0],
                shm_lane_bytes=shm, exchange=dict(eng.exchange_stats),
                per_worker=[dict(worker=life["worker"],
                                 device_route_seconds=life["metrics"]["device_route_seconds"],
                                 host_device_copies=life["metrics"]["host_device_copies"])
                            for life in eng.worker_stats])
            log(f"[workers] (f) run_stream .workers({n}, shm={shm}): {rate:.0f} tuples/s "
                f"({wall:.3f} s, of which the coordinator's ingest split {ingest[0]:.3f} s); "
                f"exchange {stream[f'w{n}_{label}']['exchange']}; per worker "
                f"{stream[f'w{n}_{label}']['per_worker']}")

    # (g): only now this process's own CUDA calls.
    initialized = torch.cuda.is_initialized()
    log(f"[workers] (g) coordinator torch.cuda.is_initialized() before its first CUDA "
        f"call: {initialized}")
    check(not initialized, "(g) the coordinator initialized CUDA while it had pools")
    if card:
        check(torch.cuda.is_available(), "(g) CUDA not available to the coordinator")
    dev = torch.device(device, 0) if card else torch.device("cpu")

    single_a, secs_single = drive_lockstep(
        job3_engine(dev, batch=batch, config=ExecutionConfig.typed(), **size), batches, mig=mig)
    bad = workers_diff(cluster_a, single_a)
    check(not bad, f"(a) .workers({W_WORKERS}) differs from the single-process card engine "
          f"in {bad}")
    check(len(single_a["migration_blobs"]) == 1 and len(single_a["migration_blobs"][0]) > 64,
          "(b) no migration blob")
    log(f"[workers] (a) bit-identical to the single-process card engine ({secs_single:.3f}"
        f" s): {len(single_a['sink_outputs'])} sink outputs in order, {len(single_a['states'])} "
        f"states, counts {single_a['metrics']}; kg_load and pair_rate within rtol "
        f"{WORKERS_RTOL}; (b) blob of key group {mig_kg}: {len(single_a['migration_blobs'][0])} "
        f"bytes, equal")
    del cluster_a, single_a
    gc.collect()

    single_c = drive_lockstep(job3_engine(dev, batch=fault_batch, config=ExecutionConfig.typed(),
                                          **size), fault_batches)[0]
    ok_fields, bad_fields = workers_diff(small["control"], single_c), workers_diff(
        small["planted"], single_c)
    check(not ok_fields, f"(c) the contiguous control differs in {ok_fields}")
    check(bool(bad_fields), "(c) the planted non-contiguous map was not rejected")
    log(f"[workers] (c) planted non-contiguous node map rejected: {bad_fields} differ "
        f"(contiguous control at the same size: equal)")

    ctl_s = run_ctl(ctl_engine(dev, ExecutionConfig.typed(), collect_sinks=False),
                    results=ctl_w["results"])
    bad = ctl_diff(ctl_w, ctl_s)
    check(not bad, f"(d) controller over workers differs from single-process: {bad}")
    migrations = sum(m.num_migrations for m in ctl_w["history"])
    check(migrations >= 1, "(d) the controller ran no migration")
    log(f"[workers] (d) PeriodMetrics, snapshots, tables and states == single-process "
        f"({migrations} migrations)")

    tree, meta = CheckpointManager(str(ck_dir)).restore(step=rep.restored_step)
    payload = payload_from_tree(tree)
    check(meta["ingest_cursor"] == rep.restored_cursor, "(e) checkpoint cursor")
    payload["table"] = np.asarray(supervised.router.table, dtype=np.int64).copy()
    oracle = ctl_engine(dev, ExecutionConfig.typed(), collect_sinks=True)
    restore_engine(oracle, payload)
    for b in sup_batches[rep.restored_cursor:]:
        oracle.push_source("airline", *b)
        oracle.tick()
    for _ in range(60):
        if drained(oracle):
            break
        oracle.tick()
    tail = supervised.metrics.sink_outputs[rep.restored_sink_len:]
    check(tail == oracle.metrics.sink_outputs, "(e) sinks after the recovery's mark differ "
          "from the oracle replayed from the checkpoint")
    same_states = ({kg: s for kg, s in supervised.store.items() if s}
                   == {kg: s for kg, s in oracle.store.items() if s})
    check(same_states, "(e) states differ from the oracle replay")
    log(f"[workers] (e) converged to the oracle replay: {len(tail)} sink outputs after the "
        f"mark, states equal")

    single = job3_engine(dev, batch=batch, collect_sinks=False, config=ExecutionConfig.typed(),
                         **size)
    single.push_source("airline", *stream_batches[0])  # warm-up, as the workers'
    while not drained(single):
        single.tick()
    t0 = time.perf_counter()
    for b in stream_batches:
        single.push_source("airline", *b)
        single.tick()
    while not drained(single):
        single.tick()
    stream["single_tuples_per_s"] = total / (time.perf_counter() - t0)
    for n in W_STREAM_WORKERS:
        for label in ("1MiB", "big"):
            stream[f"w{n}_{label}"]["vs_single"] = (
                stream[f"w{n}_{label}"]["tuples_per_s"] / stream["single_tuples_per_s"])
        stream[f"w{n}_vs_single"] = stream[f"w{n}_1MiB"]["vs_single"]
    log(f"[workers] (f) single-process .typed() {stream['single_tuples_per_s']:.0f} tuples/s; "
        + "; ".join(f"w{n}: {stream[f'w{n}_1MiB']['vs_single']:.3f}x at 1 MiB lanes, "
                    f"{stream[f'w{n}_big']['vs_single']:.3f}x at "
                    f"{stream[f'w{n}_big_lane_bytes']} B lanes (one tick needs "
                    f"{stream[f'w{n}_lane_bytes_per_tick']} B a lane)"
                    for n in W_STREAM_WORKERS)
        + f"; /dev/shm free {free} B")
    check(not card or all(n > 0 for n in launches.values()), f"(g) worker launches {launches}")
    log(f"[workers] (g) launches folded from every worker of every pool: {launches}")
    return dict(ok=True, launches=launches, stream=stream, migrations=migrations,
                recovery=dict(worker=rep.worker, restored_step=rep.restored_step,
                              replayed=rep.replayed_batches, mttr_s=rep.mttr_s,
                              reborn_launches=reborn_launches),
                fault_fields=bad_fields, coordinator_cuda_initialized_before=initialized,
                seconds=time.perf_counter() - t_start)


def run_workers(timeout: float = W_CHILD_TIMEOUT_S) -> dict:
    """Phase 3w in a fresh interpreter (``--workers``): relays its log
    lines, returns its result; any failure there fails this run."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--workers"],
                             capture_output=True, text=True, timeout=timeout, cwd=str(ROOT))
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"phase 3w did not finish in {timeout} s: "
                           f"{(e.stderr or '')[-3000:]}") from e
    result = None
    for line in out.stdout.splitlines():
        if line.startswith(W_RESULT_TAG):
            result = json.loads(line[len(W_RESULT_TAG):])
        else:
            log(line)
    check(out.returncode == 0, f"phase 3w failed (exit {out.returncode}): {out.stderr[-4000:]}")
    check(result is not None, "phase 3w printed no result line")
    check(result.get("ok") is True, f"phase 3w result not ok: {result}")
    log(f"[workers] phase 3w child: {time.perf_counter() - t0:.1f} s wall")
    return result


def workers_main() -> int:
    """``--workers``: phase 3w alone, with no CUDA call before its pools are
    closed (so not ``torch.cuda.is_available()`` either: the parent run
    checked it; this interpreter's first CUDA call is in (g))."""
    sys.path.insert(0, str(SRC))
    try:
        result = run_workers_child()
    except SmokeFailure as e:
        print(f"chip_smoke --workers: FAILED: {e}", file=sys.stderr)
        return 1
    print(W_RESULT_TAG + json.dumps(result, default=float), flush=True)
    return 0


# ------------------------------------------------------------------ phases 5-8
def lm_config(arch: str = LM_ARCH, context: int = LM_CONTEXT, *, smoke: bool = False):
    """The LM config at full width (or SMOKE, for a rehearsal on the CPU),
    ``max_seq_len`` cut to the context."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, smoke=smoke), max_seq_len=context)


def layer_counts(cfg) -> dict[str, int]:
    """Layers of each kernel-bearing kind: attention (ATTN, ATTN_MOE,
    LOCAL_ATTN), RG-LRU and MoE."""
    from repro_torch.configs.base import ATTN, ATTN_MOE, LOCAL_ATTN, RGLRU

    kinds = list(cfg.pattern) * cfg.cycles + list(cfg.remainder)
    return dict(attn=sum(k in (ATTN, ATTN_MOE, LOCAL_ATTN) for k in kinds),
                rglru=kinds.count(RGLRU), moe=kinds.count(ATTN_MOE))


def expected_launches(cfg, steps: int) -> dict[str, int]:
    """Launches of one prefill and ``steps`` decode steps: flash once per
    attention layer and rglru_scan once per RG-LRU layer in the prefill;
    decode attention once per attention layer and step; moe_gemm three
    times (gate, up, down) per MoE layer in the prefill and in each step."""
    n = layer_counts(cfg)
    return {"flash_attention": n["attn"], "decode_attention": n["attn"] * steps,
            "rglru_scan": n["rglru"], "moe_gemm": 3 * n["moe"] * (1 + steps)}


def prefill_decode(dev, cfg, params, *, batch: int, prompt: int, steps: int,
                   context: int) -> dict:
    """Prefill ``batch`` prompts of numpy-seeded tokens through
    ``Model.forward(build_cache=True)``, then decode ``steps`` tokens
    greedily; returns timings and what the consistency check needs."""
    import torch

    from repro_torch.models import Model

    model = Model(cfg)
    tokens = torch.from_numpy(
        np.random.default_rng(SEED).integers(0, cfg.vocab_size, (batch, prompt))
    ).to(dev)
    t0 = time.perf_counter()
    logits, cache, _ = model.forward(params, tokens=tokens, build_cache=True,
                                     cache_capacity=context)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    check(tuple(logits.shape) == (batch, prompt, cfg.vocab_size), "prefill logits shape")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    tok = logits[:, -1].argmax(-1)
    del logits
    first_tok, first_logits = tok.clone(), None
    step_s = []
    for step in range(steps):
        pos = torch.full((batch,), prompt + step, dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        out, cache = model.decode_step(params, cache, tok[:, None], pos)
        tok = out[:, 0].argmax(-1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(out).all()), f"non-finite logits at decode step {step}")
        if step == 0:
            first_logits = out[:, 0].float().clone()
    steady = sorted(step_s[1:]) or step_s
    ms_step = 1e3 * steady[len(steady) // 2]
    log(f"[lm] {cfg.name} L={cfg.num_layers} d={cfg.d_model} V={cfg.vocab_size}: prefill "
        f"{batch}x{prompt} in {t_prefill:.3f} s = {batch * prompt / t_prefill:.0f} tokens/s; "
        f"decode {ms_step:.3f} ms/step (median of {len(steady)}; first "
        f"{1e3 * step_s[0]:.3f}) = {batch / (ms_step / 1e3):.1f} tokens/s")
    return dict(
        prefill_s=t_prefill,
        prefill_tokens_per_s=batch * prompt / t_prefill,
        decode_ms_per_step=ms_step,
        decode_tokens_per_s=batch / (ms_step / 1e3),
        first_step_ms=1e3 * step_s[0],
        tokens=tokens,
        first_tok=first_tok,
        first_logits=first_logits,
        cache=cache,
        last_tok=tok,
        next_pos=prompt + steps,
    )


def _paired(errs: list):
    """A hook that holds a kernel's output against a second computation of
    the same attention on the same activations.  The bf16 tolerance is for
    unit-scale values and these activations are not (|v| reaches ~100 at
    this initialization), so atol scales with the largest value the outputs
    average over; the row check (ROW_RTOL) is scale-free."""

    def hold(what, out, ref, values):
        scale = float(values.abs().max())
        tol = dict(atol=ATTN_TOL["atol"] * scale, rtol=ATTN_TOL["rtol"])
        errs.append(row_check(what, out, ref, tol) + (scale,))

    return hold


def _paired_summary(errs: list, layers: int, what: str) -> tuple[float, float, float]:
    check(len(errs) == layers, f"{what}: paired {len(errs)} layers, not {layers}")
    return (max(e for e, _, _ in errs), max(r for _, r, _ in errs),
            max(v for _, _, v in errs))


def _paired_gemm(errs: list, gemm, where: str):
    """``gemm`` (the routed moe_gemm) with each call's output held against
    ``moe_gemm_ref`` on the same dispatched activations.  Real activations
    are not unit-scale: atol scales with the outputs (the row check is
    scale-free)."""
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    def paired(x, w):
        out = gemm(x, w)
        ref = moe_gemm_ref(x, w)
        scale = float(ref.float().abs().max())
        tol = dict(atol=ATTN_TOL["atol"] * scale, rtol=ATTN_TOL["rtol"])
        errs.append(row_check(f"moe_gemm against its plain version inside the {where}",
                              out, ref, tol) + (scale,))
        return out

    return paired


def _gemm_summary(errs: list, moe_layers: int, prefix: str) -> tuple[dict, str]:
    """The JSON keys and the log text of a run's moe_gemm pairings (none
    for a model without MoE layers)."""
    check(len(errs) == 3 * moe_layers, f"paired moe_gemm {len(errs)} times, not "
          f"{3 * moe_layers}")
    if not errs:
        return {}, ""
    worst, rel, vmax = _paired_summary(errs, 3 * moe_layers, "moe_gemm")
    return ({f"{prefix}gemm_products_paired": len(errs), f"{prefix}gemm_paired_max_err": worst,
             f"{prefix}gemm_paired_max_row_rel_err": rel,
             f"{prefix}gemm_paired_max_abs_out": vmax},
            f"; moe_gemm vs plain version in each of {len(errs)} expert products: max err "
            f"{worst} (max |out| {vmax}), max row error {rel:.3e}")


def check_kernels_in_prefill(cfg, params, run: dict) -> dict:
    """One more full-depth bf16 prefill of the main path's prompts in which
    every kernel launch of the prefill is held against its plain version on
    the same activations: flash (``attention_ref``, f32 math) in each
    attention layer, rglru_scan (``rglru_scan_ref``, at SCAN_TOL) in each
    RG-LRU layer, and moe_gemm (``moe_gemm_ref``) in each of the three expert
    products of each MoE layer, on the dispatched activations.  Not counted
    as main-path launches."""
    import torch

    import repro_torch.models.moe as moe_mod
    import repro_torch.models.rglru as rglru_mod
    import repro_torch.models.transformer as transformer
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models import Model

    routed = transformer.attention, rglru_mod.scan_kernel, moe_mod.moe_gemm
    attn_errs, scan_errs, gemm_errs = [], [], []
    hold = _paired(attn_errs)

    def paired_attention(q, k, v, *, causal=True, window=None, **kw):
        out = routed[0](q, k, v, causal=causal, window=window, **kw)
        # One sequence at a time keeps the plain version's f32 scores small.
        ref = torch.cat([attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal,
                                       window=window) for i in range(q.shape[0])])
        hold("flash kernel against its plain version inside the prefill", out, ref, v)
        return out

    def paired_scan(a, b, h0):
        out = routed[1](a, b, h0)
        err, bad = max_err(out, rglru_scan_ref(a, b, h0), SCAN_TOL)
        check(bad == 0, f"rglru_scan inside the prefill: {bad} elements outside SCAN_TOL "
              f"(max err {err})")
        scan_errs.append(err)
        return out

    transformer.attention, rglru_mod.scan_kernel, moe_mod.moe_gemm = (
        paired_attention, paired_scan, _paired_gemm(gemm_errs, routed[2], "prefill"))
    try:
        logits, _, _ = Model(cfg).forward(params, tokens=run["tokens"])
    finally:
        transformer.attention, rglru_mod.scan_kernel, moe_mod.moe_gemm = routed
    del logits
    torch.cuda.synchronize()
    n = layer_counts(cfg)
    worst, rel, vmax = _paired_summary(attn_errs, n["attn"], "prefill")
    res = dict(prefill_layers_paired=len(attn_errs), prefill_paired_max_err=worst,
               prefill_paired_max_row_rel_err=rel, prefill_paired_max_abs_v=vmax)
    msg = (f"[lm] {cfg.name}: in a bf16 prefill {tuple(run['tokens'].shape)}, flash kernel vs "
           f"plain version in each of {len(attn_errs)} attention layers: max err {worst} (max "
           f"|v| {vmax}), max row error {rel:.3e}")
    check(len(scan_errs) == n["rglru"], f"paired rglru_scan {len(scan_errs)} times, not "
          f"{n['rglru']}")
    if scan_errs:
        res.update(scan_layers_paired=len(scan_errs), scan_paired_max_err=max(scan_errs))
        msg += (f"; rglru_scan vs plain version in each of {len(scan_errs)} RG-LRU layers: "
                f"max err {max(scan_errs)}")
    gemm_res, gemm_msg = _gemm_summary(gemm_errs, n["moe"], "")
    res.update(gemm_res)
    log(msg + gemm_msg)
    return res


def check_kernels_in_decode(cfg, params, run: dict) -> dict:
    """One more full-depth bf16 decode step in which every kernel launch of
    the step is held against its plain version on the same activations:
    decode attention (``decode_attention_ref``, f32 math, on the same q,
    cache or ring and kv_len) in each attention layer, and moe_gemm
    (``moe_gemm_ref``) in each of the three expert products of each MoE
    layer.  Not counted as main-path launches."""
    import torch

    import repro_torch.models.moe as moe_mod
    import repro_torch.models.transformer as transformer
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models import Model

    routed = transformer.decode_attention, moe_mod.moe_gemm
    errs, gemm_errs = [], []
    hold = _paired(errs)

    def paired(q, ck, cv, kv_len, *, window=None):
        check(window is None, "a decode step passed a window (the ring needs none)")
        out = routed[0](q, ck, cv, kv_len)
        ref = decode_attention_ref(q, ck, cv, kv_len)
        # Slots past kv_len hold zeros or live ring keys: cv's max bounds
        # the values the outputs average over either way.
        hold("decode kernel against its plain version inside the decode step", out, ref, cv)
        return out

    tok = run["last_tok"]
    pos = torch.full((tok.shape[0],), run["next_pos"], dtype=torch.int64, device=tok.device)
    transformer.decode_attention, moe_mod.moe_gemm = (
        paired, _paired_gemm(gemm_errs, routed[1], "decode step"))
    try:
        Model(cfg).decode_step(params, run["cache"], tok[:, None], pos)
    finally:
        transformer.decode_attention, moe_mod.moe_gemm = routed
    torch.cuda.synchronize()
    n = layer_counts(cfg)
    worst, rel, vmax = _paired_summary(errs, n["attn"], "decode")
    res = dict(layers_paired=len(errs), paired_max_err=worst, paired_max_row_rel_err=rel,
               paired_max_abs_v=vmax)
    gemm_res, gemm_msg = _gemm_summary(gemm_errs, n["moe"], "decode_")
    res.update(gemm_res)
    log(f"[lm] {cfg.name}: in a decode step at position {int(pos[0])}, decode kernel vs plain "
        f"version in each of {len(errs)} attention layers: max err {worst} (max |v| {vmax}), "
        f"max row error {rel:.3e}{gemm_msg}")
    return res


def check_prefill_decode(cfg, params, run: dict, *, context: int, cycles: int,
                         rows: int = 2) -> dict:
    """The first decoded token's logits against the last row of a full
    forward over the prompt plus that token (tests/test_models.py:83-110 at
    full width): prefill through the flash kernel, decode through the decode
    kernel, at tests/test_models.py:105-106's tolerance; argmax must agree on
    rows whose top-2 margin exceeds twice the measured max difference.

    The reference's initialization (std = 1/sqrt(shape[-2]), so the 3-D
    projections' fan-in is heads or head_dim) gives attention scores of std
    ~500 at GLM-4-9B's width: the softmax is all but one-hot, and the model
    is chaotic in depth -- two evaluation orders (prefill at S=2048 against
    a forward at S=2049, whose matmuls round differently) drift apart layer
    by layer until the logits disagree, in bf16 and in f32 alike (on the CPU,
    at 512 tokens, f32 against f64: max |diff| 0.009 after 2 layers, 0.92
    after 4, 2.9 after 12 at 64 tokens).  So the gated check runs in float32
    on the first ``cycles`` pattern cycles of the same weights (no remainder
    blocks), at full width, on the first ``rows`` prompts; the full-depth
    bf16 comparison is measured and printed, not gated.  In float32 the
    flash wrapper and moe_gemm run their CUDA-core paths, not the bf16
    tensor-core paths of the main prefill: those are held at full depth by
    check_kernels_in_prefill (against the plain versions on the prefill's
    own activations), and the decode kernel by check_kernels_in_decode
    (against the flash kernel on identical inputs).

    A MoE layer's capacity depends on the sequence: a decode step routes its
    one token with capacity 1, while the full forward puts it last in every
    expert bucket of the prompt, where it is dropped if the bucket is full.
    The comparison holds only for rows whose last token no checked layer
    dropped: those are counted, compared, and at least one must remain.
    """
    import dataclasses

    import torch

    from repro_torch.models import Model
    from repro_torch.models.common import tree_map

    tokens, nxt = run["tokens"][:rows], run["first_tok"][:rows, None]
    prompt = tokens.shape[1]
    pos = torch.full((rows,), prompt, dtype=torch.int64, device=tokens.device)

    def last_row(model, p):
        logits, _, _ = model.forward(p, tokens=torch.cat([tokens, nxt], dim=1))
        out = logits[:, -1].float().clone()
        del logits
        return out

    def compare(got, ref):
        max_diff, bad = max_err(got, ref, LM_TOL)
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * max_diff
        agree = got.argmax(-1) == ref.argmax(-1)
        return max_diff, bad, clear, agree

    # bf16 at full depth, for the record: the main path's first decode.
    b_diff, b_bad, _, b_agree = compare(run["first_logits"][:rows], last_row(Model(cfg), params))

    cfg32 = dataclasses.replace(cfg, dtype="float32", cycles=cycles, remainder=())
    # Cut to depth before the cast: Moonlight's 56 GB of bf16 would not fit twice.
    p32 = {k: v for k, v in params.items() if k not in ("blocks", "rem_blocks")}
    p32["blocks"] = tree_map(lambda a: a[:cycles], params["blocks"])
    p32["rem_blocks"] = []
    p32 = tree_map(lambda a: a.float(), p32)
    model = Model(cfg32)
    logits, cache, _ = model.forward(p32, tokens=tokens, build_cache=True, cache_capacity=context)
    del logits
    dec, _ = model.decode_step(p32, cache, nxt, pos)
    del cache
    got = dec[:, 0].float()
    dropped = [torch.zeros(rows, dtype=torch.int64, device=got.device)]
    with watch_last_token_drops(cfg32, dropped):
        ref = last_row(model, p32)
    del p32
    kept = sum(dropped) == 0  # rows whose last token no checked layer dropped
    check(bool(kept.any()), "the full forward dropped the last token from a full expert "
          "bucket in every row: no row's logits can match the decode's")
    got, ref = got[kept], ref[kept]
    max_diff, bad, clear, agree = compare(got, ref)
    check(bad == 0, f"f32 decode logits disagree with the full forward: {bad} of "
          f"{got.numel()} outside atol={LM_TOL['atol']} rtol={LM_TOL['rtol']} "
          f"(max diff {max_diff})")
    check(bool(agree[clear].all()), "argmax differs on a row with a clear top-2 margin")
    res = dict(consistency_max_diff_f32=max_diff, logit_absmax=float(ref.abs().max()),
               rows_compared=int(kept.sum()), argmax_rows_clear=int(clear.sum()),
               argmax_rows_agree=int(agree.sum()), bf16_full_depth_max_diff=b_diff,
               bf16_full_depth_outside_tol=b_bad,
               bf16_full_depth_argmax_rows_agree=int(b_agree.sum()))
    n = res["rows_compared"]
    skipped = (f" (in {rows - n} the full forward's capacity dropped the last token)"
               if n < rows else "")
    log(f"[lm] {cfg.name}: decode vs full forward, f32, {cfg32.num_layers} layers, {n} of "
        f"{rows} rows{skipped}: max diff "
        f"{max_diff:.6f} (|logit| max {res['logit_absmax']:.4f}); argmax agrees on "
        f"{res['argmax_rows_agree']}/{n} rows, {res['argmax_rows_clear']} with a clear "
        f"margin.  bf16, {cfg.num_layers} layers, {rows} rows (not gated): max diff "
        f"{b_diff:.4f}, {b_bad} of {rows * cfg.vocab_size} outside the tolerance, argmax "
        f"agrees on {res['bf16_full_depth_argmax_rows_agree']}/{rows}")
    return res


@contextlib.contextmanager
def watch_last_token_drops(cfg, dropped: list):
    """While active, every MoE layer appends to ``dropped`` how many of each
    row's last token's expert choices overflow their bucket, (B,): the last
    token sits last in each bucket, so it is dropped where the bucket's
    count exceeds the capacity."""
    import torch

    import repro_torch.models.transformer as transformer
    from repro_torch.models.moe import capacity

    routed = transformer.moe_forward

    def watched(cfg_, p, x, **kw):
        chosen = (x @ p["router"]).float().topk(cfg_.moe.top_k, dim=-1).indices  # (B,S,k)
        counts = torch.nn.functional.one_hot(chosen, cfg_.moe.num_experts).sum(dim=(1, 2))
        last = counts.gather(1, chosen[:, -1])  # bucket sizes of the last token's experts
        dropped.append((last > capacity(cfg_, x.shape[1])).sum(dim=1))
        return routed(cfg_, p, x, **kw)

    transformer.moe_forward = watched
    try:
        yield
    finally:
        transformer.moe_forward = routed


#: Port kernels by the names their CUDA functions carry in a profile.
KERNEL_SYMBOLS = {"decode_attention": ("decode_mma_kernel", "decode_simt_kernel"),
                  "moe_gemm": ("moe_gemm_",), "flash_attention": ("flash_",),
                  "rglru_scan": ("rglru_scan",)}


def profile_decode(cfg, params, run: dict, steps: int = 3) -> dict:
    """Device busy share of a few full-depth decode steps (torch.profiler):
    summed kernel time over wall time, the busy ms per step, each port
    kernel's device ms per step, and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import Model

    model = Model(cfg)
    tok = run["last_tok"][:, None]
    base = run["next_pos"] + 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            pos = torch.full((tok.shape[0],), base + i, dtype=torch.int64, device=tok.device)
            model.decode_step(params, run["cache"], tok, pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_kernels(prof)
    busy = sum(r[0] for r in rows) / 1e6
    per_kernel = {name: sum(us for us, k, _ in rows if any(sym in k for sym in syms))
                  / 1e3 / steps for name, syms in KERNEL_SYMBOLS.items()}
    res = dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall if rows else None,
               busy_ms_per_step=busy * 1e3 / steps, wall_ms_per_step=wall * 1e3 / steps,
               kernel_ms_per_step={k: v for k, v in per_kernel.items() if v > 0},
               top=[(k, round(us / 1e3, 3), n) for us, k, n in rows[:10]])
    if rows:
        log(f"[profile] {cfg.name}, {steps} decode steps: wall {wall * 1e3:.3f} ms, device busy "
            f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f} %), {res['busy_ms_per_step']:.3f} ms "
            f"busy per step; port kernels' device ms per step {res['kernel_ms_per_step']}; top "
            f"kernels (ms, launches): {res['top']}")
    else:
        log("[profile] torch.profiler recorded no device time: busy share not measured")
    return res


def run_serve(dev, cfg, params, settings: dict) -> dict:
    """The port's serve loop at full width, with every migration checked:
    the installed rows of every cache leaf equal the extracted ones and the
    destination's other slots keep their contents (per-slot float64
    checksums over every leaf, ``scan`` and ``rem``, whatever its rank)."""
    import torch

    from repro_torch.launch.serve import DecodeWorker, serve_loop

    checked = []
    leaf_kinds = set()

    def leaves(cache):
        """(name, leaf, slot axis) of every cache leaf: axis 1 of the stacked
        ``scan`` leaves, axis 0 of the remainder blocks' ``rem`` leaves, at
        any rank (k/v rings and caches, RG-LRU ``h`` and ``conv``)."""
        return ([(n, a, 1) for e in cache["scan"] for n, a in e.items()]
                + [(n, a, 0) for e in cache["rem"] for n, a in e.items()])

    def slot_sums(cache) -> torch.Tensor:
        # (leaves, slots) float64 checksums over every axis but the slot's,
        # one slot at a time: a whole leaf cast to float64 would add 6.4 GB
        # (Moonlight's) to the serve loop's peak memory.
        return torch.stack([
            torch.stack([a.select(axis, s).sum(dtype=torch.float64)
                         for s in range(a.shape[axis])])
            for _, a, axis in leaves(cache)])

    class CheckedWorker(DecodeWorker):
        def extract(self, slot):
            blob = super().extract(slot)
            blob["sums"] = slot_sums(self.cache)[:, slot].clone()
            return blob

        def install(self, slot, blob, sid):
            before = slot_sums(self.cache)
            super().install(slot, blob, sid)
            after = slot_sums(self.cache)
            others = [s for s in range(self.slots) if s != slot]
            check(torch.equal(after[:, slot], blob["sums"]),
                  "a migration installed other rows than it extracted")
            check(torch.equal(after[:, others], before[:, others]),
                  "a migration changed the destination's other slots")
            moved = leaves(blob["cache"])
            check(len(moved) == len(leaves(self.cache)), "a migration left cache leaves behind")
            for (name, a, axis), (_, rows, _) in zip(leaves(self.cache), moved):
                check(torch.equal(a.select(axis, slot), rows.select(axis, 0)),
                      "installed rows differ from the extracted ones")
                leaf_kinds.add(f"{name}{tuple(a.shape)}")
            checked.append((slot, sid))

    torch.cuda.reset_peak_memory_stats()
    lines = []
    t0 = time.perf_counter()
    stats = serve_loop(cfg, params, device=dev, worker_cls=CheckedWorker,
                       log=lambda m: (lines.append(m), log(m)), **settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    check(stats.completed > 0, "no sequence completed")
    check(stats.migrations == len(checked), "a migration bypassed the checks")
    check(stats.migrations > 0, "the serve loop applied no migration")
    check(peak < total, f"peak memory {peak} exceeds the card's {total}")
    res = dict(
        wall_s=wall,
        completed=stats.completed,
        migrations=stats.migrations,
        decode_tokens=stats.decode_tokens,
        decode_seconds=stats.decode_seconds,
        decode_tokens_per_s=stats.decode_tokens / stats.decode_seconds,
        p50_ticks=stats.percentile(50),
        p99_ticks=stats.percentile(99),
        max_workers=stats.max_workers,
        peak_mem_gb=peak / 1e9,
        migrated_leaves=sorted(leaf_kinds),
    )
    log(f"[serve] {cfg.name} L={cfg.num_layers} d={cfg.d_model}: {stats.ticks} ticks in {wall:.3f} s, "
        f"{stats.completed} completed, p50={res['p50_ticks']:.1f} p99={res['p99_ticks']:.1f} "
        f"ticks, {stats.migrations} migrations (rows checked), {stats.decode_tokens} decode "
        f"tokens in {stats.decode_seconds:.3f} s = {res['decode_tokens_per_s']:.1f} tokens/s, "
        f"workers {stats.max_workers}, peak memory {res['peak_mem_gb']:.2f} GB; leaves moved "
        f"and checked: {res['migrated_leaves']}")
    return res


#: The LM phases: GLM-4-9B (5-6), RecurrentGemma-2B (7), Moonlight (8).
LM_RUNS = (
    dict(arch=LM_ARCH, context=LM_CONTEXT, batch=LM_BATCH, prompt=LM_PROMPT,
         steps=LM_DECODE_STEPS, check_cycles=CHECK_CYCLES, serve_context=LM_CONTEXT,
         serve=SERVE),
    dict(arch=RG_ARCH, context=RG_CONTEXT, batch=RG_BATCH, prompt=RG_PROMPT,
         steps=RG_DECODE_STEPS, check_cycles=RG_CHECK_CYCLES, serve_context=RG_CONTEXT,
         serve=SERVE),
    # The MoE check compares only rows whose last token no expert bucket
    # dropped (check_prefill_decode), so it takes all 4 prompts: with 2, a
    # change of the first decoded token left none to compare.
    dict(arch=MOE_ARCH, context=MOE_CONTEXT, batch=MOE_BATCH, prompt=MOE_PROMPT,
         steps=MOE_DECODE_STEPS, check_cycles=CHECK_CYCLES, check_rows=MOE_BATCH,
         serve_context=MOE_SERVE_CONTEXT, serve=SERVE),
)


def run_lm(dev, drive, spec: dict) -> tuple[dict, dict]:
    """One model at full width on the card: random bf16 weights from a
    seeded generator, then prefill + greedy decode with exact launch counts
    (the path the JSON line's launches come from), the per-layer kernel
    pairings, a decode profile, the f32 prefill/decode consistency check,
    and the serve loop (launches counted too).  Frees the weights after."""
    import torch

    from repro_torch.models import init_params

    cfg = lm_config(spec["arch"], spec["context"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    log(f"[lm] {cfg.name}: L={cfg.num_layers} d={cfg.d_model} V={cfg.vocab_size}, parameters "
        f"initialized on the card in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    want = expected_launches(cfg, spec["steps"])
    run, counts = drive(tuple(k for k, n in want.items() if n), prefill_decode, dev, cfg,
                        params, batch=spec["batch"], prompt=spec["prompt"],
                        steps=spec["steps"], context=spec["context"])
    for name, n in want.items():
        check(counts[name] == n, f"{cfg.name}: prefill + {spec['steps']} decode steps launched "
              f"{name} {counts[name]} times, not {n}")
    log(f"[lm] {cfg.name}: launches of one prefill and {spec['steps']} decode steps {want}")
    lm = {k: v for k, v in run.items()
          if k != "next_pos" and not isinstance(v, (torch.Tensor, dict))}
    lm["launches"] = want
    lm.update(check_kernels_in_decode(cfg, params, run))
    lm["profile"] = profile_decode(cfg, params, run)
    del run["cache"]
    lm.update(check_kernels_in_prefill(cfg, params, run))
    lm.update(check_prefill_decode(cfg, params, run, context=spec["context"],
                                   cycles=spec["check_cycles"], rows=spec.get("check_rows", 2)))
    del run
    lm["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[lm] {cfg.name}: peak device memory {lm['peak_mem_gb']:.2f} GB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.2f} GB")
    decode = ("decode_attention",) + (("moe_gemm",) if cfg.moe is not None else ())
    served, serve_counts = drive(decode, run_serve, dev,
                                 lm_config(spec["arch"], spec["serve_context"]), params,
                                 spec["serve"])
    check(serve_counts["flash_attention"] == 0 and serve_counts["rglru_scan"] == 0,
          "the serve loop launched a prefill kernel")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return lm, served


def host_us(reps: int = 200, rounds: int = 5) -> dict:
    """Host microseconds per call of the decode path's kernel wrappers, as
    imported (``--host-us SRC`` imports them from SRC, so that two
    checkouts can be compared in one call): the wall time of ``reps``
    back-to-back calls with no synchronization between them, over ``reps``,
    the median of ``rounds``.  decode_attention at the three decode shapes
    with kv_len int32 on the card and int64 (what the model passes);
    moe_gemm at Moonlight's decode products."""
    import torch

    from repro_torch.kernels import decode_attention, moe_gemm

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            runs.append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
        return float(np.median(runs))

    out = {}
    for what, b, t, kv, g, hd, live in DECODE_SHAPES:
        q = torch.randn(b, 1, kv * g, hd, generator=gen, device=dev).to(bf16)
        kc = torch.randn(b, t, kv, hd, generator=gen, device=dev).to(bf16)
        for dtype in (torch.int32, torch.int64):
            lens = torch.full((b,), live, dtype=dtype, device=dev)
            out[f"decode_attention {what}, kv_len {str(dtype)[6:]}"] = per_call(
                lambda: decode_attention(q, kc, kc, lens))
    for rows, d, f in ((MOE_BATCH, 2048, 1408), (MOE_BATCH, 1408, 2048)):
        x = torch.randn(64, rows, d, generator=gen, device=dev).to(bf16)
        w = torch.randn(64, d, f, generator=gen, device=dev).to(bf16)
        out[f"moe_gemm ({64},{rows},{d})x({64},{d},{f})"] = per_call(lambda: moe_gemm(x, w))
    return out


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
    # ``--host-us [SRC]`` / ``--kernel-ms [SRC]``: only the decode wrappers'
    # host time per call / the partition and scan kernels' times, from the
    # port under SRC (default: this checkout's), as one JSON line.
    mode = sys.argv[1] if sys.argv[1:2] in (["--host-us"], ["--kernel-ms"]) else None
    src = Path(sys.argv[2]).resolve() if mode and len(sys.argv) > 2 else SRC
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {src}/repro_torch not found", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--workers"]:
        # Phase 3w alone, in this interpreter: no CUDA call before its pools
        # are closed, so not the availability check below either.
        return workers_main()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if mode == "--host-us":
        card = gpu_name_and_limit()
        print(json.dumps({"src": str(src), "card": card, "host_us_per_call": host_us()}))
        return 0
    if mode == "--kernel-ms":
        card = gpu_name_and_limit()
        try:
            times = kernel_ms()
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"src": str(src), "card": card, "kernel_ms": times}))
        return 0
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    dev = torch.device("cuda", 0)
    # Full-precision f32 products wherever f32 appears (the plain versions).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_limit()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    launches = dict.fromkeys(_build.SOURCES, 0)

    def drive(kernel_names, fn, *args, **kwargs):
        """Run one path with the counts at 0; add its launches of the named
        kernels (each must have launched) to the JSON line's counts."""
        reset_launch_counts()
        result = fn(*args, **kwargs)
        counts = launch_counts()
        for name in kernel_names:
            check(counts[name] > 0, f"kernel {name} was not launched on its path")
            launches[name] += counts[name]
        return result, counts

    try:
        t0 = time.perf_counter()
        built = _build.build()
        log(f"[build] {built} in {time.perf_counter() - t0:.2f} s wall")

        kernels = routing_kernel_checks(dev)
        kernels.update(attention_kernel_checks(dev))
        dec_gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        kernels["decode_attention"]["cases"] += [decode_timed_case(dev, *shape, dec_gen)
                                                 for shape in DECODE_SHAPES[1:]]
        flash_cases = kernels["flash_attention"]["cases"]
        flash_cases.append(flash_timed_case(
            dev, "Moonlight prefill", MOE_BATCH, MOE_PROMPT, 16, 16, 128, None, SEED + 2))
        flash_cases.append(flash_timed_case(
            dev, "RecurrentGemma prefill, hd 256", RG_BATCH, RG_PROMPT, 10, 1, 256, 2048,
            SEED + 1, fault=True))
        kernels.update(scan_and_expert_kernel_checks(dev))
        gc.collect()
        torch.cuda.empty_cache()

        routing = ("keygroup_partition", "radix_sort")

        def engine_paths():
            from repro_torch.engine import ExecutionConfig

            size = dict(batch=BATCH, kgs=KGS, nodes=NODES, ticks=TICKS, check_ticks=CHECK_TICKS)
            typed = run_engine(dev, **size)
            jit = run_engine(dev, **size, config=ExecutionConfig.jit(), typed=typed)
            for key in ("counts", "arrivals", "states"):
                del typed[key]
            log(f"[engine] Real Job 3, {TICKS} x {BATCH} tuples: .typed() "
                f"{typed['tuples_per_s']:.0f} tuples/s, .jit() {jit['tuples_per_s']:.0f} "
                f"tuples/s; device busy over 3 steady ticks {typed['profile']['busy_share']} "
                f"/ {jit['profile']['busy_share']}")
            ctl = dict(kgs=CTL_KGS, nodes=CTL_NODES, rate=CTL_RATE, ticks=CTL_TICKS,
                       periods=CTL_PERIODS)
            controller = run_controller(dev, **ctl)
            controller["jit"] = run_controller(dev, **ctl, config=ExecutionConfig.jit())
            return {"typed": typed, "jit": jit}, controller

        (engine, controller), _ = drive(routing, engine_paths)
        gc.collect()
        torch.cuda.empty_cache()
        superstep, counts = drive(routing, run_superstep, dev, card)
        superstep["launches"] = {name: counts[name] for name in routing}
        log(f"[engine/superstep] phase 3s routing launches (wrapper counts: eager launches "
            f"and kernels recorded into graphs) {superstep['launches']}; replays of the "
            f"device-routed scan {superstep['device']['replays']} x "
            f"{superstep['device']['graph_launches']}")
        gc.collect()
        torch.cuda.empty_cache()
        # Phase 3w in a fresh interpreter (this one holds a CUDA context,
        # and the multi-worker coordinator forks): launches are the
        # workers', folded by their coordinators.
        workers = run_workers()
        for name in routing:
            check(workers["launches"][name] > 0, f"kernel {name} was not launched by a worker")
            launches[name] += workers["launches"][name]

        lm, served = {}, {}
        for spec in LM_RUNS:
            lm[spec["arch"]], served[spec["arch"]] = run_lm(dev, drive, spec)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[summary] engine {engine}; controller {controller}; superstep {superstep}; "
        f"workers {workers}; "
        f"lm {lm}; serve {served}; "
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
