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
   (head_dim 256) prefills' shapes and at Whisper-small's three (head_dim
   64: the encoder unmasked at S = T = 1,500, the decoder's causal self
   attention at S = 384, cross attention at S = 384 over T = 1,500), with a
   planted fault (a dropped KV tile) at head_dim 128, at 256 and at each of
   Whisper's shapes;
   decode attention at the three models' decode shapes and at Whisper's
   (G = 1, head_dim 64: self at kv_len 416 of 448, cross at kv_len 1,500)
   beside SDPA given the same length mask, and moe_gemm's decode and serve products (dense x, and
   x from a real top-6 dispatch, whose dead experts the kernel skips, held
   exactly equal to the same body without the skip) beside ``torch.bmm``.
   These decode-shape times, and the partition's and the scan's, are each
   given twice, in three rounds: device ms per call (``device_ms``,
   torch.profiler, every device op of a call) and host ms per call
   (``cuda_ms``, CUDA events around back-to-back calls), since a call of a
   few microseconds on the card can take longer than that on the host;
3. the engine path at full size: Real Job 3 (airline → extract → sumdelay →
   routedelay) with 1000 key groups per operator on 16 nodes, one 2^20-tuple
   airline batch per tick for 5 ticks, every routed hop through both
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
3r. Real Jobs 1 and 4 at phase 3's deployment (1000 key groups per
   operator, 16 nodes; 2^20 wiki or airline tuples a tick, weather at a
   quarter of that) under ``.typed()`` for 5 ticks (job 4: 4) and the
   drain: job 1
   (wiki → geohash → windowed TopK, top 10, windows of 1 tick → global
   TopK) held bit-identical to the port's ``device="cpu"`` engine on every
   tick, job 4 (job 3 + weather → rainscore → join → efficiency → store) on
   the first 4 (sink outputs in order, state bytes, counts, arrivals), one
   key group of job 4's join moved (redirect → serialize → install) with
   blob bytes equal to the CPU engine's, tuple counts conserved, each hop's
   kernel batches held to the hop's key type (integer keys through both
   routing kernels; the geohash strings, the one global key group and the
   join's object records hashed on the host, as in the reference); job 4
   again under ``.jit()`` against the card's ``.typed()`` run (integers,
   keys and insertion order exactly, floats at rtol 1e-9); tuples/s and the
   busy share of 3 more ticks;
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
   closed): (a) ``.workers(4)`` driven in lockstep over 4 batches and the
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
4s. the skew path: ``benchmarks/skew_grid.py``'s job (events → agg →
   total, both stateful stages split-mergeable), ported.  (a) The
   ``flash_crowd`` scenario (Zipf 0.8, the top 2 keys boosted 16x from tick
   16) at 2^20 tuples a tick over 2^20 keys, 1000 key groups per operator,
   16 nodes, ``ExecutionConfig.split(4)``, 24 ticks: after the surge the 4
   hottest key groups of agg and total split, a replica moves to another
   node, and after the drain every family folds back; every tick's counts,
   arrivals and routing table, every key group's state bytes before and at
   the surge, around the split and the move and after the drain, the blob,
   the merged states and the sink totals held bit-identical to the CPU
   engine on the same batches, the totals equal to the events fed; ``hot_key_summary`` and
   ``max_kg_share`` before and after the split.  (b) ``skew_grid.episode``
   at its full sizes on ``flash_crowd`` for ALBIC with ``HotKeySplitter``
   under ``.split(4)``, COLA, Flux and PoTC: each period's snapshot held
   against the CPU engine's, each plan solved once on the card engine's
   snapshot and applied to both, whose tables, families and states must
   agree; each balancer's ``imbalance`` and ``migcost`` as the grid's row;
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
9. the training path (``--train`` runs it alone): (a) each LM kernel's
   ``torch.autograd.Function`` alone at a train-path shape in f32 (flash at
   Llama-3.2-3B's q (16,256,24,128), the scan at RecurrentGemma-2B's
   (16,256,2560) with h0 requiring grad, moe_gemm at the trainer's MoE up
   product with two experts given no rows, whose dw must be exactly 0)
   against autograd of its plain version, every input's gradient within
   1e-3 of relative norm, planted faults (the scan's backward without dh0,
   a live expert's dw zeroed) rejected; then per parameter leaf the
   gradient of ``Model.loss`` on one TokenPipeline batch (16 x 256) through
   the Functions against the same through the plain versions, f32, no
   remat, on two full-width cycles of Llama-3.2-3B and RecurrentGemma-2B
   and on the trainer's ``reduced_config("moonshot_v1_16b_a3b", 512, 4,
   32768)`` (there moe_gemm's Function alone, the expert choices replayed:
   see ``model_grad_checks``), within 1e-3, with planted faults (today's
   flash wrapper without its Function: no gradient to wq/wk/wv; a live
   expert's dw zeroed) rejected; these launches are not counted.  Counted:
   (b) Llama-3.2-3B at full width and depth (28 layers, 3.21 B params,
   bf16, AdamW with ``cosine_schedule(3e-4, 20, 4)``, remat ``"full"``),
   4 ``make_train_step`` steps on TokenPipeline batches of 16 x 256, then 2
   more under torch.profiler: loss and grad norm finite, every leaf
   changed, ms per step after the first, tokens/s, busy share, peak memory,
   launches per step forward and backward apart; (c)
   ``repro_torch.launch.train.main`` with examples/train_lm.py's arguments
   cut to 30 steps, 3 periods, worker 1 failing at step 15: at most 4 shards
   moved a period, the dead worker drained, then ``--restore`` resumes from
   the last checkpoint's step, cursor and assignment for one more period;
   (d) 2 steps of RecurrentGemma-2B at full width and depth and of the
   trainer's MoE config (rglru_scan and moe_gemm forward and backward);
   (a) also holds Whisper-small at full width and depth in f32 (8 clips of
   1,500 frames, 8 x 448 tokens; encoder, self and cross attention through
   flash's Function, the planted fault its wrapper without the Function),
   and (e) runs 2 steps each of xLSTM-1.3B (8 x 512 tokens: two mLSTM
   chunks) and Whisper-small (16 clips x 1,500 frames, 16 x 448 tokens),
   remat ``"full"``, every leaf changed or listed with its reason;
10. xLSTM-1.3B at full width and depth (48 layers: 6 x (7 mLSTM + 1
   sLSTM), d_model 2,048, 4 heads of 512, vocab 50,304) through
   ``run_lm``: 8 prompts of 2,048 tokens (8 mLSTM chunks) prefilled with
   ``build_cache``, the sLSTM layers' share of the prefill timed apart, 16
   greedy decode steps; no kernel is on its path, and none may launch;
   ``check_chunk_boundary``: in f32 on the first cycle (8 layers) and 2
   prompts, a 256-token prefill and teacher-forced decode through position
   511 against the port's own 512-token forward, with the carry read as
   Cᵀq (the reference's contraction) as a planted fault; the serve loop's
   migrations move every C, n, m, c, h row;
11. Whisper-small at full width and depth (12 encoder and 12 decoder
   layers, d_model 768, 12 heads of 64, vocab 51,865) through ``run_lm``:
   16 clips of 1,500 seeded frame embeddings and 384-token prompts through
   ``Model.forward(build_cache=True, cache_capacity=448)`` (36 flash
   launches: 12 encoder, 12 decoder self, 12 cross), 32 greedy decode
   steps (24 decode launches each: 12 self, 12 cross), every launch of one
   more prefill and decode step paired with its plain version, the first
   decoded token held against a full forward in f32 on 2 decoder and 2
   encoder layers; the serve loop decodes against an empty encoder (the
   reference's ``DecodeWorker``), so its cross sublayers launch nothing;
12. the mesh and dry-run tooling (``--dryrun`` runs it alone) on the card's
   1×1 mesh: (a) ``repro_torch.launch.dryrun`` over every arch × shape at
   the configs' full sizes, each step traced on meta tensors under the
   roofline's op counter (FLOPs and bytes > 0 in each of the 32 ``ok``
   rows, the 8 ``skip`` rows with the reference's reasons), the table
   printed with the H100 peaks of ``repro_torch.launch.roofline``; (b)
   with ``run``, the four decode cells that fit (RecurrentGemma-2B and
   xLSTM-1.3B at ``decode_32k`` and ``long_500k``) run at full width and
   depth, seeded weights, zero caches, every row at position seq_len - 1:
   the bytes allocated for their arguments equal to the count from the
   shapes, the measured step (CUDA events, median of 5) no faster than
   its roofline bound, RecurrentGemma's through decode_attention; (c)
   inside phase 8, on its weights: Moonlight-16B-A3B's prefill and one
   decode step under ``activation_rules(rules_for(...), mesh=...)`` take
   the expert-parallel path (every MoE layer, through moe_gemm) and are
   held by the row check to the same steps without the context (both
   under deterministic algorithms, so bit equality is reported too);

then one JSON line listing the kernels with their launches on the paths
that run them (phases 3, 3j, 3r, 3s, 3w, 4 and 4s for routing,
5-12 for the LM kernels; phase 9's also apart, with its backward launches), times,
bounds and yardsticks; the card's name and power limit (``nvidia-smi``);
and, last, the line ``{"ok": true, "device": {...}}``.  It exits nonzero
without CUDA, and outside a checkout that holds ``src/repro_torch``.

``python3 chip_smoke.py --host-us [SRC]`` runs none of that: it prints the
host microseconds per call of the decode path's kernel wrappers
(``host_us``), imported from SRC (default ``src``), so that two checkouts
can be compared in one call.  ``--kernel-ms [SRC]`` likewise prints only
keygroup_partition's and rglru_scan's phase-2 timings and yardsticks
(``kernel_ms``).  ``--workers`` runs phase 3w alone (the full run starts it
so, as a child, and relays its lines).  ``--dryrun`` runs phase 12 alone,
(c) on Moonlight's weights loaded for it after (b).
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
# 5 ticks (20 until phases 3r and 4s joined the script, 10 until phase 9
# did, 6 until phases 10 and 11 did: each phase runs whole 2^20-tuple
# batches, and the script keeps to its time limit).
TICKS = 5
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
# Phase 10: xLSTM-1.3B at full width and depth (48 layers: 6 x (7 mLSTM + 1
# sLSTM), d_model 2,048, 4 heads of 512); 8 prompts of 2,048 tokens (8
# mLSTM chunks).  Its chunk-boundary check: the first cycle (8 layers) on
# 2 prompts, a 256-token prefill, then teacher-forced decode through
# position 511, every position held against the port's own 512-token
# (two-chunk) forward, gated in float64 at XL_TOL, and measured (not gated)
# in float32.  At this width and the reference's init the f32 logits are
# ill-conditioned: the f32 forward's distance from the f64 one, which the
# check prints beside its own, is of the order of the logits themselves
# (PERF.md §4).  In float64 (the recurrences and norms; the logits are
# rounded to f32 at the end) both orders agree to the logits' rounding,
# which XL_TOL leaves room for; the planted fault (the carry read as Cᵀq,
# the reference's contraction) moves them by ~1.
XL_ARCH, XL_CONTEXT = "xlstm_1_3b", 2064
XL_BATCH, XL_PROMPT, XL_DECODE_STEPS = 8, 2048, 16
XL_PREFIX, XL_TOTAL, XL_ROWS = 256, 512, 2
XL_TOL = dict(atol=1e-4, rtol=1e-5)
# Phase 11: Whisper-small at full width and depth (12 encoder and 12
# decoder layers, d_model 768, 12 heads of 64): 16 clips of 1,500 frame
# embeddings (30 s of audio at the encoder's 50 frames a second) and
# decoder prompts of 384 tokens in a 448-slot cache, 32 decode steps.
WH_ARCH, WH_CONTEXT, WH_FRAMES = "whisper_small", 448, 1500
WH_BATCH, WH_PROMPT, WH_DECODE_STEPS = 16, 384, 32

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


def peak(rate: str) -> float:
    """The H100 SXM's data-sheet peak of ``rate``, from
    ``repro_torch.launch.roofline`` (the one place they are defined): HBM
    bytes/s, the 32-bit non-tensor-core rate (``"int32"``, ``"f32"``),
    which bounds the routing kernels' integer lanes and the scan, and the
    dense bf16 tensor-core rate (``"bf16"``), which bounds attention's and
    the experts' matrix products."""
    from repro_torch.launch import roofline

    return {"hbm": roofline.HBM_BW, "int32": roofline.PEAK_INT32_OPS,
            "f32": roofline.PEAK_F32_FLOPS, "bf16": roofline.PEAK_FLOPS}[rate]


def bound_ms(nbytes: int, ops: int, rate: str = "int32") -> tuple[float, str]:
    t_bytes = nbytes / peak("hbm")
    t_ops = ops / peak(rate)
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
        "airline": [torch.from_numpy(k).to(dev)
                    for k, _, _ in source_batches("airline", count, BATCH, SEED)],
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
            b_ms, b_by = bound_ms(nbytes, flops, "bf16")
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
    ("Whisper self", WH_BATCH, WH_CONTEXT, 12, 1, 64, WH_PROMPT + WH_DECODE_STEPS),
    ("Whisper cross", WH_BATCH, WH_FRAMES, 12, 1, 64, WH_FRAMES),
)
#: Whisper-small's prefill attention (phase 11), timed in phase 2: (what, S,
#: T, causal).  The encoder over 1,500 frames without a mask (a ragged edge
#: of neither 64 nor 128 rows), the decoder's causal self attention over
#: its 384-token prompts, and its cross attention over the encoder.
WHISPER_FLASH = (("Whisper encoder", WH_FRAMES, WH_FRAMES, False),
                 ("Whisper decoder self", WH_PROMPT, WH_PROMPT, True),
                 ("Whisper cross", WH_PROMPT, WH_FRAMES, False))


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
    edges = [1, t, 63, split_end, split_end + 1, 1000, t - 1, 65]
    lens = torch.tensor([min(n, t) for n in (edges + [t] * b)[:b]], dtype=torch.int32,
                        device=dev)
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
    # With as many (row, KV head) pairs as SMs or more (Whisper's 16 x 12),
    # each pair is one split and nothing merges: only the first fault applies.
    fault2, fault2_bad = float("inf"), 0
    if nsplit > 1:
        dropped = torch.empty_like(q)
        dec_ops.launch(q, kc, vc, steady, dropped, path=path, nsplit=nsplit,
                       drop_last_split=True)
        fault2, fault2_bad = planted_fault(f"decode ({what}) without the last split to arrive",
                                           dropped, steady_ref)
        del dropped
    check(nsplit > 1 or b * kv >= torch.cuda.get_device_properties(dev).multi_processor_count,
          f"decode ({what}) ran one split: the dropped-split fault plants nothing")
    note = ""
    if pair_with_flash:
        # The two kernels against each other on the same inputs: flash over
        # the first kv_len keys without a causal mask computes what decode does.
        pair = flash_attention(q, kc[:, :live_len].contiguous(), vc[:, :live_len].contiguous(),
                               causal=False)
        err3, rel3 = row_check(f"flash_attention (causal=False) against decode_attention "
                                f"({what}) on the same inputs", pair, got)
        note = f"; flash vs decode on the same inputs: max err {err3}, row error {rel3:.3e}"
    del got
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
    b_ms, b_by = bound_ms(nbytes, 4 * h * hd * live, "bf16")
    kern_t = times["kernel"]
    log(f"[kernel] decode_attention {what}: B={b} T={t} H={h} KV={kv} G={g} hd={hd} "
        f"kv_len={live_len}, {path} body, {nsplit} splits: kernel {fmt_rounds(kern_t)}; sdpa "
        f"{fmt_rounds(times['sdpa'])}; plain {fmt_rounds(times['plain'])}; bound {b_ms:.4f} ms "
        f"by {b_by} ({b_ms / kern_t['device_ms']:.1%} of it on the device); caches rotated over "
        f"{ROTATE} copies, {ROUNDS} rounds; max_abs_err={max(err, err2)} "
        f"max_row_rel_err={max(rel, rel2):.3e} (kv_len {lens.tolist()}); planted faults: last "
        f"16 keys dropped, row error {fault:.3e} ({fault_bad} elements outside ATTN_TOL); "
        + (f"last split dropped from the merge, row error {fault2:.3e} ({fault2_bad} outside)"
           if nsplit > 1 else "one split a (row, KV head): no merge to drop from")
        + note)
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
                     fault: bool = False, t: int | None = None, causal: bool = True) -> dict:
    """The flash kernel at a prefill's shape (bf16; causal with S = T
    unless ``t`` keys or ``causal=False`` are given) against its plain
    version, timed beside it and beside SDPA; with ``fault``, a planted
    fault must fail the row check: the first KV tile (64 keys) dropped, for
    the last rows of a causal case (a window of S - 64 held against full
    causal), for every row of an unmasked one.  With S <= window the window
    masks nothing, so SDPA with ``is_causal`` is the same function."""
    import torch

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    t = s if t is None else t
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, t, kv, hd, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=causal, window=window)
    err, rel = row_check(f"flash_attention ({what}) against its plain version", got, ref)
    mask = f"causal window={window}" if causal else "no mask"
    case = dict(shape=f"q ({b},{s},{h},{hd}) k/v ({b},{t},{kv},{hd}) bf16 {mask}",
                max_abs_err=err, max_row_rel_err=rel)
    note = ""
    if fault:
        if causal:
            # A window of s - 64 drops up to 64 keys (the first KV tile)
            # from the last rows.
            full = ref if window is None or window >= s else attention_ref(q, k, v, causal=True)
            faulty = flash_attention(q, k, v, causal=True, window=s - 64)
        else:
            full = ref
            faulty = flash_attention(q, k[:, 64:].contiguous(), v[:, 64:].contiguous(),
                                     causal=False)
        rel_f, bad_f = planted_fault(f"flash ({what}) without its first KV tile", faulty, full)
        case["planted_fault_row_rel_err"] = rel_f
        note = (f"; planted fault (first KV tile dropped{' for the last rows' if causal else ''})"
                f": row error {rel_f:.3e}, {bad_f} elements outside ATTN_TOL")
    del got, ref
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = cuda_ms(lambda i: flash_attention(q, k, v, causal=causal, window=window), reps)
    plain = cuda_ms(lambda i: attention_ref(q, k, v, causal=causal, window=window), 2)
    lib = cuda_ms(lambda i: sdpa(qt, kt, vt, is_causal=causal), reps)
    pairs = s * (s + 1) // 2 if causal else s * t  # (query, key) pairs a head attends
    flops = 4 * b * h * hd * pairs
    b_ms, b_by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()), flops, "bf16")
    log(f"[kernel] flash_attention {what}: B={b} S={s} T={t} H={h} KV={kv} hd={hd} {mask}: "
        f"{ms:.4f} ms (plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the bound), max_abs_err={err} "
        f"max_row_rel_err={rel:.3e}{note}")
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
    b_ms, b_by = bound_ms(4 * (3 * a.numel() + h0.numel()), 2 * a.numel(), "f32")
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
                              "bf16")
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
        tok_slot, _, used, _, chosen = _row_dispatch(cfg, tokens, router, 1, 0,
                                                     cfg.moe.num_experts)
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
                                  "bf16")
            live_ms, _ = bound_ms(io + 2 * n_live * w[0].numel(),
                                  2 * n_live * b * x.shape[2] * w.shape[2], "bf16")
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
def source_batches(kind: str, count: int, size: int, seed: int):
    """``count`` batches of exactly ``size`` tuples each from one of the
    port's dataset streams (``airline``, ``wiki`` or ``weather``)."""
    from repro_torch.data import synthetic

    make = {"airline": synthetic.airline_stream, "wiki": synthetic.wiki_edit_stream,
            "weather": synthetic.weather_stream}[kind]
    spec = synthetic.StreamSpec(rate=size + 8 * size**0.5 + 64, fluctuation=0.0, seed=seed)
    stream = make(spec)
    out = []
    for _ in range(count):
        k, v, ts = next(stream)
        check(len(k) >= size, f"{kind} stream produced a short batch")
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


def profile_ticks(eng, feeds) -> dict:
    """The device's busy share of steady ticks (push + tick each): the
    ticks run once plain, timed on the host clock, and once more under
    torch.profiler, whose device events (every kernel, copy and memset)
    give the busy time; busy over the plain wall time is the share (the
    profiled wall time, inflated by the profiler, is given apart).  Each
    feed is a tick's ``(keys, values, ts)`` batches by source operator."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def ticks():
        for feed in feeds:
            for op, (k, v, ts) in feed.items():
                eng.push_source(op, k, v, ts)
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
    return dict(ticks=len(feeds), wall_s=wall, busy_s=busy,
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
    batches = source_batches("airline", ticks, batch, SEED)

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
    prof = profile_ticks(gpu, [{"airline": b} for b in batches[:3]])
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


# --------------------------------------------------------------------- phase 3r
# Real Jobs 1 and 4 at phase 3's deployment: 1000 key groups per operator,
# 16 nodes, 2^20-tuple wiki and airline batches a tick, weather at a
# quarter of that (benchmarks/real_jobs.py:296-300).
# Ticks fed to each job (8 asked; 6 until phase 9 joined the script, job 4's
# 5 until phases 10 and 11 did).
RJ_TICKS = {"job1": 5, "job4": 4}
# Job 1's TopK window, in ticks of stream time (every tuple of tick t has ts
# t): topk closes windows at ts 1 to 5, global_topk (whose window opens at
# ts 1) at 2 to 5, so four windows reach the sink within the 6 ticks.
RJ_WINDOW = 1.0
RJ_TOPK = 10
RJ_DRAIN = {"job1": 4, "job4": 6}  # each job's depth in hops
# Ticks held against the CPU engine: all of job 1's (its windows close
# late), the first 4 of job 4's (its join first holds state at tick 2).
RJ_CHECK = {"job1": RJ_TICKS["job1"] + RJ_DRAIN["job1"], "job4": 4}
RJ_MIG_TICK = 3  # job 4's join key group: redirect before this tick, install after it
# Hops whose partition key is not an integer, hashed on the host in both
# packages (Python's per-interpreter salted ``hash`` of each string or
# record): job 1's geohash strings and its one "global" key group, job 4's
# join over object records.  Every other hop takes keygroup_partition.
# The CPU and CUDA tests of the port read this table too.
HOST_HASHED = {"job1": ("topk", "global_topk"), "job4": ("join",)}


def real_job_feeds(job: str, ticks: int, batch: int) -> list[dict]:
    """Each tick's source batches, by source operator."""
    if job == "job1":
        return [{"wiki": b} for b in source_batches("wiki", ticks, batch, SEED)]
    air = source_batches("airline", ticks, batch, SEED)
    wx = source_batches("weather", ticks, batch // 4, SEED)
    return [{"airline": a, "weather": w} for a, w in zip(air, wx)]


def real_job_topology(job: str, kgs: int):
    from repro_torch.data.jobs import make_real_job_1, real_job_4

    if job == "job1":
        return make_real_job_1(keygroups_per_op=kgs, topk=RJ_TOPK, window_ticks=RJ_WINDOW)
    return real_job_4(keygroups_per_op=kgs)


def hop_kernels(eng) -> dict:
    """Per destination operator: (routed batches, keygroup_partition
    batches, radix_sort batches)."""
    m = eng.metrics
    return {spec.name: (m.routed_batches.get(op, 0), m.partition_kernel_batches.get(op, 0),
                        m.sort_kernel_batches.get(op, 0))
            for op, spec in enumerate(eng.topology.operators)}


def sinks_close(a: list, b: list) -> bool:
    """Sink outputs in the same order, each equal or (its floats) within
    JIT_RTOL; the exact comparison first, as most are equal."""
    return len(a) == len(b) and all(x == y or _close(x, y) for x, y in zip(a, b))


def run_real_job(dev, job: str, *, batch: int, kgs: int, nodes: int, config=None,
                 typed=None) -> dict:
    """One real job on the card for ``RJ_TICKS[job]`` ticks plus its drain.
    Under ``.typed()`` the first ``RJ_CHECK[job]`` ticks are held
    bit-identical to the port's CPU engine on the same batches (sink
    outputs in order, every key group's state bytes, tuple counts, arrival
    histograms), and job 4's join moves one key group (redirect, serialize,
    install) with blob bytes equal to the CPU engine's.  With ``typed`` (a
    ``.typed()`` run's result) the same ticks' sink outputs, every tick's
    counts, the arrivals and the states are held against it (floats at
    JIT_RTOL).  Both runs collect sink outputs over the same ticks."""
    import torch

    from repro_torch.engine import Engine, ExecutionConfig

    config = config or ExecutionConfig.typed()
    jit = config.use_fn_jit
    tag = f"realjobs/{job}" + ("/jit" if jit else "")
    ticks, drain, check_ticks = RJ_TICKS[job], RJ_DRAIN[job], RJ_CHECK[job]
    feeds = real_job_feeds(job, ticks, batch)

    def make(device):
        eng = Engine(real_job_topology(job, kgs), nodes, config=config, service_rate=1e12,
                     seed=SEED, collect_sinks=True, device=device)
        eng.backpressure.full_credit = 2 * batch
        return eng

    gpu = make(dev)
    cpu = make("cpu") if typed is None else None
    mig = job == "job4"  # (key group, destination) once the join holds state
    admitted = dict.fromkeys(feeds[0], 0)
    counts, sinks, blob = [], [], None
    t_gpu = 0.0
    for t in range(ticks + drain):
        feed = feeds[t] if t < ticks else {}
        engines = [gpu] + ([cpu] if cpu is not None else [])
        if mig and t == RJ_MIG_TICK:
            # The join key group with the largest state (its airports'
            # latest rainscores, from tick 2): its blob also ships the
            # flights queued for it.
            base = gpu.topology.kg_base(gpu.topology._resolve("join"))
            kg = max(range(base, base + kgs), key=lambda g: len(gpu.store.get(g).get("rain", ())))
            mig = (kg, (gpu.router.node_of(kg) + 1) % nodes)
            for eng in engines:
                eng.redirect(*mig)
        t0 = time.perf_counter()
        for op, (k, v, ts) in feed.items():
            n = gpu.push_source(op, k, v, ts)
            check(n == len(k), f"{tag} tick {t}: admitted {n} of {len(k)} {op} tuples")
            admitted[op] += n
        gpu.tick()
        torch.cuda.synchronize()
        t_gpu += time.perf_counter() - t0
        m = gpu.metrics
        counts.append((m.sink_tuples, m.processed_tuples, m.emitted_tuples))
        if typed is not None:
            check(counts[t] == typed["counts"][t],
                  f"{tag} tick {t}: counts {counts[t]} differ from .typed()'s "
                  f"{typed['counts'][t]}")
        if cpu is not None:
            for op, (k, v, ts) in feed.items():
                cpu.push_source(op, k, v, ts)
            cpu.tick()
        if mig and t == RJ_MIG_TICK:
            blobs = [eng.serialize(mig[0]) for eng in engines]
            check(len(blobs) == 1 or blobs[0] == blobs[1],
                  f"{tag}: join key group {mig[0]}'s blob differs from the CPU engine's")
            blob = len(blobs[0])
            for eng, b in zip(engines, blobs):
                eng.install(mig[0], mig[1], b)
            log(f"[{tag}] moved join key group {mig[0]} to node {mig[1]}: {blob}-byte "
                "blob" + (" == the CPU engine's" if len(blobs) == 2 else ""))
        if cpu is not None:
            mc = cpu.metrics
            check((mc.sink_tuples, mc.processed_tuples, mc.emitted_tuples) == counts[t],
                  f"{tag} tick {t}: counts differ from the CPU engine")
            check(m.sink_outputs == mc.sink_outputs,
                  f"{tag} tick {t}: sink outputs differ from the CPU engine's")
            check(state_bytes(gpu) == state_bytes(cpu),
                  f"{tag} tick {t}: key-group state differs from the CPU engine")
            check(np.array_equal(gpu.window.kg_arrivals, cpu.window.kg_arrivals),
                  f"{tag} tick {t}: arrival histograms differ from the CPU engine")
            log(f"[{tag}] tick {t}: card == cpu (sink_tuples={m.sink_tuples}, "
                f"{len(m.sink_outputs)} sink outputs held)")
            mc.sink_outputs.clear()
        elif t < check_ticks:
            check(sinks_close(m.sink_outputs, typed["sinks"][t]),
                  f"{tag} tick {t}: sink outputs differ from .typed()'s beyond rtol {JIT_RTOL}")
            log(f"[{tag}] tick {t}: {len(m.sink_outputs)} sink outputs == .typed()'s")
        if t < check_ticks:
            # This tick's outputs (2^20 store writes a tick in job 4), kept
            # for the .jit() run, then dropped.
            if typed is None:
                sinks.append(list(m.sink_outputs))
            m.sink_outputs.clear()
            if t == check_ticks - 1:
                cpu = None
                gpu.collect_sinks = False
    m = gpu.metrics
    a = sum(admitted.values())
    # No pending run (job 1's queue costs keep the float residue of its
    # 1.2-a-tuple geohash hop, so they are not compared with 0).
    check(not any(gpu._queues), f"{tag}: queues not drained")
    check(m.dropped_credits == 0, f"{tag}: tuples dropped by backpressure")
    if job == "job1":
        # wiki, geohash and topk see every tuple; topk's window rankings
        # (w1) go to global_topk, whose rankings are the sink's outputs.
        w1 = m.processed_tuples - 3 * a
        check(w1 > 0 and m.emitted_tuples == 2 * a + w1 + m.sink_tuples,
              f"{tag}: tuples not conserved (processed {m.processed_tuples}, emitted "
              f"{m.emitted_tuples}, sink {m.sink_tuples}, admitted {a})")
        if typed is None:
            outputs = [o for tick in sinks for o in tick]
            check(m.sink_tuples >= 2 and len(outputs) == m.sink_tuples,
                  f"{tag}: {m.sink_tuples} global TopK windows closed, expected >= 2")
            tops = [v["top"] for _, v, _ in outputs]
            check(all(len(x) == RJ_TOPK for x in tops), f"{tag}: a ranking is short")
            check(all(x[i][1] >= x[i + 1][1] for x in tops for i in range(RJ_TOPK - 1)),
                  f"{tag}: a global TopK ranking is not sorted")
    else:
        air, wx = admitted["airline"], admitted["weather"]
        # airline, extract, sumdelay, routedelay, join, efficiency and store
        # see every flight; weather, rainscore and join every observation.
        check(m.processed_tuples == 7 * air + 3 * wx
              and m.emitted_tuples == 6 * air + 2 * wx and m.sink_tuples == air,
              f"{tag}: tuples not conserved (processed {m.processed_tuples}, emitted "
              f"{m.emitted_tuples}, sink {m.sink_tuples}; {air} flights, {wx} observations)")
    hops = hop_kernels(gpu)
    host = HOST_HASHED.get(job, ())
    for name, (routed, part, srt) in hops.items():
        check(routed > 0, f"{tag}: no batch routed to {name}")
        check(part == (0 if name in host else routed),
              f"{tag}: {name} took keygroup_partition on {part} of {routed} batches")
        check(srt > 0 or name == "global_topk", f"{tag}: {name} never went through radix_sort")
    check(hops.get("global_topk", (0, 0, 0))[2] == 0,
          f"{tag}: global_topk (one key group) launched radix_sort")
    arrivals = gpu.window.kg_arrivals.copy()
    snap = gpu.end_period()
    check(np.isfinite(snap.kg_load).all(), f"{tag}: non-finite key-group load")
    states = synced_states(gpu)
    if typed is not None:
        check(np.array_equal(arrivals, typed["arrivals"]),
              f"{tag}: arrival histograms differ from .typed()'s")
        check(states_close(states, typed["states"]),
              f"{tag}: key-group state differs from .typed()'s beyond rtol {JIT_RTOL}")
        check(m.jit_calls > 0 and m.jit_host_syncs == m.jit_calls,
              f"{tag}: jit_calls {m.jit_calls}, jit_host_syncs {m.jit_host_syncs}")
        log(f"[{tag}] counts of every tick, arrival histograms and states == .typed()'s; "
            f"jit_calls={m.jit_calls} jit_compiles={m.jit_compiles}")
    else:
        check(m.jit_calls == 0, f"{tag}: .typed() made jit calls")
    tps = a / t_gpu
    res = {"tuples_per_s": tps, "seconds": t_gpu, "admitted": admitted, "hops": hops,
           "device_route_seconds": m.device_route_seconds,
           "host_device_copies": m.host_device_copies, "blob_bytes": blob}
    log(f"[{tag}] kgs/op={kgs} nodes={nodes} {admitted} in {ticks} ticks + {drain} drain "
        f"ticks ({t_gpu:.3f} s) = {tps:.0f} tuples/s; device round trips "
        f"{m.device_route_seconds:.3f} s; hops (routed, keygroup_partition, radix_sort) "
        f"{hops}")
    if typed is None:
        res.update(counts=counts, sinks=sinks, arrivals=arrivals,
                   states=pickle.loads(pickle.dumps(states, protocol=pickle.HIGHEST_PROTOCOL)))
    gpu.collect_sinks = False
    prof = profile_ticks(gpu, feeds[:3])
    res["profile"] = prof
    share = prof["busy_share"]
    log(f"[{tag}] {prof['ticks']} more ticks: wall {prof['wall_s']:.3f} s, device busy "
        f"{prof['busy_s'] * 1e3:.3f} ms ("
        + ("not measured" if share is None else f"{100 * share:.3f} %")
        + f"); top device events (ms, count): {prof['top']}")
    return res


def run_real_jobs(dev, *, batch: int = BATCH, kgs: int = KGS, nodes: int = NODES) -> dict:
    """Phase 3r: job 1 and job 4 under ``.typed()``, job 4 again under
    ``.jit()`` against the card's ``.typed()`` run."""
    from repro_torch.engine import ExecutionConfig

    size = dict(batch=batch, kgs=kgs, nodes=nodes)
    out = {}
    for job in ("job1", "job4"):
        out[job] = run_real_job(dev, job, **size)
    typed = out["job4"]
    out["job4_jit"] = run_real_job(dev, "job4", **size, config=ExecutionConfig.jit(),
                                   typed=typed)
    for r in out.values():
        for key in ("counts", "sinks", "arrivals", "states"):
            r.pop(key, None)
    out["job4_jit_vs_typed"] = out["job4_jit"]["tuples_per_s"] / typed["tuples_per_s"]
    return out


# --------------------------------------------------------------------- phase 4s
# The skew path: benchmarks/skew_grid.py's job (events → agg → total, both
# stateful stages split-mergeable), ported.
SKEW_SPLIT = 4
SKEW_TICKS = 24
SKEW_SURGE = 16  # make_scenario("flash_crowd"): the top 2 keys boosted 16x from here
SKEW_SPLIT_TICK = 18  # split after this tick's end_period (the surge's first two ticks)
SKEW_MOVE_TICK = 20  # a replica: redirect before this tick, install after it
SKEW_SPLITS = 4  # hottest key groups of agg and total split (3 reserve slots each)
SKEW_STATE_TICKS = (SKEW_SURGE - 1, SKEW_SPLIT_TICK - 1, SKEW_SPLIT_TICK, SKEW_MOVE_TICK,
                    SKEW_TICKS - 1, SKEW_TICKS + 1)
# skew_grid.episode's sizes (skew_grid.py:209-212) for the controller runs.
SG_NODES, SG_KGS, SG_PERIODS, SG_TICKS, SG_RATE, SG_KEYS = 12, 32, 10, 12, 384.0, 2048
SG_MAX_MIGR = 13


def bench_seed(*salt) -> int:
    """``benchmarks/common.py``'s ``bench_seed`` at the default root seed 0
    (crc32 salts through a SeedSequence), so the scenarios are the grid's."""
    import zlib

    parts = [zlib.crc32(str(x).encode()) for x in salt]
    return int(np.random.SeedSequence([0, *parts]).generate_state(1)[0])


def _merge_counts(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def _skew_agg(state, keys, values, ts):
    for k in keys.tolist():
        state[k] = state.get(k, 0) + 1
    return state, (keys, np.ones(len(keys), dtype=np.int64), ts)


def _skew_total(state, keys, values, ts):
    for k, v in zip(keys.tolist(), values.tolist()):
        state[k] = state.get(k, 0) + v
    return state, None


def skew_job(kgs: int):
    """``benchmarks/skew_grid.py``'s ``skew_job``: events → agg (count
    deltas) → total, both stateful stages declaring ``merge_state``."""
    from repro_torch.engine.topology import OperatorSpec, Topology

    t = Topology()
    t.add_operator(OperatorSpec("events", None, num_keygroups=kgs, is_source=True,
                                cost_per_tuple=0.05))
    t.add_operator(OperatorSpec("agg", _skew_agg, num_keygroups=kgs,
                                merge_state=_merge_counts))
    t.add_operator(OperatorSpec("total", _skew_total, num_keygroups=kgs, is_sink=True,
                                cost_per_tuple=0.5, merge_state=_merge_counts))
    t.connect("events", "agg")
    t.connect("agg", "total")
    return t


def layer_totals(eng, name: str) -> dict:
    """An operator's state folded over its key groups and their replicas."""
    op = eng.topology._resolve(name)
    base = eng.topology.kg_base(op)
    kgs = list(range(base, base + eng.topology.operators[op].num_keygroups))
    for parent, slots in eng.split_families().items():
        if parent in kgs:
            kgs.extend(slots)
    out = {}
    for kg in kgs:
        for k, v in eng.store.get(kg).items():
            out[k] = out.get(k, 0) + v
    return out


def run_skew_data_plane(dev, *, batch: int, key_space: int, kgs: int, nodes: int) -> dict:
    """Phase 4s (a): the flash crowd at full size under ``.split(4)``; every
    tick's counts, arrivals and routing, the states at ``SKEW_STATE_TICKS``,
    the split, a replica's move, the unsplit's merged state and the sink
    totals held bit-identical to the CPU engine on the same batches."""
    import torch

    from repro_torch.engine import Engine, ExecutionConfig
    from repro_torch.engine.executor import hot_key_summary
    from repro_torch.workloads import make_scenario, scenario_batches

    tag = "skew"
    spec = make_scenario("flash_crowd", rate=float(batch), key_space=key_space,
                         seed=bench_seed("skew_grid", "flash_crowd"))
    t0 = time.perf_counter()
    batches = scenario_batches(spec, SKEW_TICKS)
    gen_s = time.perf_counter() - t0

    def make(device):
        eng = Engine(skew_job(kgs), nodes, config=ExecutionConfig.split(SKEW_SPLIT),
                     service_rate=1e12, seed=SEED, collect_sinks=False, device=device)
        eng.backpressure.full_credit = 4 * batch
        return eng

    gpu, cpu = make(dev), make("cpu")
    engines = (gpu, cpu)
    admitted, t_gpu, hot, families, move = 0, 0.0, {}, {}, None
    for t in range(SKEW_TICKS + 2):
        k, v, ts = batches[t] if t < SKEW_TICKS else (None, None, None)
        fed = k is not None and len(k) > 0
        if move and t == SKEW_MOVE_TICK:
            for eng in engines:
                eng.redirect(*move)
        # The card engine's push (the source hop's routing) and tick are
        # timed together, as in phases 3 and 3r; the CPU engine's after.
        for eng in engines:
            t0 = time.perf_counter()
            if fed:
                n = eng.push_source("events", k, v, ts)
                check(n == len(k), f"{tag} tick {t}: admitted {n} of {len(k)} tuples")
            eng.tick()
            if eng is gpu:
                torch.cuda.synchronize()
                t_gpu += time.perf_counter() - t0
        admitted += len(k) if fed else 0
        if move and t == SKEW_MOVE_TICK:
            blobs = [eng.serialize(move[0]) for eng in engines]
            check(blobs[0] == blobs[1], f"{tag}: replica {move[0]}'s blob differs from the "
                  "CPU engine's")
            for eng, b in zip(engines, blobs):
                eng.install(move[0], move[1], b)
            log(f"[{tag}] moved replica {move[0]} to node {move[1]}: {len(blobs[0])}-byte "
                "blob == the CPU engine's")
        m, mc = gpu.metrics, cpu.metrics
        check((m.processed_tuples, m.emitted_tuples, m.sink_tuples, m.cross_node_tuples)
              == (mc.processed_tuples, mc.emitted_tuples, mc.sink_tuples,
                  mc.cross_node_tuples)
              and np.array_equal(gpu.window.kg_arrivals, cpu.window.kg_arrivals),
              f"{tag} tick {t}: counts or arrivals differ from the CPU engine")
        check(np.array_equal(gpu.router.table, cpu.router.table),
              f"{tag} tick {t}: routing tables differ")
        if t in SKEW_STATE_TICKS:
            # Every key group's state bytes (a few seconds a comparison at
            # 2^20 keys): before and at the surge, around the split and the
            # move, and after the drain.
            check(state_bytes(gpu) == state_bytes(cpu),
                  f"{tag} tick {t}: key-group state differs from the CPU engine")
        if t in (SKEW_SURGE - 1, SKEW_SPLIT_TICK - 1, SKEW_TICKS - 1):
            when = {SKEW_SURGE - 1: "before the surge", SKEW_SPLIT_TICK - 1: "surge, unsplit",
                    SKEW_TICKS - 1: "surge, split"}[t]
            snaps = [eng.end_period() for eng in engines]
            check(np.array_equal(snaps[0].kg_load, snaps[1].kg_load)
                  and m.hot_keygroups == mc.hot_keygroups
                  and m.max_kg_share == mc.max_kg_share,
                  f"{tag} tick {t}: snapshot or hot-key gauges differ from the CPU engine")
            arr = snaps[0].kg_tuple_rate
            splittable = np.array([gpu.topology.operators[int(o)].merge_state is not None
                                   for o in gpu._kg_op[:len(arr)]])
            stop, sshare = hot_key_summary(np.where(splittable, arr, 0.0))
            hot[when] = dict(hot_keygroups=m.hot_keygroups, max_kg_share=m.max_kg_share,
                             splittable_top=stop, splittable_share=sshare)
            log(f"[{tag}] {when} (tick {t}): hot_key_summary {m.hot_keygroups}, "
                f"max_kg_share {m.max_kg_share:.6f}; agg/total layers only: top {stop[:4]}, "
                f"share {sshare:.6f}")
            if t == SKEW_SPLIT_TICK - 1:
                targets = [kg for kg, _ in stop[:SKEW_SPLITS]]
                for kg in targets:
                    slots = [eng.split_keygroup(kg) for eng in engines]
                    check(slots[0] == slots[1], f"{tag}: split slots differ")
                    families[kg] = slots[0]
                replica = families[targets[0]][0]
                move = (replica, (gpu.router.node_of(replica) + 1) % nodes)
                log(f"[{tag}] split {targets} x{SKEW_SPLIT}: families {families}")
    # Unsplit every family: each parent's state is its replicas' merge.
    before = {name: layer_totals(gpu, name) for name in ("agg", "total")}
    for kg in families:
        for eng in engines:
            eng.unsplit_keygroup(kg)
    check(not gpu.split_families() and state_bytes(gpu) == state_bytes(cpu),
          f"{tag}: merged state after the unsplit differs from the CPU engine")
    totals = {name: layer_totals(gpu, name) for name in ("agg", "total")}
    check(totals == before, f"{tag}: the unsplit changed a layer's folded state")
    check(totals == {name: layer_totals(cpu, name) for name in totals},
          f"{tag}: sink totals differ from the CPU engine")
    check(sum(totals["total"].values()) == admitted == sum(totals["agg"].values()),
          f"{tag}: the sink counted {sum(totals['total'].values())} of {admitted} events")
    m = gpu.metrics
    hops = hop_kernels(gpu)
    for name, (routed, part, srt) in hops.items():
        check(routed > 0 and part == routed and srt > 0,
              f"{tag}: {name} missed a routing kernel (routed, partition, sort) {hops}")
    tps = admitted / t_gpu
    log(f"[{tag}] flash_crowd x{SKEW_TICKS} ticks ({admitted} events, key space {key_space}, "
        f"generated in {gen_s:.3f} s): card {t_gpu:.3f} s = {tps:.0f} tuples/s; hops "
        f"(routed, keygroup_partition, radix_sort) {hops}; split families merged back, "
        f"sink totals == CPU engine == events")
    return {"tuples_per_s": tps, "admitted": admitted, "hot": hot, "families": families,
            "hops": hops, "device_route_seconds": m.device_route_seconds}


def _imbalance(loads: np.ndarray) -> float:
    mean = float(loads.mean())
    return 0.0 if mean <= 0.0 else (float(loads.max()) - mean) / mean


def skew_episode(dev, balancer: str, *, split: bool) -> dict:
    """``benchmarks/skew_grid.py``'s ``episode`` on ``flash_crowd`` with a
    card engine and a CPU engine fed the same batches: each period's
    snapshot held against the CPU engine's, each plan solved once on the
    card engine's snapshot and applied to both, whose routing tables,
    split families and states must then agree."""
    from repro_torch.core import AdaptationFramework, AlbicParams
    from repro_torch.core.baselines import PotcSimulator, cola_allocate, flux_rebalance
    from repro_torch.core.migration import execute_plan, plan_from_allocations
    from repro_torch.core.splitting import HotKeySplitter
    from repro_torch.engine import Engine, ExecutionConfig
    from repro_torch.workloads import make_scenario, scenario_batches

    name = balancer + ("+split" if split else "")
    tag = f"skew/{name}"
    spec = make_scenario("flash_crowd", rate=SG_RATE, key_space=SG_KEYS,
                         seed=bench_seed("skew_grid", "flash_crowd"))
    batches = iter(scenario_batches(spec, SG_PERIODS * SG_TICKS))
    config = ExecutionConfig.split(SKEW_SPLIT) if split else ExecutionConfig.typed()
    gpu, cpu = (Engine(skew_job(SG_KGS), SG_NODES, service_rate=SG_NODES * 110.0,
                       seed=bench_seed("skew_grid", "alloc"), collect_sinks=False,
                       config=config, device=d) for d in (dev, "cpu"))
    engines = (gpu, cpu)
    fw = None
    if balancer in ("albic", "milp"):
        fw = AdaptationFramework(mode=balancer, max_migrations=SG_MAX_MIGR, time_limit=2.0,
                                 albic_params=AlbicParams(time_limit=1.0),
                                 splitter=HotKeySplitter() if split else None)
    sim = None
    imb, migcost, splits, moves = [], [], 0, 0
    for p in range(SG_PERIODS):
        for _ in range(SG_TICKS):
            keys, values, ts = next(batches)
            for eng in engines:
                if len(keys):
                    eng.push_source("events", keys, values, ts)
                eng.tick()
        snap, snap_c = (eng.end_period() for eng in engines)
        for field in ("kg_load", "kg_tuple_rate", "kg_state_bytes"):
            a, b = getattr(snap, field), getattr(snap_c, field)
            check(np.allclose(a, b, rtol=FLOAT_RTOL, atol=FLOAT_RTOL),
                  f"{tag} period {p}: snapshot {field} differs")
        check(np.array_equal(snap.alloc, snap_c.alloc), f"{tag} period {p}: alloc differs")
        cost = 0.0
        if balancer == "potc":
            if sim is None:
                sim = PotcSimulator(snap)
            loads, _ = sim.step(snap.kg_load)
            imb.append(_imbalance(loads[snap.alive]))
            migcost.append(0.0)
            continue
        if p >= 1:
            if fw is not None:
                result = fw.adapt(snap,
                                  split_families=gpu.split_families() if split else None,
                                  split_eligible=gpu.split_eligible() if split else None)
                mp = result.migration_plan
                decision = result.split
            else:
                plan = (flux_rebalance(snap, max_migrations=SG_MAX_MIGR) if balancer == "flux"
                        else cola_allocate(snap, seed=bench_seed("skew_grid", "cola", p)))
                mp = plan_from_allocations(snap, plan.alloc)
                decision = None
            for eng in engines:
                execute_plan(mp, eng)
                if decision is not None:
                    for kg in decision.unsplit:
                        eng.unsplit_keygroup(kg)
                    for kg in decision.split:
                        if eng.split_slots_free < SKEW_SPLIT - 1:
                            break
                        eng.split_keygroup(kg)
            cost = mp.total_cost
            moves += len(mp.moves)
            splits += 0 if decision is None else len(decision.split)
            check(np.array_equal(gpu.router.table, cpu.router.table)
                  and gpu.split_families() == cpu.split_families(),
                  f"{tag} period {p}: routing tables or split families differ after the plan")
        check(state_bytes(gpu) == state_bytes(cpu), f"{tag} period {p}: states differ")
        loads = snap.node_loads(gpu.router.table)
        imb.append(_imbalance(loads[gpu.alive]))
        migcost.append(cost)
    steady = slice(max(SG_PERIODS - 3, 1), None)
    res = {"imbalance": float(np.mean(imb[steady])), "imbalance_max": float(np.max(imb[1:])),
           "migcost": float(np.mean(migcost[1:])), "migrations": moves, "splits": splits}
    log(f"[{tag}] flash_crowd {SG_PERIODS} x {SG_TICKS} ticks, {SG_NODES} nodes, "
        f"{SG_KGS} kgs/op: "
        f"imbalance={res['imbalance']:.3f} migcost={res['migcost']:.1f} "
        f"imbalance_max={res['imbalance_max']:.3f} migrations={moves} splits={splits}; "
        "card == cpu every period")
    return res


def run_skew(dev, *, batch: int = BATCH, key_space: int = BATCH, kgs: int = KGS,
             nodes: int = NODES) -> dict:
    """Phase 4s: the skew data plane at full size, then the skew grid's
    controller runs for ALBIC with hot-key splitting, COLA, Flux and PoTC."""
    out = {"data_plane": run_skew_data_plane(dev, batch=batch, key_space=key_space, kgs=kgs,
                                             nodes=nodes)}
    for balancer, split in (("albic", True), ("cola", False), ("flux", False),
                            ("potc", False)):
        out[balancer + ("+split" if split else "")] = skew_episode(dev, balancer, split=split)
    return out


# --------------------------------------------------------------------- phase 3w
# The multi-worker runtime (repro_torch.engine.cluster) at phase 3's
# deployment, run by ``python3 chip_smoke.py --workers`` in a fresh
# interpreter: its coordinator forks card workers, so it must make no CUDA
# call before every pool is closed (a child forked from a process that
# initialized CUDA cannot use it).  Phase 3w's own card engines (the
# single-process references) run after that, in the same interpreter.
W_WORKERS = 4
W_TICKS = 4  # lockstep ticks of (a) (8 before 3r and 4s, 6 before 9, 5 before 10 and 11)
W_MIG_TICK = 2  # (b): redirect at this tick, serialize + install at the next
W_FAULT_BATCH, W_FAULT_TICKS = 1 << 14, 3  # (c): the planted map, at a cut depth
W_STREAM_WORKERS = (2, 4)  # (f)
W_STREAM_BATCHES = 3  # (8 before phases 3r and 4s, 6 before 9, 4 before 10 and 11)
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
    batches = source_batches("airline", ticks, batch, SEED)
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
    fault_batches = source_batches("airline", W_FAULT_TICKS, fault_batch, SEED + 1)
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
    stream_batches = source_batches("airline", n_stream, batch, SEED + 2)
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
    """Layers of each kernel-bearing kind: decoder attention (ATTN,
    ATTN_MOE, LOCAL_ATTN), encoder attention, cross attention (one per
    decoder attention layer of an encoder-decoder model), RG-LRU and MoE."""
    from repro_torch.configs.base import ATTN, ATTN_MOE, LOCAL_ATTN, RGLRU

    kinds = list(cfg.pattern) * cfg.cycles + list(cfg.remainder)
    attn = sum(k in (ATTN, ATTN_MOE, LOCAL_ATTN) for k in kinds)
    return dict(attn=attn, enc=cfg.encoder_layers, cross=attn if cfg.is_encdec else 0,
                rglru=kinds.count(RGLRU), moe=kinds.count(ATTN_MOE))


def expected_launches(cfg, steps: int) -> dict[str, int]:
    """Launches of one prefill and ``steps`` decode steps: flash once per
    attention layer (decoder, encoder and cross) and rglru_scan once per
    RG-LRU layer in the prefill; decode attention once per decoder and
    cross attention layer and step; moe_gemm three times (gate, up, down)
    per MoE layer in the prefill and in each step."""
    n = layer_counts(cfg)
    return {"flash_attention": n["attn"] + n["enc"] + n["cross"],
            "decode_attention": (n["attn"] + n["cross"]) * steps,
            "rglru_scan": n["rglru"], "moe_gemm": 3 * n["moe"] * (1 + steps)}


@contextlib.contextmanager
def timed_slstm(spans: list):
    """While active, each sLSTM block of a sequence (S > 1) is timed with a
    device synchronization on either side; its seconds go to ``spans``."""
    import torch

    import repro_torch.models.transformer as transformer

    routed = transformer.slstm_block

    def timed(cfg, p, x, **kw):
        if x.shape[1] == 1:
            return routed(cfg, p, x, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = routed(cfg, p, x, **kw)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return out

    transformer.slstm_block = timed
    try:
        yield
    finally:
        transformer.slstm_block = routed


def prefill_decode(dev, cfg, params, *, batch: int, prompt: int, steps: int,
                   context: int, encoder_embeds=None) -> dict:
    """Prefill ``batch`` prompts of numpy-seeded tokens through
    ``Model.forward(build_cache=True)`` (over ``encoder_embeds`` for an
    encoder-decoder model), then decode ``steps`` tokens greedily; returns
    timings and what the consistency check needs.  The sLSTM blocks of the
    prefill (xLSTM) are timed apart (``slstm_s``)."""
    import torch

    from repro_torch.models import Model

    model = Model(cfg)
    tokens = torch.from_numpy(
        np.random.default_rng(SEED).integers(0, cfg.vocab_size, (batch, prompt))
    ).to(dev)
    slstm = []
    t0 = time.perf_counter()
    with timed_slstm(slstm):
        logits, cache, _ = model.forward(params, tokens=tokens, build_cache=True,
                                         cache_capacity=context, encoder_embeds=encoder_embeds)
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
    enc = (f" over {tuple(encoder_embeds.shape[:2])} encoder frames"
           if encoder_embeds is not None else "")
    share = (f" (its {len(slstm)} sLSTM layers {sum(slstm):.3f} s, "
             f"{sum(slstm) / t_prefill:.1%}, each timed between syncs)" if slstm else "")
    log(f"[lm] {cfg.name} L={cfg.num_layers} d={cfg.d_model} V={cfg.vocab_size}: prefill "
        f"{batch}x{prompt}{enc} in {t_prefill:.3f} s = {batch * prompt / t_prefill:.0f} "
        f"tokens/s{share}; decode {ms_step:.3f} ms/step (median of {len(steady)}; first "
        f"{1e3 * step_s[0]:.3f}) = {batch / (ms_step / 1e3):.1f} tokens/s")
    return dict(
        prefill_s=t_prefill,
        slstm_s=sum(slstm),
        slstm_share=sum(slstm) / t_prefill,
        encoder_embeds=encoder_embeds,
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
    routed_cross = transformer.cross_attention
    attn_errs, scan_errs, gemm_errs = [], [], []
    hold = _paired(attn_errs)

    def plain(q, k, v, causal, window=None):
        # One sequence at a time keeps the plain version's f32 scores small.
        return torch.cat([attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal,
                                        window=window) for i in range(q.shape[0])])

    def paired_attention(q, k, v, *, causal=True, window=None, **kw):
        out = routed[0](q, k, v, causal=causal, window=window, **kw)
        hold("flash kernel against its plain version inside the prefill", out,
             plain(q, k, v, causal, window), v)
        return out

    def paired_cross(q, k, v):
        out = routed_cross(q, k, v)
        hold("flash kernel (cross attention) against its plain version inside the prefill",
             out, plain(q, k, v, False), v)
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
    transformer.cross_attention = paired_cross
    try:
        logits, _, _ = Model(cfg).forward(params, tokens=run["tokens"],
                                          encoder_embeds=run["encoder_embeds"])
    finally:
        transformer.attention, rglru_mod.scan_kernel, moe_mod.moe_gemm = routed
        transformer.cross_attention = routed_cross
    del logits
    torch.cuda.synchronize()
    n = layer_counts(cfg)
    worst, rel, vmax = _paired_summary(attn_errs, n["attn"] + n["enc"] + n["cross"], "prefill")
    res = dict(prefill_layers_paired=len(attn_errs), prefill_paired_max_err=worst,
               prefill_paired_max_row_rel_err=rel, prefill_paired_max_abs_v=vmax)
    msg = (f"[lm] {cfg.name}: in a bf16 prefill {tuple(run['tokens'].shape)}, flash kernel vs "
           f"plain version in each of {len(attn_errs)} attention layers ({n['enc']} encoder, "
           f"{n['cross']} cross): max err {worst} (max |v| {vmax}), max row error {rel:.3e}")
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

    routed = transformer.decode_attention, moe_mod.moe_gemm, transformer.cross_attention
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

    def paired_cross(q, ck, cv):
        out = routed[2](q, ck, cv)
        every = torch.full((q.shape[0],), ck.shape[1], dtype=torch.int32, device=q.device)
        hold("decode kernel (cross attention) against its plain version inside the decode "
             "step", out, decode_attention_ref(q, ck, cv, every), cv)
        return out

    tok = run["last_tok"]
    pos = torch.full((tok.shape[0],), run["next_pos"], dtype=torch.int64, device=tok.device)
    transformer.decode_attention, moe_mod.moe_gemm, transformer.cross_attention = (
        paired, _paired_gemm(gemm_errs, routed[1], "decode step"), paired_cross)
    try:
        Model(cfg).decode_step(params, run["cache"], tok[:, None], pos)
    finally:
        transformer.decode_attention, moe_mod.moe_gemm, transformer.cross_attention = routed
    torch.cuda.synchronize()
    n = layer_counts(cfg)
    worst, rel, vmax = _paired_summary(errs, n["attn"] + n["cross"], "decode")
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
    frames = None if run["encoder_embeds"] is None else run["encoder_embeds"][:rows]
    prompt = tokens.shape[1]
    pos = torch.full((rows,), prompt, dtype=torch.int64, device=tokens.device)

    def last_row(model, p, frames=frames):
        logits, _, _ = model.forward(p, tokens=torch.cat([tokens, nxt], dim=1),
                                     encoder_embeds=frames)
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

    # An encoder-decoder model keeps as many encoder layers as decoder cycles.
    enc_layers = min(cfg.encoder_layers, cycles)
    cfg32 = dataclasses.replace(cfg, dtype="float32", cycles=cycles, remainder=(),
                                encoder_layers=enc_layers)
    # Cut to depth before the cast: Moonlight's 56 GB of bf16 would not fit twice.
    p32 = {k: v for k, v in params.items() if k not in ("blocks", "rem_blocks")}
    p32["blocks"] = tree_map(lambda a: a[:cycles], params["blocks"])
    p32["rem_blocks"] = []
    if cfg.is_encdec:
        p32["encoder"] = dict(params["encoder"],
                              blocks=tree_map(lambda a: a[:enc_layers],
                                              params["encoder"]["blocks"]))
    p32 = tree_map(lambda a: a.float(), p32)
    frames32 = None if frames is None else frames.float()
    model = Model(cfg32)
    logits, cache, _ = model.forward(p32, tokens=tokens, build_cache=True, cache_capacity=context,
                                     encoder_embeds=frames32)
    del logits
    dec, _ = model.decode_step(p32, cache, nxt, pos)
    del cache
    got = dec[:, 0].float()
    dropped = [torch.zeros(rows, dtype=torch.int64, device=got.device)]
    with watch_last_token_drops(cfg32, dropped):
        ref = last_row(model, p32, frames32)
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
    enc = f" (+ {enc_layers} encoder layers)" if enc_layers else ""
    log(f"[lm] {cfg.name}: decode vs full forward, f32, {cfg32.num_layers} layers{enc}, {n} of "
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
               device_ops_per_step=sum(n for _, _, n in rows) / steps,
               kernel_ms_per_step={k: v for k, v in per_kernel.items() if v > 0},
               top=[(k, round(us / 1e3, 3), n) for us, k, n in rows[:10]])
    if rows:
        log(f"[profile] {cfg.name}, {steps} decode steps: wall {wall * 1e3:.3f} ms, device busy "
            f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f} %), {res['busy_ms_per_step']:.3f} ms "
            f"busy per step; {res['device_ops_per_step']:.1f} device launches (kernels, copies, "
            f"memsets) per step; port kernels' device ms per step {res['kernel_ms_per_step']}; "
            f"top kernels (ms, launches): {res['top']}")
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
        ``scan`` leaves and of an encoder-decoder's ``cross`` k/v, axis 0 of
        the remainder blocks' ``rem`` leaves, at any rank (k/v rings and
        caches, RG-LRU ``h`` and ``conv``, xLSTM ``C``, ``n``, ``m``, ``c``,
        ``h``)."""
        return ([(n, a, 1) for e in cache["scan"] for n, a in e.items()]
                + [(f"cross {n}", a, 1) for n, a in cache.get("cross", {}).items()]
                + [(n, a, 0) for e in cache["rem"] for n, a in e.items()])

    def slot_sums(cache) -> torch.Tensor:
        # (leaves, slots) float64 checksums over every axis but the slot's,
        # one slot at a time: a whole leaf cast to float64 would add 6.4 GB
        # (Moonlight's) to the serve loop's peak memory.
        return torch.stack([
            torch.stack([a.select(axis, s).sum(dtype=torch.float64)
                         for s in range(a.shape[axis])])
            for _, a, axis in leaves(cache)])

    steps = []

    class CheckedWorker(DecodeWorker):
        def decode_tick(self):
            n, dt = super().decode_tick()
            steps.append(n)
            return n, dt

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
        decode_steps=sum(n > 0 for n in steps),
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


def check_chunk_boundary(cfg, params, run: dict) -> dict:
    """xLSTM across the mLSTM's chunk boundary on the first pattern cycle (7
    mLSTM + 1 sLSTM layers) of the same weights and the first XL_ROWS
    prompts: a 256-token prefill, then teacher-forced decode steps through
    position 511, every position's logits against the port's own 512-token
    (two-chunk) forward.  Gated in float64 at XL_TOL; a planted fault, the
    carried state read as Cᵀq (the reference's contraction,
    ``src/repro/models/xlstm.py:150-152``), must fail it.  The same in
    float32 is measured beside the f32 forward's distance from the f64 one
    (the model's own conditioning), not gated."""
    import dataclasses

    import torch

    import repro_torch.models.xlstm as xlstm
    from repro_torch.models import Model
    from repro_torch.models.common import tree_map

    first = {k: v for k, v in params.items() if k != "blocks"}
    first["blocks"] = tree_map(lambda a: a[:1], params["blocks"])
    toks = run["tokens"][:XL_ROWS]
    toks = torch.cat([toks, toks], dim=1)[:, :XL_TOTAL]  # 512 tokens: the prompt, repeated

    def both(dtype: str, readout=None):
        """(two-chunk forward, decode) logits at positions 256-511."""
        cfg_d = dataclasses.replace(cfg, dtype=dtype, cycles=1, remainder=())
        p = tree_map(lambda a: a.to(getattr(torch, dtype)), first)
        model = Model(cfg_d)
        saved = xlstm.carry_readout
        xlstm.carry_readout = readout or saved
        try:
            full = model.forward(p, tokens=toks)[0][:, XL_PREFIX:]
        finally:
            xlstm.carry_readout = saved
        if readout is not None:
            return full, None
        _, cache, _ = model.forward(p, tokens=toks[:, :XL_PREFIX], build_cache=True)
        steps = []
        for pos in range(XL_PREFIX, XL_TOTAL):
            out, cache = model.decode_step(p, cache, toks[:, pos : pos + 1],
                                           torch.full((XL_ROWS,), pos, device=toks.device))
            steps.append(out[:, 0])
        return full, torch.stack(steps, dim=1)

    full64, dec64 = both("float64")
    diff, bad = max_err(full64, dec64, XL_TOL)
    check(bad == 0, f"{cfg.name}: f64 decode past the first mLSTM chunk disagrees with the "
          f"two-chunk forward: {bad} of {dec64.numel()} outside {XL_TOL} (max diff {diff})")
    fault, fault_bad = max_err(both("float64", lambda q, c: q @ c)[0], dec64, XL_TOL)  # Cᵀq
    check(fault_bad > 0, f"{cfg.name}: the chunk-boundary check passes a planted fault (the "
          f"carry read as Cᵀq): max diff {fault}")
    full32, dec32 = both("float32")
    res = dict(boundary_max_diff_f64=diff, boundary_logit_absmax=float(full64.abs().max()),
               boundary_positions=XL_TOTAL - XL_PREFIX, boundary_planted_fault_max_diff=fault,
               boundary_planted_fault_outside=fault_bad,
               boundary_f32_forward_vs_decode=float((full32 - dec32).abs().max()),
               boundary_f32_vs_f64_forward=float((full32 - full64).abs().max()),
               boundary_f32_vs_f64_decode=float((dec32 - dec64).abs().max()))
    log(f"[lm] {cfg.name}: across the mLSTM chunk boundary, {len(cfg.pattern)} layers, "
        f"{XL_ROWS} rows, decode "
        f"from a {XL_PREFIX}-token prefill vs the {XL_TOTAL}-token forward at positions "
        f"{XL_PREFIX}-{XL_TOTAL - 1}: f64 max diff {diff:.3e} (|logit| max "
        f"{res['boundary_logit_absmax']:.4f}, limit {XL_TOL}); planted fault (carry read as "
        f"Cᵀq): max diff {fault:.4f}, {fault_bad} outside.  f32, not gated: forward vs decode "
        f"{res['boundary_f32_forward_vs_decode']:.4f}, forward vs the f64 forward "
        f"{res['boundary_f32_vs_f64_forward']:.4f}, decode vs the f64 decode "
        f"{res['boundary_f32_vs_f64_decode']:.4f}")
    return res


#: The LM phases: GLM-4-9B (5-6), RecurrentGemma-2B (7), Moonlight (8),
#: xLSTM-1.3B (10) and Whisper-small (11).
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
    # Phase 12 (c) runs on these weights too: expert_parallel.
    dict(arch=MOE_ARCH, context=MOE_CONTEXT, batch=MOE_BATCH, prompt=MOE_PROMPT,
         steps=MOE_DECODE_STEPS, check_cycles=CHECK_CYCLES, check_rows=MOE_BATCH,
         serve_context=MOE_SERVE_CONTEXT, serve=SERVE, expert_parallel=True),
    # No kernel on its path: check_chunk_boundary takes the place of the
    # kernel pairings and of check_prefill_decode.
    dict(arch=XL_ARCH, context=XL_CONTEXT, batch=XL_BATCH, prompt=XL_PROMPT,
         steps=XL_DECODE_STEPS, serve_context=XL_CONTEXT, serve=SERVE),
    # The serve loop decodes against an empty encoder, as the reference's.
    dict(arch=WH_ARCH, context=WH_CONTEXT, batch=WH_BATCH, prompt=WH_PROMPT,
         steps=WH_DECODE_STEPS, frames=WH_FRAMES, check_cycles=CHECK_CYCLES,
         serve_context=WH_CONTEXT, serve=SERVE),
)


def run_lm(dev, drive, spec: dict) -> tuple[dict, dict]:
    """One model at full width on the card: random bf16 weights from a
    seeded generator (and, for an encoder-decoder model, seeded frame
    embeddings), then prefill + greedy decode with exact launch counts (the
    path the JSON line's launches come from), the per-layer kernel
    pairings, a decode profile, the f32 prefill/decode consistency check
    (xLSTM: across the mLSTM chunk boundary), and the serve loop (launches
    counted too).  Frees the weights after."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.models.common import tree_leaves

    cfg = lm_config(spec["arch"], spec["context"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, device=dev)
    frames = None
    if cfg.is_encdec:
        gen = torch.Generator(device=dev).manual_seed(SEED + 20)
        frames = torch.randn((spec["batch"], spec["frames"], cfg.d_model), generator=gen,
                             device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[lm] {cfg.name}: L={cfg.num_layers} d={cfg.d_model} V={cfg.vocab_size}, "
        f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B parameters initialized on "
        f"the card in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    want = expected_launches(cfg, spec["steps"])
    run, counts = drive(tuple(k for k, n in want.items() if n), prefill_decode, dev, cfg,
                        params, batch=spec["batch"], prompt=spec["prompt"],
                        steps=spec["steps"], context=spec["context"], encoder_embeds=frames)
    for name, n in want.items():
        check(counts[name] == n, f"{cfg.name}: prefill + {spec['steps']} decode steps launched "
              f"{name} {counts[name]} times, not {n}")
    log(f"[lm] {cfg.name}: launches of one prefill and {spec['steps']} decode steps {want}")
    lm = {k: v for k, v in run.items()
          if k not in ("next_pos", "encoder_embeds") and not isinstance(v, (torch.Tensor, dict))}
    lm["launches"] = want
    kernels = any(want.values())
    if kernels:
        lm.update(check_kernels_in_decode(cfg, params, run))
    lm["profile"] = profile_decode(cfg, params, run)
    del run["cache"]
    if kernels:
        lm.update(check_kernels_in_prefill(cfg, params, run))
        lm.update(check_prefill_decode(cfg, params, run, context=spec["context"],
                                       cycles=spec["check_cycles"],
                                       rows=spec.get("check_rows", 2)))
    else:
        lm.update(check_chunk_boundary(cfg, params, run))
    del run
    lm["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[lm] {cfg.name}: peak device memory {lm['peak_mem_gb']:.2f} GB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.2f} GB")
    decode = ((("decode_attention",) if want["decode_attention"] else ())
              + (("moe_gemm",) if cfg.moe is not None else ()))
    served, serve_counts = drive(decode, run_serve, dev,
                                 lm_config(spec["arch"], spec["serve_context"]), params,
                                 spec["serve"])
    check(serve_counts["flash_attention"] == 0 and serve_counts["rglru_scan"] == 0,
          "the serve loop launched a prefill kernel")
    if cfg.is_encdec:
        # Against an empty encoder (the reference's DecodeWorker): the
        # cross sublayers launch nothing, so one decode launch per self
        # attention layer and decode step.
        per_step = serve_counts["decode_attention"] / max(served["decode_steps"], 1)
        check(per_step == layer_counts(cfg)["attn"], f"{cfg.name}: the serve loop launched "
              f"{per_step} decode kernels a step, not one per self attention layer")
    check(all(serve_counts[k] == 0 for k in serve_counts if k not in decode),
          f"{cfg.name}: the serve loop launched a kernel off its path: {serve_counts}")
    if spec.get("expert_parallel"):
        lm["expert_parallel"] = ep_steps(dev, drive, cfg, params, spec)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return lm, served


# --------------------------------------------------------------------- phase 12
# The mesh and dry-run tooling (repro_torch.launch.{mesh,sharding,roofline,
# dryrun}) on the card's 1×1 mesh.
DRY_FITS = {("recurrentgemma_2b", "decode_32k"), ("recurrentgemma_2b", "long_500k"),
            ("xlstm_1_3b", "decode_32k"), ("xlstm_1_3b", "long_500k")}
DRY_OK, DRY_SKIP = 32, 8  # applicable cells, and long_500k of the 8 full-attention archs


@contextlib.contextmanager
def counted_expert_parallel(calls: list):
    """While active, each call of ``moe._moe_expert_parallel`` is counted."""
    import repro_torch.models.moe as moe

    routed = moe._moe_expert_parallel

    def counted(*args):
        calls.append(1)
        return routed(*args)

    moe._moe_expert_parallel = counted
    try:
        yield
    finally:
        moe._moe_expert_parallel = routed


def ep_steps(dev, drive, cfg, params, spec: dict) -> dict:
    """Phase 12 (c): one prefill and one decode step of the model under its
    own rules on the card's 1×1 mesh (``activation_rules(rules_for(cfg,
    shape, mesh), mesh=mesh)``): every MoE layer takes the expert-parallel
    path, through moe_gemm, and is held to the same steps without the
    context by the row check.  Both runs take torch's deterministic
    algorithms (warnings only), so ``index_add_``'s combine sums in one
    order in both; bit equality is reported.  The run under the context is
    the counted one."""
    import torch

    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import rules_for
    from repro_torch.models import Model
    from repro_torch.models.common import activation_rules

    model = Model(cfg)
    b, prompt = spec["batch"], spec["prompt"]
    tokens = torch.from_numpy(
        np.random.default_rng(SEED).integers(0, cfg.vocab_size, (b, prompt))).to(dev)
    nxt = tokens[:, :1].clone()  # one fixed next token, the same in both runs
    pos = torch.full((b,), prompt, dtype=torch.int64, device=dev)
    mesh = make_host_mesh(device=dev)

    def steps(rules=None):
        ctx = [activation_rules(r, mesh=mesh) for r in rules] if rules else [None, None]
        with torch.inference_mode():
            with ctx[0] or contextlib.nullcontext():
                logits, cache, _ = model.forward(params, tokens=tokens, build_cache=True,
                                                 cache_capacity=spec["context"])
            last = logits[:, -1].float()
            del logits
            with ctx[1] or contextlib.nullcontext():
                out, cache = model.decode_step(params, cache, nxt, pos)
            torch.cuda.synchronize()
        del cache
        return last, out[:, 0].float()

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain = steps()
        rules = [rules_for(cfg, SHAPES[name], mesh) for name in ("prefill_32k", "decode_32k")]
        check(all(r["expert"] == "model" for r in rules), f"{cfg.name}: experts off 'model'")
        calls: list = []
        t0 = time.perf_counter()
        with counted_expert_parallel(calls):
            (ep, counts) = drive(("moe_gemm", "flash_attention", "decode_attention"), steps,
                                 rules)
        secs = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(deterministic)
    moe_layers = layer_counts(cfg)["moe"]
    check(len(calls) == 2 * moe_layers, f"{cfg.name}: {len(calls)} expert-parallel calls, not "
          f"{2 * moe_layers} (one per MoE layer in the prefill and in the decode step)")
    check(counts["moe_gemm"] == 6 * moe_layers, f"{cfg.name}: expert-parallel prefill + decode "
          f"launched moe_gemm {counts['moe_gemm']} times, not {6 * moe_layers}")
    out = dict(ep_calls=len(calls), launches={k: n for k, n in counts.items() if n},
               seconds=secs)
    for what, got, want in (("prefill last-position logits", ep[0], plain[0]),
                            ("decode logits", ep[1], plain[1])):
        check(bool(torch.isfinite(got).all()), f"{cfg.name}: non-finite {what} under EP")
        rel = row_rel_err(got, want)
        check(rel <= ROW_RTOL, f"{cfg.name}: expert-parallel {what} are {rel:.3e} of a row's "
              f"norm from the same step without the context (limit {ROW_RTOL})")
        key = what.split()[0]
        out[f"{key}_row_rel_err"] = rel
        out[f"{key}_bit_equal"] = bool(torch.equal(got, want))
    log(f"[dryrun/ep] {cfg.name} under its rules on the 1x1 mesh: {len(calls)} expert-parallel "
        f"MoE layers (prefill {b}x{prompt} + one decode step) in {secs:.2f} s, launches "
        f"{out['launches']}; against the same steps without the context: prefill row error "
        f"{out['prefill_row_rel_err']:.3e} (bit-equal {out['prefill_bit_equal']}), decode "
        f"{out['decode_row_rel_err']:.3e} (bit-equal {out['decode_bit_equal']})")
    return out


def run_dryrun(dev) -> dict:
    """Phase 12 (a) and (b): ``repro_torch.launch.dryrun`` over every arch ×
    shape on the card's 1×1 mesh, with ``run``: 32 cells traced on meta
    tensors (FLOPs and bytes > 0), 8 skipped with the reference's reasons,
    and the four decode cells that fit run once at full size, their
    allocated argument bytes equal to the count from the shapes, their
    measured step no faster than its roofline bound."""
    from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, shape_applicable
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    rows, failures = dryrun.run_all(ARCH_IDS, list(SHAPES), [("host", make_host_mesh(device=dev))],
                                    out=None, run=True, device=dev)
    secs = time.perf_counter() - t0
    check(failures == 0, f"the dry run failed {failures} cells")
    ok = [r for r in rows if r["status"] == "ok"]
    skip = [r for r in rows if r["status"] == "skip"]
    check(len(ok) == DRY_OK and len(skip) == DRY_SKIP,
          f"the dry run gave {len(ok)} ok and {len(skip)} skipped rows")
    for r in skip:
        check(r["reason"] == shape_applicable(get_config(r["arch"]), SHAPES[r["shape"]])[1],
              f"{r['arch']} x {r['shape']}: skip reason {r['reason']!r}")
    for r in ok:
        check(r["trace_flops_total"] > 0 and r["trace_bytes_total"] > 0,
              f"{r['arch']} x {r['shape']}: no FLOPs or bytes counted")
    ran = {(r["arch"], r["shape"]): r for r in ok if "run" in r}
    check(set(ran) == DRY_FITS, f"the dry run ran {sorted(ran)}, not {sorted(DRY_FITS)}")
    table = []
    for r in ok:
        row = dict(arch=r["arch"], shape=r["shape"], compute_s=r["compute_s"],
                   memory_s=r["memory_s"], dominant=r["dominant"],
                   argument_gb=r["memory_analysis"]["argument_bytes"] / 1e9, fits=r["fits"],
                   kernel_ops=r["kernel_ops"])
        run = r.get("run")
        if run:
            key = f"{r['arch']} x {r['shape']}"
            check(run["allocated_bytes"] == r["memory_analysis"]["argument_bytes"],
                  f"{key}: {run['allocated_bytes']} bytes allocated, "
                  f"{r['memory_analysis']['argument_bytes']} counted from the shapes")
            check(run["logits_finite"], f"{key}: non-finite logits")
            check(run["measured_ms"] >= 1e3 * r["bound_s"],
                  f"{key}: {run['measured_ms']:.4f} ms a step, under its roofline bound "
                  f"{1e3 * r['bound_s']:.4f} ms: the count is wrong")
            rg = r["arch"] == "recurrentgemma_2b"
            check((run["launches_per_step"].get("decode_attention", 0) > 0) == rg,
                  f"{key}: decode_attention launches per step {run['launches_per_step']}")
            row.update(measured_ms=run["measured_ms"], bound_ms=run["bound_ms"],
                       peak_gb=run["peak_bytes"] / 1e9, launches_per_step=run["launches_per_step"])
        table.append(row)
        log(f"[dryrun/table] {r['arch']:>20s} {r['shape']:<11s} compute {r['compute_s']:.6g} s "
            f"memory {r['memory_s']:.6g} s ({r['dominant']}), args "
            f"{row['argument_gb']:.3f} GB, fits {r['fits']}"
            + (f"; run {row['measured_ms']:.4f} ms/step vs bound {row['bound_ms']:.4f} ms, "
               f"peak {row['peak_gb']:.2f} GB" if run else ""))
    log(f"[dryrun] {len(ok)} cells traced, {len(skip)} skipped, {len(ran)} run, in {secs:.1f} s; "
        f"roofline constants {rows[0].get('roofline', ok[0]['roofline'])}")
    return dict(seconds=secs, table=table, skipped=[(r["arch"], r["shape"]) for r in skip])


def run_phase12(dev, drive, ep_spec=None) -> dict:
    """Phase 12's (a) and (b); with ``ep_spec`` (an ``LM_RUNS`` entry:
    ``--dryrun``) also (c), on that model's weights loaded for it after (b)."""
    import torch

    t0 = time.perf_counter()
    out, counts = drive(("decode_attention",), run_dryrun, dev)
    out["launches"] = {k: n for k, n in counts.items() if n}
    if ep_spec is not None:
        from repro_torch.models import init_params

        cfg = lm_config(ep_spec["arch"], ep_spec["context"])
        params = init_params(cfg, SEED, device=dev)
        out["expert_parallel"] = ep_steps(dev, drive, cfg, params, ep_spec)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"[dryrun] phase 12 in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# --------------------------------------------------------------------- phase 9
# The training path (repro_torch.launch.train and the model's train step).
TRAIN_BATCH, TRAIN_SEQ = 16, 256  # examples/train_lm.py's batch and length
TRAIN_SHARDS = 16
GRAD_CYCLES = 2  # (a): the first pattern cycles of each model, in float32
# (a): each parameter leaf's gradient through the kernels' Functions within
# this relative norm error of the gradient through the plain versions.
GRAD_RTOL = 1e-3
# (a)'s three models: two at full width, and the trainer's own MoE config.
GRAD_ARCHS = ("llama3_2_3b", "recurrentgemma_2b", "moonshot_v1_16b_a3b", "whisper_small")
# (a)'s Whisper-small: full width and depth (12 + 12 layers), 8 clips of
# 1,500 frames and 8 x 448 tokens (its decoder's context).
GRAD_WHISPER = (8, WH_CONTEXT, WH_FRAMES)  # batch, tokens, frames
TRAIN_MOE = ("moonshot_v1_16b_a3b", 512, 4, 32768)  # reduced_config(arch, d, layers, vocab)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_PROFILED = "llama3_2_3b", 4, 2  # (b)
RG_TRAIN_STEPS, MOE_TRAIN_STEPS = 2, 2  # (d)
XL_TRAIN_STEPS, XL_TRAIN_BATCH, WH_TRAIN_STEPS = 2, 8, 2  # (e): remat "full" (the configs')
# (c): examples/train_lm.py's arguments, cut to 30 steps with a failure.
ENTRY_ARGS = ["--arch", "llama3_2_3b", "--d-model", "640", "--layers", "10", "--vocab", "32768",
              "--batch", "16", "--seq-len", "256", "--num-shards", "16", "--num-workers", "4",
              "--hetero", "0.6", "--steps", "30", "--spl-steps", "10", "--ckpt-every", "10",
              "--fail-worker", "1", "--fail-at", "15"]
ENTRY_RESTORE_STEPS = 40  # the --restore run: one more period
LM_KERNELS = ("flash_attention", "rglru_scan", "moe_gemm")


def train_batch(cfg, dev, step: int = 0, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                frames: int = 0) -> dict:
    """``TokenPipeline``'s batch ``step`` (by default 16 x 256, the
    example's) on the card; with ``frames``, seeded frame embeddings
    ``(batch, frames, d_model)`` in the model's dtype beside it (the
    pipeline has none: an encoder-decoder model's trainer input)."""
    import torch

    from repro_torch.configs.base import torch_dtype
    from repro_torch.data import PipelineConfig, TokenPipeline

    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                        global_batch=batch,
                                        num_shards=math.gcd(batch, TRAIN_SHARDS),
                                        seed=SEED), start_step=step)
    out = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
    if frames:
        gen = torch.Generator(device=dev).manual_seed(SEED + 30 + step)
        out["encoder_embeds"] = torch.randn((batch, frames, cfg.d_model), generator=gen,
                                            device=dev).to(torch_dtype(cfg.dtype))
    return out


def leaf_names(tree, prefix: str = "") -> list[str]:
    """Leaf paths in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in leaf_names(t, f"{prefix}[{i}]")]
    return [prefix]


@contextlib.contextmanager
def routed(attention=None, scan=None, gemm=None, cross=None):
    """The model's kernel entry points swapped while active (None keeps one):
    ``transformer.attention``, ``rglru.scan_kernel``, ``moe.moe_gemm``,
    ``transformer.cross_attention``."""
    import repro_torch.models.moe as moe_mod
    import repro_torch.models.rglru as rglru_mod
    import repro_torch.models.transformer as transformer

    saved = (transformer.attention, rglru_mod.scan_kernel, moe_mod.moe_gemm,
             transformer.cross_attention)
    transformer.attention = attention or saved[0]
    rglru_mod.scan_kernel = scan or saved[1]
    moe_mod.moe_gemm = gemm or saved[2]
    transformer.cross_attention = cross or saved[3]
    try:
        yield
    finally:
        (transformer.attention, rglru_mod.scan_kernel, moe_mod.moe_gemm,
         transformer.cross_attention) = saved


def plain_versions() -> dict:
    """Every LM kernel's plain version, in the model's call signatures."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    def attention(q, k, v, *, causal=True, window=None, **_):
        return attention_ref(q, k, v, causal=causal, window=window)

    def cross(q, k, v):
        return attention_ref(q, k, v, causal=False)

    return dict(attention=attention, scan=rglru_scan_ref, gemm=moe_gemm_ref, cross=cross)


class TopkTape:
    """``torch`` for the MoE module, whose ``topk`` either records the
    experts it chooses (``replay is None``) or replays a recording: the
    routed values are gathered from the logits at the recorded indices, so
    the gates stay differentiable.  Top-k is discontinuous: at a near-tie
    a rounding difference (the kernels' summation order) picks another
    expert and moves the gradients, so a gradient comparison of MoE models
    holds the routing fixed."""

    def __init__(self):
        self.tape, self.replay = [], None

    def __getattr__(self, name):
        import torch

        return getattr(torch, name)

    def topk(self, x, k, dim=-1, **kw):
        import torch

        if self.replay is None:
            values, idx = torch.topk(x, k, dim=dim, **kw)
            self.tape.append(idx)
            return values, idx
        idx = self.replay.pop(0)
        return x.gather(dim, idx), idx


@contextlib.contextmanager
def fixed_routing(tape: TopkTape, record: bool):
    """While active, the MoE layers' top-k records into ``tape`` or replays
    it from the start."""
    import repro_torch.models.moe as moe_mod

    saved = moe_mod.torch
    tape.replay = None if record else list(tape.tape)
    moe_mod.torch = tape
    try:
        yield
    finally:
        moe_mod.torch = saved
        if not record:
            check(not tape.replay, "a replay left recorded top-k choices unused")


def loss_and_grads(cfg, params, batch) -> tuple[float, list]:
    """``Model.loss`` and the gradient of every parameter leaf (None where
    the loss does not reach the leaf)."""
    import torch

    from repro_torch.models import Model
    from repro_torch.models.common import tree_leaves, tree_unflatten

    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = Model(cfg).loss(tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    torch.cuda.synchronize()
    return float(loss.detach()), list(grads)


def grad_errors(got: list, ref: list) -> list[float]:
    """Per leaf |got - ref|_2 / |ref|_2 (1.0 for a missing gradient)."""
    out = []
    for g, r in zip(got, ref):
        if g is None or r is None:
            out.append(0.0 if g is None and r is None else 1.0)
            continue
        num = float((g.double() - r.double()).norm())
        den = float(r.double().norm())
        out.append(num / den if den > 0 else num)
    return out


def grad_config(dev, arch: str):
    """(a)'s float32 config and parameters: two cycles of ``arch`` at full
    width (no remainder blocks), Whisper-small whole, or the trainer's
    reduced MoE config."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import init_params

    if arch == TRAIN_MOE[0]:
        cfg = reduced_config(*TRAIN_MOE)
    elif arch == WH_ARCH:
        cfg = get_config(arch)  # full depth
    else:
        cfg = dataclasses.replace(get_config(arch), cycles=GRAD_CYCLES, remainder=())
    # No remat: a recompute would route the MoE layers again (see TopkTape);
    # the policies' equality is the CPU tests'.
    cfg = dataclasses.replace(cfg, dtype="float32", remat="none")
    return cfg, init_params(cfg, SEED, device=dev)


def function_checks(dev) -> dict:
    """Each Function alone on the card at a train-path shape, f32, against
    autograd of its plain version: every input's gradient within GRAD_RTOL
    (relative norm), h0 and x requiring grad too.  Planted faults: the
    scan's backward without dh0, and moe's dw of a live expert zeroed."""
    import importlib

    import torch

    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.launch.train import reduced_config
    from repro_torch.models.moe import capacity

    fa = importlib.import_module("repro_torch.kernels.flash_attention.ops")
    sc = importlib.import_module("repro_torch.kernels.rglru_scan.ops")
    mg = importlib.import_module("repro_torch.kernels.moe_gemm.ops")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).requires_grad_()

    def compare(what, fn, ref_fn, ins, fault_fn=None):
        out = fn(*ins)
        dy = torch.randn(out.shape, generator=gen, device=dev)
        got = torch.autograd.grad(out, ins, dy, allow_unused=True)
        ref = torch.autograd.grad(ref_fn(*ins), ins, dy)
        errs = grad_errors(list(got), list(ref))
        check(max(errs) <= GRAD_RTOL, f"{what}: input gradients {errs} off the plain version's "
              f"(limit {GRAD_RTOL})")
        res = {"max_rel_err": max(errs)}
        if fault_fn is not None:
            bad = grad_errors(
                list(torch.autograd.grad(fault_fn(*ins), ins, dy, allow_unused=True)), list(ref))
            check(max(bad) > GRAD_RTOL, f"{what}: the gradient check passes a planted fault "
                  f"({bad})")
            res["planted_fault_rel_err"] = max(bad)
        return res

    class DropH0(sc.RgluScanFn):
        @staticmethod
        def backward(ctx, dh):
            da, db, _ = sc.RgluScanFn.backward(ctx, dh)
            return da, db, None

    res = {}
    b, s = TRAIN_BATCH, TRAIN_SEQ
    # flash at Llama-3.2-3B's train shape; the scan at RecurrentGemma-2B's
    # (a in (0, 1), as the RG-LRU's decay); moe_gemm at the trainer's MoE
    # config's up product, with 2 of its 8 experts given no rows.
    q, k, v = rand(b, s, 24, 128), rand(b, s, 8, 128), rand(b, s, 8, 128)
    res["flash_attention"] = compare(
        "flash_attention Function", lambda *t: fa.flash_attention(*t, causal=True),
        lambda *t: attention_ref(*t, causal=True), (q, k, v))
    a = torch.rand((b, s, 2560), generator=gen, device=dev).requires_grad_()
    bb, h0 = rand(b, s, 2560), rand(b, 2560)
    res["rglru_scan"] = compare("rglru_scan Function", sc.rglru_scan, rglru_scan_ref,
                                (a, bb, h0), fault_fn=DropH0.apply)
    cfg = reduced_config(*TRAIN_MOE)
    e, rows = cfg.moe.num_experts, b * capacity(cfg, s)
    x = torch.randn((e, rows, cfg.d_model), generator=gen, device=dev)
    x[[1, 5]] = 0
    x.requires_grad_()
    w = rand(e, cfg.d_model, cfg.d_ff, scale=cfg.d_model ** -0.5)

    class ZeroLiveDw(mg.MoeGemmFn):
        @staticmethod
        def backward(ctx, dy):
            dx, dw = mg.MoeGemmFn.backward(ctx, dy)
            dw[0] = 0
            return dx, dw

    res["moe_gemm"] = compare("moe_gemm Function", mg.moe_gemm, moe_gemm_ref, (x, w),
                              fault_fn=ZeroLiveDw.apply)
    # A skipped expert's dw is exactly 0.
    dw = torch.autograd.grad(mg.moe_gemm(x, w), w, torch.ones((e, rows, cfg.d_ff), device=dev))[0]
    check(not bool(dw[[1, 5]].any()), "moe_gemm: an expert without rows got a nonzero dw")
    log(f"[train] Functions alone vs plain versions (f32, input gradients' relative norm "
        f"error): {res}")
    return res


#: What each Function's backward runs (PERF.md §6's "backward" column).
BACKWARD_RUNS = {
    "flash_attention": "the plain version (attention_ref) recomputed and differentiated",
    "rglru_scan": "one more rglru_scan launch on the reversed, shifted inputs",
    "moe_gemm": "one more moe_gemm launch for dx (w transposed), torch.bmm for dw",
}


def backward_timings(dev, reps: int = 5) -> dict:
    """Each Function's backward alone at its training shape (CUDA events,
    ``retain_graph`` so one forward serves every rep): flash in bf16 at
    Llama-3.2-3B's (16,256,24,128) / (16,256,8,128), beside SDPA's
    backward; the scan in f32 at RecurrentGemma-2B's (16,256,2560), beside
    its plain version's autograd; moe_gemm in bf16 at the trainer's MoE up
    product, beside the plain version's autograd and ``torch.bmm``'s."""
    import torch

    from repro_torch.kernels import flash_attention, moe_gemm, rglru_scan
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.launch.train import reduced_config
    from repro_torch.models.moe import capacity

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    bf16 = torch.bfloat16

    def leaf(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype).requires_grad_()

    def bwd_ms(fn, ins, n=reps):
        out = fn(*ins)
        dy = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
        return cuda_ms(lambda i: torch.autograd.grad(out, ins, dy, retain_graph=True), n)

    res = {}
    b, s = TRAIN_BATCH, TRAIN_SEQ
    q, k, v = leaf(b, s, 24, 128, dtype=bf16), leaf(b, s, 8, 128, dtype=bf16), leaf(
        b, s, 8, 128, dtype=bf16)
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    res["flash_attention"] = dict(
        shape=f"q ({b},{s},24,128) k/v ({b},{s},8,128) bf16 causal",
        ms=bwd_ms(lambda *t: flash_attention(*t, causal=True), (q, k, v)),
        plain_ms=bwd_ms(lambda *t: attention_ref(*t, causal=True), (q, k, v)),
        library_ms=bwd_ms(lambda *t: sdpa(*t, is_causal=True), (qt, kt, vt)))
    a = torch.rand((b, s, 2560), generator=gen, device=dev).requires_grad_()
    bb, h0 = leaf(b, s, 2560), torch.zeros((b, 2560), device=dev)
    res["rglru_scan"] = dict(
        shape=f"a, b ({b},{s},2560) f32", ms=bwd_ms(lambda *t: rglru_scan(*t, h0), (a, bb)),
        plain_ms=bwd_ms(lambda *t: rglru_scan_ref(*t, h0), (a, bb), 2), library_ms=None)
    cfg = reduced_config(*TRAIN_MOE)
    e, rows = cfg.moe.num_experts, b * capacity(cfg, s)
    x, w = leaf(e, rows, cfg.d_model, dtype=bf16), leaf(e, cfg.d_model, cfg.d_ff, dtype=bf16,
                                                       scale=cfg.d_model ** -0.5)
    res["moe_gemm"] = dict(
        shape=f"x ({e},{rows},{cfg.d_model}) w ({e},{cfg.d_model},{cfg.d_ff}) bf16",
        ms=bwd_ms(moe_gemm, (x, w)), plain_ms=bwd_ms(moe_gemm_ref, (x, w)),
        library_ms=bwd_ms(torch.bmm, (x, w)))
    for name, r in res.items():
        r["runs"] = BACKWARD_RUNS[name]
    log(f"[train] backward alone at the train shapes, ms (CUDA events): {res}")
    return res


#: The MoE model's conditioning probe: a relative perturbation of the plain
#: attention's output at about f32 rounding, and how far past its effect
#: on the gradients the kernels' rounding may go.
NUDGE_RTOL, NUDGE_FACTOR = 1e-6, 10.0


def nudged(attention, dev):
    """``attention`` with its output times (1 + NUDGE_RTOL * N(0, 1)), drawn
    from a fixed seed."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    def run(q, k, v, **kw):
        out = attention(q, k, v, **kw)
        return out * (1 + NUDGE_RTOL * torch.randn(out.shape, generator=gen, device=out.device))

    return run


def tied(plain, kernel):
    """``plain`` with its output values replaced by ``kernel``'s on the same
    inputs (computed without autograd) and its gradient kept: the forward
    of a kernel, the backward of the plain version."""
    import torch

    def run(q, k, v, **kw):
        ref = plain(q, k, v, **kw)
        with torch.no_grad():
            out = kernel(q, k, v, **kw)
        return ref + (out - ref).detach()

    return run


def model_grad_checks(dev) -> dict:
    """(a): per parameter leaf, the gradient of ``Model.loss`` on one
    TokenPipeline batch through the kernels' Functions against the same
    through every kernel's plain version (the MoE model: moe_gemm's, and
    the all-plain error against the model's own conditioning; see below),
    f32, within GRAD_RTOL; a planted
    fault per kernel the check must reject (today's flash wrapper without
    its Function: no gradient to wq/wk/wv; moe's dw of a live expert
    zeroed).  The scan's dh0 fault is rejected by ``function_checks``: the
    model's scans start from a constant 0.  The plain and faulty runs
    replay the Function run's expert choices (``TopkTape``).  Whisper-small
    runs whole (12 + 12 layers, 8 clips of 1,500 frames, 8 x 448 tokens);
    it is chaotic at that depth, so its plain runs take the kernel's
    forward values (``tied``) and its all-plain error is held to the
    model's own sensitivity, as the MoE model's is."""
    import importlib

    import torch

    from repro_torch.kernels import backward_launch_counts, launch_counts, reset_launch_counts

    fa = importlib.import_module("repro_torch.kernels.flash_attention.ops")
    mg = importlib.import_module("repro_torch.kernels.moe_gemm.ops")

    class ZeroLiveDw(mg.MoeGemmFn):
        @staticmethod
        def backward(ctx, dy):
            dx, dw = mg.MoeGemmFn.backward(ctx, dy)
            dw[int(dw.flatten(1).norm(dim=1).argmax())] = 0  # a live expert's
            return dx, dw

    def no_function(q, k, v, *, causal=True, window=None, **_):
        return fa._run(q, k, v, causal, window)

    no_function_anywhere = dict(attention=no_function,
                                cross=lambda q, k, v: fa._run(q, k, v, False, None))
    faults = {"llama3_2_3b": ("flash wrapper without its Function", dict(attention=no_function)),
              "moonshot_v1_16b_a3b": ("moe dw of a live expert zeroed",
                                      dict(gemm=lambda x, w: ZeroLiveDw.apply(x, w))),
              "whisper_small": ("flash wrapper without its Function", no_function_anywhere)}
    plain = plain_versions()
    res = {}
    for arch in GRAD_ARCHS:
        cfg, params = grad_config(dev, arch)
        if cfg.is_encdec:
            b, seq, frames = GRAD_WHISPER
            batch = train_batch(cfg, dev, batch=b, seq=seq, frames=frames)
        else:
            batch = train_batch(cfg, dev)
        names = leaf_names(params)
        tape = TopkTape()
        reset_launch_counts()
        with fixed_routing(tape, record=True):
            loss, got = loss_and_grads(cfg, params, batch)
        counts, back = launch_counts(), backward_launch_counts()
        swap = plain
        if cfg.moe is not None:
            # At the reference's init this model is ill-conditioned in its
            # attention (4 heads, so wq's std is 1/2 and the scores ~100):
            # its gradients move by percents under a perturbation of
            # attention's output at rounding size, with the routing held
            # fixed.  So GRAD_RTOL holds moe_gemm's Function alone
            # (attention through the flash Function in both runs), and the
            # all-plain error is held to NUDGE_FACTOR times what a
            # NUDGE_RTOL relative perturbation of the plain attention's
            # output does to the all-plain gradients, measured here.
            with routed(**plain), fixed_routing(tape, record=False):
                all_plain = loss_and_grads(cfg, params, batch)[1]
            with routed(**dict(plain, attention=nudged(plain["attention"], dev))), \
                    fixed_routing(tape, record=False):
                sensitivity = max(grad_errors(loss_and_grads(cfg, params, batch)[1],
                                              all_plain))
            out_all = max(grad_errors(got, all_plain))
            check(out_all <= NUDGE_FACTOR * sensitivity, f"{cfg.name}: gradients through every "
                  f"kernel {out_all:.3e} off the plain versions', over {NUDGE_FACTOR} x the "
                  f"model's own {sensitivity:.3e} under a {NUDGE_RTOL} nudge of attention")
            del all_plain
            swap = dict(gemm=plain["gemm"])
        elif cfg.is_encdec:
            # Whisper at full depth (12 + 12 layers) in f32 is chaotic at the
            # reference's init: the flash kernel's rounding of the forward
            # moves the gradients by O(1) (measured: the all-plain error
            # against the 1e-6 nudge's effect, both printed).  So the all-plain
            # error is held to NUDGE_FACTOR times the nudge's, and GRAD_RTOL
            # holds the Function's backward with the forward's values fixed:
            # the plain runs take the kernel's output values (a straight-
            # through tie), so only the backward differs between the runs.
            with routed(**plain):
                all_plain = loss_and_grads(cfg, params, batch)[1]
            with routed(**dict(plain, attention=nudged(plain["attention"], dev),
                               cross=nudged(plain["cross"], dev))):
                sensitivity = max(grad_errors(loss_and_grads(cfg, params, batch)[1],
                                              all_plain))
            out_all = max(grad_errors(got, all_plain))
            check(out_all <= NUDGE_FACTOR * sensitivity, f"{cfg.name}: gradients through flash "
                  f"{out_all:.3e} off the plain versions', over {NUDGE_FACTOR} x the model's own "
                  f"{sensitivity:.3e} under a {NUDGE_RTOL} nudge of attention")
            del all_plain
            swap = dict(attention=tied(plain["attention"], no_function),
                        cross=tied(plain["cross"], no_function_anywhere["cross"]))
        with routed(**swap), fixed_routing(tape, record=False):
            ref_loss, ref = loss_and_grads(cfg, params, batch)
        check(launch_counts()["moe_gemm"] == counts["moe_gemm"] or cfg.moe is None,
              f"{arch}: the plain run launched moe_gemm")
        errs = grad_errors(got, ref)
        worst = int(np.argmax(errs))
        check(errs[worst] <= GRAD_RTOL, f"{cfg.name}: gradient of {names[worst]} is "
              f"{errs[worst]:.3e} off the plain versions' (limit {GRAD_RTOL})")
        out = dict(layers=cfg.num_layers, leaves=len(names), loss=loss, plain_loss=ref_loss,
                   plain=sorted(k for k in swap), worst_leaf=names[worst],
                   worst_rel_err=errs[worst], launches={k: counts[k] for k in LM_KERNELS},
                   backward_launches={k: back[k] for k in LM_KERNELS})
        if cfg.moe is not None or cfg.is_encdec:
            out.update(all_plain_worst_rel_err=out_all, nudge_sensitivity=sensitivity)
        if arch in faults:
            what, swap = faults[arch]
            with routed(**swap), fixed_routing(tape, record=False):
                _, bad = loss_and_grads(cfg, params, batch)
            bad_errs = grad_errors(bad, ref)
            b = int(np.argmax(bad_errs))
            check(bad_errs[b] > GRAD_RTOL, f"{cfg.name}: the gradient check passes a planted "
                  f"fault ({what}): worst {bad_errs[b]:.3e}")
            out["planted_fault"] = dict(what=what, worst_leaf=names[b], rel_err=bad_errs[b])
        log(f"[train] (a) {cfg.name}, {cfg.num_layers} layers, f32, {len(names)} leaves, plain "
            f"{out['plain']}: loss {loss:.6f} (plain {ref_loss:.6f}); worst leaf {names[worst]} at "
            f"relative norm error {errs[worst]:.3e}"
            + (f" (every kernel plain: {out_all:.3e}, against {sensitivity:.3e} from a "
               f"{NUDGE_RTOL} relative nudge of the plain attention's output)"
               if cfg.moe is not None or cfg.is_encdec else "")
            + (" (plain runs tied to the kernel's forward values)" if cfg.is_encdec else "")
            + f"; launches {out['launches']} (backward {out['backward_launches']})"
            + (f"; planted fault ({out['planted_fault']['what']}) rejected: "
               f"{out['planted_fault']['worst_leaf']} at {out['planted_fault']['rel_err']:.3e}"
               if "planted_fault" in out else ""))
        res[arch] = out
        del params, got, ref
        gc.collect()
        torch.cuda.empty_cache()
    return res


def train_steps(dev, cfg, steps: int, profiled: int = 0, every_leaf: bool = False,
                batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ, frames: int = 0) -> dict:
    """``steps`` make_train_step steps of ``cfg`` (seeded random weights on
    the card, AdamW with cosine_schedule(3e-4, 20, steps), TokenPipeline
    batches of ``batch`` x ``seq``, by default 16 x 256, and ``frames``
    encoder frames a row for an encoder-decoder model), then ``profiled``
    more under torch.profiler.  Loss
    and grad norm finite, and with ``every_leaf`` every leaf changed (else
    the unchanged leaves are listed: in 2 warm-up steps at lr ≤ 4.5e-5 a
    bf16 leaf whose gradients are near AdamW's eps moves less than its
    rounding); ms per step after the first, tokens/s, busy share, peak
    memory and the LM kernels' launches per step, forward and backward
    apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import backward_launch_counts, launch_counts
    from repro_torch.models import init_params, make_train_step
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamW, cosine_schedule

    def checksums(p) -> list[int]:
        return [int(t.view(torch.int16 if t.element_size() == 2 else torch.int32)
                    .sum(dtype=torch.int64)) for t in tree_leaves(p)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, SEED, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    before = checksums(params)
    events = []

    class TimedAdamW(AdamW):
        """CUDA events around each step's optimizer (``AdamW.apply``)."""

        def apply(self, grads, state, params):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            out = super().apply(grads, state, params)
            stop.record()
            events.append((start, stop))
            return out

    opt = (TimedAdamW if dev.type == "cuda" else AdamW)(
        learning_rate=cosine_schedule(3e-4, 20, steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    batches = [train_batch(cfg, dev, i, batch, seq, frames) for i in range(steps + profiled)]
    start_counts, start_back = launch_counts(), backward_launch_counts()
    secs, losses, norms = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batches[i])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        secs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    opt_ms = [a.elapsed_time(b) for a, b in events[1:steps]]
    counts = {k: (launch_counts()[k] - start_counts[k]) / steps for k in LM_KERNELS}
    back = {k: (backward_launch_counts()[k] - start_back[k]) / steps for k in LM_KERNELS}
    check(all(math.isfinite(x) for x in losses + norms), f"{cfg.name}: non-finite loss or grad "
          f"norm {losses} {norms}")
    # Every leaf changes, but where a bf16 leaf's smallest |value| is so
    # large that no update of at most the peak learning rate survives its
    # rounding (RecurrentGemma's lam, ones, in 2 warm-up steps; the
    # reference's (p + u).astype(p.dtype) rounds alike).
    after = checksums(params)
    same = [(n, t) for n, t, b, a in zip(leaf_names(params), tree_leaves(params), before, after)
            if a == b]
    stuck = [n for n, t in same
             if not (t.dtype == torch.bfloat16 and float(t.abs().min()) * 2.0**-9 > 3e-4)]
    check(not (every_leaf and stuck), f"{cfg.name}: leaves unchanged after {steps} steps: "
          f"{stuck}")
    ms = 1e3 * float(np.median(secs[1:]))
    res = dict(layers=cfg.num_layers, params=n_params, steps=steps, first_step_s=secs[0],
               unchanged_by_rounding=[n for n, _ in same],
               ms_per_step=ms, step_ms=[1e3 * s for s in secs],
               tokens_per_s=batch * seq / (ms / 1e3),
               optimizer_ms=float(np.median(opt_ms)) if opt_ms else None, losses=losses,
               grad_norms=norms, launches_per_step={k: counts[k] - back[k] for k in LM_KERNELS},
               backward_launches_per_step=back)
    if profiled:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(steps, steps + profiled):
                params, opt_state, m = step_fn(params, opt_state, batches[i])
            torch.cuda.synchronize()
        rows = device_kernels(prof)
        busy = sum(r[0] for r in rows) / 1e6
        res.update(profiled_steps=profiled, busy_s=busy,
                   busy_share=busy / (profiled * ms / 1e3) if rows else None,
                   top=[(k, round(us / 1e3, 3), n) for us, k, n in rows[:8]])
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt_state, batches
    gc.collect()
    torch.cuda.empty_cache()
    busy = (f"; device busy {100 * res['busy_share']:.1f} % of {profiled} profiled steps"
            if res.get("busy_share") is not None else
            ("; torch.profiler recorded no device time: busy share not measured"
             if profiled else ""))
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, {n_params / 1e9:.3f} B params, "
        f"{steps} steps of {batch}x{seq}{f' over {frames} frames' if frames else ''}, remat "
        f"{cfg.remat}: first "
        f"{secs[0]:.2f} s, then {ms:.1f} ms/step = {res['tokens_per_s']:.0f} tokens/s{busy}; "
        f"AdamW.apply {res['optimizer_ms']} ms of a step (CUDA events); "
        f"peak memory {res['peak_mem_gb']:.2f} GB; losses {[round(x, 4) for x in losses]}; "
        f"unchanged leaves {res['unchanged_by_rounding']}; "
        f"launches per step forward {res['launches_per_step']}, backward {back}")
    return res


def run_entry_point(dev) -> dict:
    """(c): ``repro_torch.launch.train.main`` with examples/train_lm.py's
    arguments, cut to 30 steps with worker 1 failing at step 15, then
    ``--restore`` for one more period: at most 4 shards move a period, the
    dead worker holds none after the failure, and the restored run starts
    from the last checkpoint's step, cursor and assignment."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import main as train_main

    with tempfile.TemporaryDirectory() as tmp:
        args = ENTRY_ARGS + ["--ckpt-dir", tmp, "--device", str(dev)]
        t0 = time.perf_counter()
        run = train_main(args)
        wall = time.perf_counter() - t0
        periods = run["periods"]
        check(len(periods) == 3, f"the trainer ran {len(periods)} periods, not 3")
        for p in periods:
            check(p["moved"] <= 4, f"period at step {p['step']} moved {p['moved']} shards")
            if p["step"] > 15:
                check(1 not in p["assignment"], f"dead worker 1 holds shards after the "
                      f"failure: {p['assignment']}")
        check(all(math.isfinite(x) for x in run["losses"]), "non-finite trainer loss")
        ckpt = CheckpointManager(tmp, keep=2)
        last = ckpt.latest_step()
        check(last == 29, f"last checkpoint at step {last}, not 29")
        _, meta = ckpt.restore(last)
        t1 = time.perf_counter()
        again = train_main(args[:args.index("--steps")] + args[args.index("--steps") + 2:]
                           + ["--steps", str(ENTRY_RESTORE_STEPS), "--restore"])
        restore_wall = time.perf_counter() - t1
    check(again["start"] == meta["step"] + 1 == 30, f"restored at step {again['start']}")
    check(again["cursor_step"] == meta["cursor"]["step"] == 30,
          f"restored cursor at step {again['cursor_step']}")
    check(again["restored_assignment"] == meta["assignment"] == run["assignment"],
          "the restored assignment differs from the checkpoint's")
    check(len(again["losses"]) == ENTRY_RESTORE_STEPS - 30, "the restored run's step count")
    res = dict(wall_s=wall, restore_wall_s=restore_wall,
               periods=[{k: v for k, v in p.items() if k != "alive"} for p in periods],
               restored_from=meta["step"], restored_periods=again["periods"])
    log(f"[train] (c) entry point: 30 steps in {wall:.1f} s, moved "
        f"{[p['moved'] for p in periods]}, assignments {[p['assignment'] for p in periods]}; "
        f"--restore from step {meta['step']} ran to {ENTRY_RESTORE_STEPS} in {restore_wall:.1f} s")
    return res


def run_training(dev) -> dict:
    """(b)-(d): the training path with its launches counted."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import reduced_config

    res = {}
    res["llama_full"] = train_steps(dev, dataclasses.replace(get_config(TRAIN_ARCH),
                                                             remat="full"),
                                    TRAIN_STEPS, TRAIN_PROFILED, every_leaf=True)
    res["entry_point"] = run_entry_point(dev)
    res["recurrentgemma_full_width"] = train_steps(dev, get_config(RG_ARCH), RG_TRAIN_STEPS)
    res["moe_reduced"] = train_steps(dev, reduced_config(*TRAIN_MOE), MOE_TRAIN_STEPS)
    # Phase 9's share of phases 10 and 11: xLSTM-1.3B over two mLSTM chunks,
    # Whisper-small over 16 clips of 1,500 frames and 448-token targets.
    res["xlstm_full"] = train_steps(dev, get_config(XL_ARCH), XL_TRAIN_STEPS, every_leaf=True,
                                    batch=XL_TRAIN_BATCH, seq=2 * XL_PREFIX)
    res["whisper_full"] = train_steps(dev, get_config(WH_ARCH), WH_TRAIN_STEPS, every_leaf=True,
                                      batch=WH_BATCH, seq=WH_CONTEXT, frames=WH_FRAMES)
    return res


def run_train_phase(dev, drive) -> dict:
    """Phase 9: (a) the gradient checks (not counted as path launches),
    then (b)-(d) under ``drive``."""
    t0 = time.perf_counter()
    res = {"functions": function_checks(dev), "grads": model_grad_checks(dev),
           "backward": backward_timings(dev)}
    t1 = time.perf_counter()
    from repro_torch.kernels import backward_launch_counts

    train, counts = drive(LM_KERNELS, run_training, dev)
    res.update(train)
    res["launches"] = {k: counts[k] for k in LM_KERNELS}
    res["backward_launches"] = backward_launch_counts()
    res["grad_check_s"], res["train_s"] = t1 - t0, time.perf_counter() - t1
    log(f"[train] phase 9: gradient checks {res['grad_check_s']:.1f} s, training "
        f"{res['train_s']:.1f} s; launches {res['launches']}")
    return res


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

    def stamp(what: str) -> None:
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")

    if sys.argv[1:2] == ["--dryrun"]:
        # Phase 12 alone, (c) on Moonlight's weights loaded for it.
        try:
            t0 = time.perf_counter()
            log(f"[build] {_build.build()} in {time.perf_counter() - t0:.2f} s wall")
            dry = run_phase12(dev, drive, next(s for s in LM_RUNS if s.get("expert_parallel")))
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"card": card, "dryrun": dry}, default=str))
        return 0
    if sys.argv[1:2] == ["--train"]:
        # Phase 9 alone.
        try:
            t0 = time.perf_counter()
            log(f"[build] {_build.build()} in {time.perf_counter() - t0:.2f} s wall")
            train = run_train_phase(dev, drive)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"card": card, "train": train}, default=str))
        return 0
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
        flash_cases += [flash_timed_case(dev, what, WH_BATCH, s_len, 12, 12, 64, None,
                                         SEED + 4 + i, fault=True, t=t_len, causal=causal)
                        for i, (what, s_len, t_len, causal) in enumerate(WHISPER_FLASH)]
        kernels.update(scan_and_expert_kernel_checks(dev))
        gc.collect()
        torch.cuda.empty_cache()
        stamp("phases 1-2")

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
        stamp("phases 3, 3j and 4")
        gc.collect()
        real_jobs, counts = drive(routing, run_real_jobs, dev)
        real_jobs["launches"] = {name: counts[name] for name in routing}
        log(f"[realjobs] phase 3r routing launches {real_jobs['launches']}")
        stamp("phase 3r")
        gc.collect()
        skew, counts = drive(routing, run_skew, dev)
        skew["launches"] = {name: counts[name] for name in routing}
        log(f"[skew] phase 4s routing launches {skew['launches']}")
        stamp("phase 4s")
        gc.collect()
        torch.cuda.empty_cache()
        superstep, counts = drive(routing, run_superstep, dev, card)
        superstep["launches"] = {name: counts[name] for name in routing}
        log(f"[engine/superstep] phase 3s routing launches (wrapper counts: eager launches "
            f"and kernels recorded into graphs) {superstep['launches']}; replays of the "
            f"device-routed scan {superstep['device']['replays']} x "
            f"{superstep['device']['graph_launches']}")
        stamp("phase 3s")
        gc.collect()
        torch.cuda.empty_cache()
        # Phase 3w in a fresh interpreter (this one holds a CUDA context,
        # and the multi-worker coordinator forks): launches are the
        # workers', folded by their coordinators.
        workers = run_workers()
        for name in routing:
            check(workers["launches"][name] > 0, f"kernel {name} was not launched by a worker")
            launches[name] += workers["launches"][name]
        stamp("phase 3w")

        lm, served = {}, {}
        for spec in LM_RUNS:
            lm[spec["arch"]], served[spec["arch"]] = run_lm(dev, drive, spec)
            stamp(f"LM phases of {spec['arch']}")
        train = run_train_phase(dev, drive)
        stamp("phase 9")
        gc.collect()
        torch.cuda.empty_cache()
        dry = run_phase12(dev, drive)
        dry["expert_parallel"] = lm[MOE_ARCH]["expert_parallel"]
        stamp("phase 12")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[summary] engine {engine}; controller {controller}; real jobs {real_jobs}; "
        f"skew {skew}; superstep {superstep}; workers {workers}; "
        f"lm {lm}; serve {served}; train {train}; dry run {dry}; "
        f"{time.perf_counter() - t_start:.1f} s total")
    for name in LM_KERNELS:
        kernels[name]["train_launches"] = dict(total=train["launches"][name],
                                               backward=train["backward_launches"][name])
        kernels[name]["backward"] = train["backward"][name]
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
