"""Serving: continuous batching decode with integrative reconfiguration.

Sequences are the key groups: each active request owns KV-cache state on its
worker (decode replica).  The controller runs Algorithm 1 every SPL:

* per-sequence load = decode cost share over the period (real measured step
  times, scaled by worker capacity);
* the MILP rebalances sequences across workers under a migration budget where
  mc_k = the sequence's KV-cache bytes — migrating a sequence physically
  moves its cache rows between worker batches (direct state migration);
* horizontal scaling: the utilization scaler adds/retires decode workers with
  queue depth; retired workers drain via the MILP (Lemmas 1–2).

Real model decode runs per worker per tick via ``make_serve_step``, on the
card through the flash-decode kernel (and, for MoE configs, the grouped
expert matmul).  :func:`serve_loop` takes the config,
parameters and settings, so a caller can run it at full width; ``main()``
serves the reduced (SMOKE) config as the reference's ``main()`` does.

A migration moves the sequence's own rows: along the **batch** axis, which
is axis 1 of the stacked ``scan`` cache leaves ``(cycles, batch, cap, KV,
hd)`` (an xLSTM block's ``C``, ``n``, ``m`` and ``c``, ``n``, ``h``, ``m``
too) and of an encoder-decoder's ``cross`` leaves, and axis 0 of the
``rem`` leaves, whatever their rank (a LOCAL_ATTN ring, an RG-LRU block's
``h`` and ``conv``).  (The reference's ``extract`` / ``install`` slice
axis 0 of the stacked leaves, the layer axis; the port does what the
reference's docstring says instead.)

A worker's cache is ``init_cache(cfg, slots, cfg.max_seq_len)``, as the
reference builds it: an encoder-decoder model (Whisper) is served against
an empty encoder (``enc_len`` 0), so its cross sublayers add exactly 0 and
launch nothing (ROADMAP queue 3 item 2).

Usage (any arch: glm4_9b, recurrentgemma_2b, moonshot_v1_16b_a3b,
xlstm_1_3b, whisper_small, ...):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4_9b --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, canon, get_config
from repro_torch.core import AdaptationFramework, ClusterState, UtilizationScaler
from repro_torch.device import resolve_device
from repro_torch.models import init_params, make_serve_step
from repro_torch.models.kvcache import init_cache


@dataclasses.dataclass
class Sequence:
    sid: int
    prompt_len: int
    target_len: int
    generated: int = 0
    worker: int = 0


def slot_rows(cache: dict, slot: int) -> dict:
    """A copy of one slot's rows of every cache leaf (batch axis)."""
    rows = {
        "scan": [{n: a[:, slot : slot + 1].clone() for n, a in e.items()} for e in cache["scan"]],
        "rem": [{n: a[slot : slot + 1].clone() for n, a in e.items()} for e in cache["rem"]],
    }
    if "cross" in cache:
        rows["cross"] = {n: a[:, slot : slot + 1].clone() for n, a in cache["cross"].items()}
    return rows


def put_slot_rows(cache: dict, slot: int, rows: dict) -> None:
    """Write ``rows`` (from :func:`slot_rows`) into one slot, in place."""
    for e, r in zip(cache["scan"] + [cache.get("cross", {})],
                    rows["scan"] + [rows.get("cross", {})]):
        for n, a in e.items():
            a[:, slot : slot + 1].copy_(r[n])
    for e, r in zip(cache["rem"], rows["rem"]):
        for n, a in e.items():
            a[slot : slot + 1].copy_(r[n])


class DecodeWorker:
    """One decode replica: a fixed-capacity batch of sequence slots."""

    def __init__(self, wid: int, cfg, params, slots: int, capacity: float = 1.0, *,
                 device="cuda"):
        self.wid = wid
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.capacity = capacity
        self.device = resolve_device(device)
        self.cache = init_cache(cfg, slots, cfg.max_seq_len, device=self.device)
        self.positions = np.zeros(slots, dtype=np.int32)
        self.tokens = np.zeros((slots, 1), dtype=np.int32)
        self.occupant: list[int | None] = [None] * slots
        self.alive = True
        self.step = make_serve_step(cfg)

    def free_slots(self) -> list[int]:
        return [i for i, o in enumerate(self.occupant) if o is None]

    def active(self) -> list[int]:
        return [i for i, o in enumerate(self.occupant) if o is not None]

    def decode_tick(self) -> tuple[int, float]:
        """Decode one token for every active slot.  Returns (tokens, secs)."""
        act = self.active()
        if not act:
            return 0, 0.0
        t0 = time.perf_counter()
        logits, self.cache = self.step(
            self.params,
            self.cache,
            torch.from_numpy(self.tokens).to(self.device, torch.int64),
            torch.from_numpy(self.positions).to(self.device, torch.int64),
        )
        tok = logits[:, 0, :].argmax(-1).to(torch.int32).cpu().numpy()
        dt = (time.perf_counter() - t0) / max(self.capacity, 1e-6)
        for i in act:
            self.tokens[i, 0] = tok[i]
            self.positions[i] += 1
        return len(act), dt

    # -- direct state migration of one slot's KV cache -----------------------
    def extract(self, slot: int) -> dict:
        return {
            "cache": slot_rows(self.cache, slot),
            "pos": int(self.positions[slot]),
            "tok": int(self.tokens[slot, 0]),
        }

    def install(self, slot: int, blob: dict, sid: int) -> None:
        put_slot_rows(self.cache, slot, blob["cache"])
        self.positions[slot] = blob["pos"]
        self.tokens[slot, 0] = blob["tok"]
        self.occupant[slot] = sid

    def evict(self, slot: int) -> None:
        self.occupant[slot] = None


@dataclasses.dataclass
class ServeStats:
    """What a serve run did: completions, latency (ticks) and decode work."""

    ticks: int
    completed: int
    latencies: list[int]
    migrations: int
    decode_tokens: int
    decode_seconds: float  # wall time of the workers' decode ticks
    max_workers: int

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.latencies, q)) if self.latencies else float("nan")


def serve_loop(
    cfg: ModelConfig,
    params: dict,
    *,
    ticks: int = 120,
    workers: int = 3,
    slots: int = 8,
    arrival_rate: float = 1.2,
    spl_ticks: int = 15,
    max_migrations: int = 2,
    hetero: float = 0.4,
    seed: int = 0,
    device="cuda",
    worker_cls: type = DecodeWorker,
    log: Optional[Callable[[str], None]] = print,
) -> ServeStats:
    """Serve Poisson arrivals on ``workers`` decode replicas for ``ticks``
    ticks, adapting every ``spl_ticks`` (the reference's loop)."""
    dev = resolve_device(device)
    log = log or (lambda _msg: None)
    rng = np.random.default_rng(seed)
    pool = [
        worker_cls(
            w, cfg, params, slots,
            capacity=float(1.0 + hetero * rng.uniform(-0.5, 1.0)), device=dev,
        )
        for w in range(workers)
    ]
    framework = AdaptationFramework(
        scaler=UtilizationScaler(high_wm=85.0, low_wm=25.0, target=60.0, max_step=1),
        mode="milp",
        max_migrations=max_migrations,
        time_limit=2.0,
    )

    sequences: dict[int, Sequence] = {}
    queue: list[Sequence] = []
    next_sid = 0
    done = 0
    latencies: list[int] = []
    seq_seconds: dict[int, float] = {}
    tick_of_arrival: dict[int, int] = {}
    migrations = decode_tokens = 0
    decode_seconds = 0.0

    for tick in range(ticks):
        # Arrivals.
        for _ in range(rng.poisson(arrival_rate)):
            seq = Sequence(
                next_sid,
                prompt_len=int(rng.integers(8, 32)),
                target_len=int(rng.integers(16, 64)),
            )
            queue.append(seq)
            tick_of_arrival[seq.sid] = tick
            next_sid += 1

        # Admission: fill free slots (prefill modeled as cache init).
        for w in pool:
            if not w.alive:
                continue
            for slot in w.free_slots():
                if not queue:
                    break
                seq = queue.pop(0)
                seq.worker = w.wid
                w.occupant[slot] = seq.sid
                w.positions[slot] = seq.prompt_len
                w.tokens[slot, 0] = 1
                sequences[seq.sid] = seq
                seq_seconds[seq.sid] = 0.0

        # Decode one token everywhere (real model step).
        for w in pool:
            if not w.alive:
                continue
            t0 = time.perf_counter()
            n, dt = w.decode_tick()
            decode_seconds += time.perf_counter() - t0
            decode_tokens += n
            act = w.active()
            for slot in act:
                sid = w.occupant[slot]
                seq_seconds[sid] += dt / max(len(act), 1)
                sequences[sid].generated += 1
                if sequences[sid].generated >= sequences[sid].target_len:
                    latencies.append(tick - tick_of_arrival[sid])
                    w.evict(slot)
                    done += 1

        # Adaptation period.
        if (tick + 1) % spl_ticks == 0:
            active_sids = sorted(sid for w in pool for sid in w.occupant if sid is not None)
            if active_sids:
                total = sum(seq_seconds.get(s, 0.0) for s in active_sids) or 1e-9
                g_load = np.array(
                    [100.0 * seq_seconds.get(s, 0.0) / total for s in active_sids]
                )
                alloc = np.array([sequences[s].worker for s in active_sids])
                kv_bytes = np.array(
                    [
                        float(sequences[s].prompt_len + sequences[s].generated)
                        for s in active_sids
                    ]
                )
                state = ClusterState.create(
                    num_nodes=len(pool),
                    kg_operator=np.zeros(len(active_sids), dtype=np.int64),
                    kg_load=g_load,
                    alloc=alloc,
                    kg_state_bytes=kv_bytes,
                    capacity=np.array([w.capacity for w in pool]),
                    downstream={0: []},
                )
                state.alive = np.array([w.alive for w in pool])
                result = framework.adapt(state)
                # Elastic scale-out: provision new decode workers.
                for _ in range(result.scaling.add_nodes):
                    pool.append(worker_cls(len(pool), cfg, params, slots, device=dev))
                # Apply migrations: move each sequence's KV rows between workers.
                applied = 0
                for m in result.migration_plan.moves:
                    sid = active_sids[m.keygroup]
                    src, dst = pool[m.src], pool[m.dst]
                    if not dst.alive or not dst.free_slots():
                        continue
                    src_slot = src.occupant.index(sid)
                    blob = src.extract(src_slot)
                    src.evict(src_slot)
                    dst.install(dst.free_slots()[0], blob, sid)
                    sequences[sid].worker = m.dst
                    applied += 1
                migrations += applied
                util = [100.0 * len(w.active()) / w.slots for w in pool if w.alive]
                lat = np.percentile(latencies, 99) if latencies else 0.0
                log(
                    f"[serve] tick {tick+1:4d} active={len(active_sids):3d} "
                    f"queued={len(queue):3d} done={done:4d} "
                    f"LD={result.plan.load_distance:6.2f} migrated={applied} "
                    f"util={[f'{u:.0f}' for u in util]} p99_lat={lat:.1f} ticks"
                )
                seq_seconds = {k: 0.0 for k in seq_seconds}

    stats = ServeStats(
        ticks=ticks,
        completed=done,
        latencies=latencies,
        migrations=migrations,
        decode_tokens=decode_tokens,
        decode_seconds=decode_seconds,
        max_workers=len(pool),
    )
    log(
        f"[serve] done: {done} completed, p50={stats.percentile(50):.1f} "
        f"p99={stats.percentile(99):.1f} ticks"
    )
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4_9b")
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--arrival-rate", type=float, default=1.2, help="req/tick")
    ap.add_argument("--spl-ticks", type=int, default=15)
    ap.add_argument("--max-migrations", type=int, default=2)
    ap.add_argument("--hetero", type=float, default=0.4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(canon(args.arch), smoke=True)
    params = init_params(cfg, args.seed, device=args.device)
    serve_loop(
        cfg,
        params,
        ticks=args.ticks,
        workers=args.workers,
        slots=args.slots,
        arrival_rate=args.arrival_rate,
        spl_ticks=args.spl_ticks,
        max_migrations=args.max_migrations,
        hetero=args.hetero,
        seed=args.seed,
        device=args.device,
    )


if __name__ == "__main__":
    main()
