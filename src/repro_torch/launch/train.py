"""End-to-end training driver with integrative reconfiguration, the port of
``repro.launch.train``.

Trains a real model (a reduced config of the chosen family) while the
paper's controller manages the *data plane*:

* the global batch is split into **shards** (= key groups, repro_torch.core);
* **workers** process shards; per-shard step times are measured (real
  compute, one ``make_train_step`` call on the card) and scaled by
  per-worker capacity factors (heterogeneity / degradation injection for
  testing — on real clusters this is just the measured time);
* every SPL the controller folds shard loads into a ClusterState and runs
  Algorithm 1: the MILP reassigns shards to workers under a migration budget
  (shard reassignment = repartitioning the input stream; cost = data-cursor
  handoff, small) — straggler mitigation as load balancing;
* checkpoints carry params, optimizer state, data cursor AND the shard
  assignment, so a restart resumes the balanced configuration;
* worker failure ⇒ its shards are orphaned and the next adaptation
  reallocates them (scale-in with kill=1 semantics).

The CLI, the controller, the printed lines and the checkpoints are the
reference's; ``--device`` (default ``cuda``; no fallback) is the port's.
Every family trains but the encoder-decoder one (``--arch whisper_small``):
the token pipeline yields no ``encoder_embeds``, so its first step raises,
where the reference's fails.  An xLSTM run's ``--seq-len`` must be a whole
number of 256-token mLSTM chunks once it is longer than one (the default
256 is one chunk).
On the card the attention, RG-LRU and expert products run the hand-written
kernels forward and backward (their autograd Functions).  :func:`main`
returns what it did (the start step, each period's line and assignment,
each step's loss), for callers that check it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_3b \
        --steps 200 --d-model 512 --layers 8 [--restore] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import canon, get_config
from repro_torch.core import AdaptationFramework, ClusterState, NullScaler
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import init_params, make_train_step
from repro_torch.models.common import tree_map
from repro_torch.optim import AdamW, AdamWState, cosine_schedule


def reduced_config(arch: str, d_model: int, layers: int, vocab: int):
    """~100M-class config of the same family as `arch`."""
    cfg = get_config(arch, smoke=True)
    heads = max(cfg.num_heads, 4)
    kv = max(cfg.num_kv_heads, 2)
    pattern_cycles = max(layers // max(len(cfg.pattern), 1), 1)
    return dataclasses.replace(
        cfg,
        name=f"{cfg.name}-train",
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=0 if cfg.d_ff == 0 else d_model * 4,
        vocab_size=vocab,
        cycles=pattern_cycles,
        lru_width=d_model if cfg.lru_width else None,
        max_seq_len=4096,
    )


@dataclasses.dataclass
class Worker:
    wid: int
    capacity: float = 1.0
    alive: bool = True


def _to_device(tree, dev: torch.device):
    """A restored (params, AdamWState) part onto the device."""
    if isinstance(tree, AdamWState):
        return AdamWState(step=tree.step.to(dev), m=_to_device(tree.m, dev),
                          v=_to_device(tree.v, dev))
    return tree_map(lambda t: t.to(dev), tree)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32_768)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--num-shards", type=int, default=16)
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument(
        "--spl-steps",
        type=int,
        default=10,
        help="steps per adaptation period",
    )
    ap.add_argument(
        "--hetero",
        type=float,
        default=0.5,
        help="capacity spread (0=homog)",
    )
    ap.add_argument(
        "--fail-worker",
        type=int,
        default=-1,
        help="worker to kill mid-run",
    )
    ap.add_argument("--fail-at", type=int, default=-1, help="step to kill it at")
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced_config(canon(args.arch), args.d_model, args.layers, args.vocab)
    print(f"[train] {cfg.name}: ~{cfg.param_count()/1e6:.1f}M params")

    opt = AdamW(learning_rate=cosine_schedule(args.lr, 20, args.steps))
    step_fn = make_train_step(cfg, opt)

    pipe = TokenPipeline(
        PipelineConfig(
            vocab_size=cfg.vocab_size,
            seq_len=args.seq_len,
            global_batch=args.batch,
            num_shards=args.num_shards,
            seed=args.seed,
        )
    )
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    rng = np.random.default_rng(args.seed)
    workers = [
        Worker(w, capacity=float(1.0 + args.hetero * rng.uniform(-0.6, 1.0)))
        for w in range(args.num_workers)
    ]
    # Initial shard→worker assignment: round robin.
    assignment = np.arange(args.num_shards) % args.num_workers

    start = 0
    params = opt_state = None
    if args.restore and ckpt.latest_step() is not None:
        (params, opt_state), meta = ckpt.restore()
        params, opt_state = _to_device(params, dev), _to_device(opt_state, dev)
        pipe.restore(meta["cursor"])
        assignment = np.asarray(meta["assignment"])
        start = meta["step"] + 1
        print(f"[train] restored from step {meta['step']}")
    if params is None:
        params = init_params(cfg, args.seed, device=dev)
        opt_state = opt.init(params)

    framework = AdaptationFramework(
        scaler=NullScaler(), mode="milp", max_migrations=4, time_limit=2.0
    )
    shard_seconds = np.zeros(args.num_shards)
    period_losses: list[float] = []
    done = {"start": start, "cursor_step": pipe.step,
            "restored_assignment": assignment.tolist(), "losses": [], "periods": []}
    t_run = time.perf_counter()

    for step in range(start, args.steps):
        batch_np = pipe.next_batch()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        if cfg.is_encdec:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder model and the token pipeline yields no "
                "encoder_embeds (tokens and labels only); the reference's trainer fails at "
                "this step too (its forward asserts them)"
            )

        # Real compute, measured per shard (shards are batch slices).
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_time = time.perf_counter() - t0
        period_losses.append(loss)
        done["losses"].append(loss)

        # Attribute time to shards ∝ tokens; worker wall time = Σ its shards
        # scaled by 1/capacity (heterogeneity model).
        per_shard_t = step_time / args.num_shards
        for s in range(args.num_shards):
            w = workers[int(assignment[s])]
            shard_seconds[s] += per_shard_t / max(w.capacity, 1e-6)

        # Failure injection.
        if step == args.fail_at and 0 <= args.fail_worker < len(workers):
            workers[args.fail_worker].alive = False
            print(f"[train] step {step}: worker {args.fail_worker} FAILED")

        # Adaptation period: rebalance shards with the MILP.
        if (step + 1) % args.spl_steps == 0:
            total = shard_seconds.sum()
            g_load = 100.0 * shard_seconds / max(total, 1e-9)
            state = ClusterState.create(
                num_nodes=len(workers),
                kg_operator=np.zeros(args.num_shards, dtype=np.int64),
                kg_load=g_load,
                alloc=assignment.copy(),
                kg_state_bytes=np.full(args.num_shards, 1.0),
                capacity=np.array([w.capacity for w in workers]),
                downstream={0: []},
            )
            state.alive = np.array([w.alive for w in workers])
            state.kill = ~state.alive  # dead workers drain immediately
            result = framework.adapt(state)
            moved = result.migration_plan.num_migrations
            assignment = result.state.alloc.copy()
            # Makespan = the busiest worker's period time.
            per_worker = np.zeros(len(workers))
            np.add.at(per_worker, assignment, shard_seconds)
            makespan = per_worker.max()
            tok_s = args.batch * args.seq_len * args.spl_steps / (time.perf_counter() - t_run)
            print(
                f"[train] step {step+1:4d} loss={np.mean(period_losses):.4f} "
                f"LD={result.plan.load_distance:6.2f} moved={moved} "
                f"makespan={makespan:.2f}s tok/s={tok_s:,.0f}"
            )
            done["periods"].append(dict(
                step=step + 1, loss=float(np.mean(period_losses)),
                load_distance=float(result.plan.load_distance), moved=int(moved),
                makespan=float(makespan), tokens_per_s=tok_s, assignment=assignment.tolist(),
                alive=[w.alive for w in workers]))
            shard_seconds[:] = 0
            period_losses.clear()
            t_run = time.perf_counter()

        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            ckpt.save_async(
                step,
                (params, opt_state),
                metadata={
                    "cursor": {k: np.asarray(v).tolist() if hasattr(v, "tolist") else v
                               for k, v in pipe.cursor().items()},
                    "assignment": assignment.tolist(),
                    "step": step,
                },
            )
    ckpt.wait()
    print("[train] done")
    done["assignment"] = assignment.tolist()
    done["params"], done["opt_state"] = params, opt_state
    return done


if __name__ == "__main__":
    main()
