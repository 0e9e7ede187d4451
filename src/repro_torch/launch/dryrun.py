"""Dry run: trace every (arch × shape) cell and report its roofline terms.

The port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each cell for a 256- or 512-chip mesh of placeholder host
devices, the port runs on the devices that are present: the default mesh
is the 1×1 host mesh (one H100, or the host with ``--device cpu``), and
``--mesh single``/``multi`` raise through
:func:`repro_torch.launch.mesh.make_production_mesh` unless 256/512
devices are present.  Each cell's step (train, prefill or decode) is
traced on meta tensors at the config's full size under
:class:`repro_torch.launch.roofline.OpCounter`; its arguments are counted
from their shapes.  With ``--run``, a decode cell whose arguments and
outputs fit the device also runs once at full size (seeded parameters,
zero caches, every sequence at position ``seq_len - 1``, so the kernels
read the whole cache the trace counted) and records its measured time,
peak memory and kernel launches.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells, on the card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu    # traced only
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --smoke --run \\
        --arch xlstm_1_3b --shape decode_32k --out build/dryrun_smoke.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
import traceback
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    canon,
    get_config,
    input_specs,
    shape_applicable,
)
from repro_torch.launch import roofline
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import init_params, make_prefill_step, make_serve_step, make_train_step
from repro_torch.models.common import activation_rules, tree_leaves
from repro_torch.models.kvcache import init_cache
from repro_torch.optim import AdamW

RESULTS_PATH = "experiments/dryrun_results_torch.json"


@dataclasses.dataclass
class Lowered:
    """One traced cell: its config and shape, the counted ops, the meta
    arguments and outputs of the step, and their per-device bytes."""

    cfg: Any
    shape: Any
    chips: int
    counts: roofline.OpCounts
    argument_bytes: int
    output_bytes: int
    trace_s: float


def _tree_bytes(tree, shardings=None) -> int:
    leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    if shardings is None:
        return sum(t.numel() * t.element_size() for t in leaves)
    return sum(s.device_bytes(t) for t, s in zip(leaves, tree_leaves(shardings)))


def lower_cell(
    arch: str,
    shape_name: str,
    mesh,
    mesh_name: str,
    *,
    cfg=None,
    rules_fn: Optional[Callable] = None,
    remat: Optional[str] = None,
    smoke: bool = False,
) -> Lowered:
    """Trace one cell's step on meta tensors under the op counter.  ``cfg``
    and ``rules_fn`` (default :func:`sharding.rules_for`) override the
    registry's config and rules (perf_iter's variants)."""
    cfg = cfg or get_config(arch, smoke=smoke)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = SHAPES[shape_name]
    rules = (rules_fn or shd.rules_for)(cfg, shape, mesh)
    params = shd.param_shapes(cfg)
    p_shard = shd.param_shardings(cfg, mesh, rules)
    batch = input_specs(cfg, shape)
    b_shard = shd.batch_shardings(cfg, shape, mesh, rules)
    t0 = time.perf_counter()
    with activation_rules(rules, mesh=mesh):
        if shape.kind == "train":
            opt = AdamW(learning_rate=1e-4)
            opt_state = shd.opt_shapes(cfg, opt)
            o_shard = shd.opt_shardings(cfg, mesh, rules)
            args_bytes = (_tree_bytes(params, p_shard)
                          + _tree_bytes([opt_state.step, opt_state.m, opt_state.v],
                                        [o_shard.step, o_shard.m, o_shard.v])
                          + _tree_bytes(batch, b_shard))
            out, counts = roofline.count_ops(make_train_step(cfg, opt), params, opt_state, batch)
            new_params, new_state, metrics = out
            out_bytes = (_tree_bytes(new_params, p_shard)
                         + _tree_bytes([new_state.step, new_state.m, new_state.v],
                                       [o_shard.step, o_shard.m, o_shard.v])
                         + _tree_bytes(metrics))
        elif shape.kind == "prefill":
            args_bytes = _tree_bytes(params, p_shard) + _tree_bytes(batch, b_shard)
            out, counts = roofline.count_ops(make_prefill_step(cfg), params, batch)
            logits, cache = out
            out_bytes = _tree_bytes(logits) + _tree_bytes(cache)
        else:  # decode
            cache = shd.cache_shapes(cfg, shape)
            c_shard = shd.cache_shardings(cfg, shape, mesh, rules)
            args_bytes = (_tree_bytes(params, p_shard) + _tree_bytes(cache, c_shard)
                          + _tree_bytes(batch, b_shard))
            out, counts = roofline.count_ops(
                make_serve_step(cfg), params, cache, batch["tokens"], batch["positions"]
            )
            logits, cache = out
            out_bytes = _tree_bytes(logits) + _tree_bytes(cache, c_shard)
    return Lowered(cfg, shape, mesh.size, counts, args_bytes, out_bytes,
                   time.perf_counter() - t0)


def fits(lowered: Lowered) -> bool:
    """A decode cell whose arguments and logits fit one device's memory.
    (Train and prefill cells move 2^20 tokens a step; their activations are
    not estimated, and they are not run.)"""
    if lowered.shape.kind != "decode":
        return False
    cfg, shape = lowered.cfg, lowered.shape
    logits = shape.global_batch * cfg.vocab_size * 4
    return lowered.argument_bytes + logits <= roofline.HBM_CAPACITY


def run_decode(cfg, shape, device, *, seed: int = 0, steps: int = 5) -> dict:
    """One decode cell at full size on ``device``: seeded parameters, zero
    caches, every row at position ``seq_len - 1``; a warm-up step, then
    ``steps`` timed steps (CUDA events on the card).  Returns the bytes
    allocated for the arguments, the median ms per step, the peak device
    memory and each kernel's launches per step."""
    from repro_torch import kernels

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    b = shape.global_batch
    params = init_params(cfg, seed, device=dev)
    enc_len = shape.seq_len if cfg.is_encdec else 0
    cache = init_cache(cfg, b, shape.seq_len, enc_len, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device=dev,
                           dtype=torch.int32)
    positions = torch.full((b,), shape.seq_len - 1, dtype=torch.int32, device=dev)
    allocated = _tree_bytes(params) + _tree_bytes(cache) + _tree_bytes([tokens, positions])
    step = make_serve_step(cfg)
    with torch.inference_mode():
        logits, _ = step(params, cache, tokens, positions)  # warm-up (kernel builds)
        finite = bool(torch.isfinite(logits).all())
        before = kernels.launch_counts()
        times = []
        for _ in range(steps):
            if cuda:
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                step(params, cache, tokens, positions)
                stop.record()
                torch.cuda.synchronize(dev)
                times.append(start.elapsed_time(stop))
            else:
                t0 = time.perf_counter()
                step(params, cache, tokens, positions)
                times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: (n - before[k]) / steps for k, n in kernels.launch_counts().items()
                if n != before[k]}
    out = dict(
        allocated_bytes=allocated,
        measured_ms=statistics.median(times),
        step_ms=times,
        peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None,
        launches_per_step=launches,
        logits_shape=list(logits.shape),
        logits_finite=finite,
        timing="cuda events" if cuda else "host perf_counter",
    )
    del params, cache, logits
    if cuda:
        torch.cuda.empty_cache()
    return out


def run_cell(
    arch: str,
    shape_name: str,
    mesh,
    mesh_name: str,
    *,
    remat=None,
    run: bool = False,
    device: str = "cuda",
    smoke: bool = False,
    seed: int = 0,
) -> dict:
    low = lower_cell(arch, shape_name, mesh, mesh_name, remat=remat, smoke=smoke)
    report = roofline.build_report(
        arch=arch,
        shape=low.shape,
        cfg=low.cfg,
        mesh_name=mesh_name,
        chips=low.chips,
        counts=low.counts,
        memory_bytes=float(low.argument_bytes + low.output_bytes),
    )
    row = report.row()
    row.update(
        {
            "status": "ok",
            "trace_s": round(low.trace_s, 2),
            "trace_bytes_total": report.trace_bytes_per_device * report.chips,
            "bound_s": report.bound_s,
            "kernel_ops": low.counts.kernel_ops(),
            "fits": fits(low),
            "memory_analysis": {
                "argument_bytes": low.argument_bytes,
                "output_bytes": low.output_bytes,
            },
            "roofline": {
                "peak_flops": roofline.PEAK_FLOPS,
                "hbm_bw": roofline.HBM_BW,
                "constants_of": "H100 SXM (data sheet)",
                "card": roofline.card(),
            },
        }
    )
    if smoke:
        row["smoke"] = True
    print(
        f"[dryrun] {arch:>22s} × {shape_name:<12s} × {mesh_name:<6s} OK  "
        f"compute={report.compute_s:.6f}s memory={report.memory_s:.6f}s "
        f"dominant={report.dominant} useful={report.useful_flops_ratio:.2f} "
        f"args={low.argument_bytes / 1e9:.3f}GB fits={row['fits']} (trace {low.trace_s:.1f}s)",
        flush=True,
    )
    if run and row["fits"]:
        got = run_decode(low.cfg, low.shape, device, seed=seed)
        got["bound_ms"] = 1e3 * report.bound_s
        got["measured_over_bound"] = got["measured_ms"] / got["bound_ms"]
        row["run"] = got
        print(f"  run: {got['measured_ms']:.4f} ms/step (bound {got['bound_ms']:.4f} ms), "
              f"peak {got['peak_bytes']}, launches/step {got['launches_per_step']}", flush=True)
    return row


def run_all(
    archs, shapes, meshes, *, out: Optional[str], remat=None, run=False, device="cuda",
    smoke=False, seed=0,
) -> tuple[list[dict], int]:
    """Every (arch × shape × mesh) cell, merged into ``out``'s rows (cells
    already ``ok`` there are kept, not traced again).  Returns (rows,
    failures)."""
    results: list[dict] = []
    if out and os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if r.get("status") == "ok"}
    failures = 0
    for arch in archs:
        cfg = get_config(arch, smoke=smoke)
        for shape_name in shapes:
            ok, reason = shape_applicable(cfg, SHAPES[shape_name])
            if not ok:
                print(f"[dryrun] {arch} × {shape_name}: SKIP ({reason})", flush=True)
                results = [
                    r for r in results if not (r["arch"] == arch and r["shape"] == shape_name)
                ] + [{"arch": arch, "shape": shape_name, "mesh": "-", "status": "skip",
                      "reason": reason}]
                continue
            for mesh_name, mesh in meshes:
                if (arch, shape_name, mesh_name) in done:
                    continue
                try:
                    row = run_cell(arch, shape_name, mesh, mesh_name, remat=remat, run=run,
                                   device=device, smoke=smoke, seed=seed)
                except Exception as e:  # a failure here is a bug in the port
                    failures += 1
                    traceback.print_exc()
                    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "status": "fail", "error": f"{type(e).__name__}: {e}"[:500]}
                results.append(row)
                if out:
                    with open(out, "w") as f:
                        json.dump(results, f, indent=1, default=str)
    return results, failures


def meshes_for(name: str, device: str) -> list[tuple[str, Any]]:
    if name == "host":
        return [("host", make_host_mesh(device=device))]
    names = ["single", "multi"] if name == "both" else [name]
    return [(n, make_production_mesh(multi_pod=n == "multi", device=device)) for n in names]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id (canon or dashed)")
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--mesh", default="host", choices=["host", "single", "multi", "both"])
    ap.add_argument("--remat", default=None, choices=["full", "none", "dots"])
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--run", action="store_true",
                    help="also run each decode cell that fits once at full size")
    ap.add_argument("--smoke", action="store_true", help="the SMOKE configs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    archs = [canon(args.arch)] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = meshes_for(args.mesh, args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    _, failures = run_all(archs, shapes, meshes, out=args.out, remat=args.remat, run=args.run,
                          device=args.device, smoke=args.smoke, seed=args.seed)
    print(f"[dryrun] wrote {args.out}; failures={failures}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
