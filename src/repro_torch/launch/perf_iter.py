"""Hill-climb step: trace one (arch × shape) cell under a named variant and
append its roofline row to ``experiments/perf_iterations_torch.json``.

The port of ``repro.launch.perf_iter``, with the reference's variants.  The
varied config and rules function go to :func:`dryrun.lower_cell` as
arguments (the reference patches module attributes).  ``--dump-collectives``
prints the ten ops that move the most bytes: one device has no collectives.

    PYTHONPATH=src python -m repro_torch.launch.perf_iter --arch dbrx_132b \\
        --shape train_4k --variant chunked_attn --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs.base import SHAPES, canon, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shd
from repro_torch.launch.roofline import build_report

OUT = "experiments/perf_iterations_torch.json"

VARIANTS = (
    "baseline",
    "chunked_attn",
    "remat_dots",
    "remat_none",
    "chunked_attn+remat_dots",
    "seq_parallel",
    "seq_parallel+chunked_attn",
)


def apply_variant(cfg, variant: str):
    if variant in ("baseline", "seq_parallel"):
        return cfg
    if variant in ("chunked_attn", "seq_parallel+chunked_attn"):
        return dataclasses.replace(cfg, full_attn_max_seq=2048)
    if variant == "remat_dots":
        return dataclasses.replace(cfg, remat="dots")
    if variant == "remat_none":
        return dataclasses.replace(cfg, remat="none")
    if variant == "chunked_attn+remat_dots":
        return dataclasses.replace(cfg, full_attn_max_seq=2048, remat="dots")
    raise ValueError(variant)


def sp_rules(cfg, shape, mesh):
    """Megatron-SP: the hidden stream sequence-sharded over the model axis
    (vocab leaves the model axis: the (B, S, V) logits would otherwise need
    'model' on two dims)."""
    rules = shd.rules_for(cfg, shape, mesh)
    if shape.seq_len % mesh.shape["model"] == 0:
        rules = dict(rules, seq="model", vocab=None)
    return rules


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="host", choices=["host", "single", "multi"])
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--note", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--smoke", action="store_true", help="the SMOKE configs")
    ap.add_argument("--dump-collectives", action="store_true",
                    help="print the ten ops that move the most bytes")
    args = ap.parse_args(argv)

    (mesh_name, mesh), = dryrun.meshes_for(args.mesh, args.device)
    arch = canon(args.arch)
    cfg = apply_variant(get_config(arch, smoke=args.smoke), args.variant)
    rules_fn = sp_rules if "seq_parallel" in args.variant else None
    t0 = time.perf_counter()
    low = dryrun.lower_cell(arch, args.shape, mesh, mesh_name, cfg=cfg, rules_fn=rules_fn)
    dt = time.perf_counter() - t0
    report = build_report(arch=arch, shape=low.shape, cfg=cfg, mesh_name=mesh_name,
                          chips=low.chips, counts=low.counts,
                          memory_bytes=float(low.argument_bytes + low.output_bytes))
    row = report.row()
    row.update({"variant": args.variant, "note": args.note, "trace_s": round(dt, 1),
                "argument_bytes": low.argument_bytes})
    rows = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f)
    rows.append(row)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1, default=str)
    print(
        f"[perf] {arch}×{args.shape}×{mesh_name} variant={args.variant}: "
        f"compute={report.compute_s:.6f}s memory={report.memory_s:.6f}s "
        f"collective={report.collective_s:.6f}s dominant={report.dominant} "
        f"useful={report.useful_flops_ratio:.2f} args={low.argument_bytes}"
    )
    if args.dump_collectives:
        for name, calls, flops, nbytes in low.counts.top(10):
            print(f"  {nbytes / 1e9:9.3f}GB {flops / 1e9:12.3f}GFLOP x{calls:8.0f} {name}")


if __name__ == "__main__":
    main()
