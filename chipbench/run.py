"""Run one cell of the port's benchmark once, or list the cells.

    python chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python chipbench/run.py --list

Reads ``BENCHMARK.json`` at the checkout's root.  Prints diagnostics and
then each number the correctness check compared, beside its limit, on
standard error, and one JSON object as the last line of standard output.
Exits non-zero, printing no result, when no CUDA card is present or fewer
than the cell asks for, when the program cannot be imported, or when JAX or
the JAX package was loaded.  The process fixes ``PYTHONHASHSEED`` from the
seed (restarting itself once to do so), so string keys hash alike in every
run of one seed, and keeps every cache under ``build/`` in the checkout.
"""

import time

_T0 = time.time()  # process start, as near as Python gets

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHES = {  # every cache the program or torch may write, inside the checkout
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
    "CUDA_CACHE_PATH": "nv",
}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--list", action="store_true", help="print every cell and exit")
    args = p.parse_args(argv)
    if not args.list and (args.workload is None or args.seconds is None):
        p.error("--workload and --seconds are required")
    return args


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def list_cells(bench: dict) -> None:
    from chipbench.harness import Cell

    for w in bench["workloads"]:
        cell = Cell(bench, w["name"])
        print(f"{w['name']}: config {w['config']} ({cell.config['job']}, "
              f"{cell.config['tier']}), traffic {w['traffic']} ({cell.mix['loop']} loop), "
              f"chips {w['chips']}; end-to-end "
              f"{', '.join(m['name'] for m in cell.end_to_end)}; per-layer "
              f"{', '.join(m['name'] for m in cell.per_layer)}")


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if args.list:
        list_cells(bench)
        return 0
    seed = args.seed % 2**63
    hash_seed = str(seed % 2**32)
    t0 = float(os.environ.get("CHIPBENCH_T0", _T0))
    if os.environ.get("PYTHONHASHSEED") != hash_seed:
        env = dict(os.environ, PYTHONHASHSEED=hash_seed, CHIPBENCH_T0=repr(t0))
        os.execve(sys.executable, [sys.executable, *sys.argv], env)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "cache" / sub)

    from chipbench import guard
    from chipbench.harness import Cell, run_cell

    cell = Cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        err(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    t_start = time.perf_counter() - (time.time() - t0)
    res = run_cell(cell, seed=seed, seconds=args.seconds, trace=bool(args.trace),
                   device="cuda", t_start=t_start, log=err)
    bad = guard.forbidden_modules()
    if bad:
        err(f"loaded in this process, and forbidden: {', '.join(bad)}")
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(res["peak"])}
    line = {"correct": bool(res["correct"]), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": res["metrics"], "device": device}
    if args.trace:
        device.update(busy_s=res.get("busy_s", 0.0), window_s=res["window_s"])
        if "breakdown" in res:
            line["breakdown"] = res["breakdown"]
            line["idle_gaps_by_span"] = res["idle_gaps_by_span"]
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in res["checks"]}
    for text in res["lines"]:
        err(text)
    for name, v, lim in res["checks"]:
        err(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
