"""The correctness check's control: the plain reference put in the program's
place, computed one step below what the configuration states, and judged by
the same comparison as the program.

    python chipbench/control.py --workload <cell> --seeds 1,2,3 --batches N

The stream is the cell's own, from each seed, at the size a run admits: the
mix's warm-up (its batches, or its periods' batches under the controller),
then ``--batches`` whole batches (as many as a run's window takes), from the
mix's initial allocation.  The step
below: float32 sums where the configuration states float64 (the reference's
``dtype``); where it states no precision, a broken guarantee (the
reference's ``redeliver``: each batch's first tuple delivered twice).
Prints one JSON line a seed with every number compared and its limit; a
control that passes every limit would make the check worthless.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_kwargs(config: dict) -> dict:
    import numpy as np

    if config["precision"] == "float64":
        return {"dtype": np.float32}
    return {"redeliver": True}


def admissions(cell, batches: int) -> list[tuple[int, int]]:
    """The stream ranges a run of the cell admits, in order: the warm-up's
    batches, then ``batches`` more."""
    from chipbench.harness import warmup_batches

    b = cell.mix["batch"]
    return [(i * b, (i + 1) * b) for i in range(warmup_batches(cell) + batches)]


def run_control(cell, seed: int, ranges) -> list:
    from chipbench.gen.pool import Pool
    from chipbench.harness import initial_alloc, reference_module

    cfg, mix = cell.config, cell.mix
    gen = cfg["generator"]
    pool = Pool(gen["stream"], gen["params"], mix["batch"], mix["pool_batches"], seed)
    ref_mod = reference_module(cfg)
    alloc = initial_alloc(mix["initial_alloc"], [cfg["keygroups_per_op"]] * ref_mod.OPERATORS,
                          cfg["nodes"], seed)
    sound = ref_mod.Reference(cfg, alloc)
    low = ref_mod.Reference(cfg, alloc, **control_kwargs(cfg))
    for a, b in ranges:
        batch = pool.tuples(a, b)
        sound.admit(*batch)
        low.admit(*batch)
    for ref in (sound, low):
        if hasattr(ref, "finish"):
            ref.finish()
    return ref_mod.compare(low.as_program(), sound, cfg["limits"])


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--batches", type=int, required=True)
    args = p.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chipbench.harness import Cell

    cell = Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    ranges = admissions(cell, args.batches)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        checks = run_control(cell, seed, ranges)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "tuples": sum(b - a for a, b in ranges),
                          "seconds": round(time.perf_counter() - t, 3),
                          "checks": {n: [v, lim] for n, v, lim in checks},
                          "failed": [n for n, v, lim in checks if v > lim]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
