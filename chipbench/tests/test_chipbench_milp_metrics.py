"""The readers of the program's MILP counters (``PeriodMetrics.
milp_build_seconds``, ``milp_binaries``, ``milp_solves``) by hand on made
records and on records that lack them; and, on a tiny controlled cell, the
counters against every solve of a period and the program's ``milp`` spans
inside the harness's ``solve`` spans."""

import importlib
import json
from pathlib import Path

import pytest

from chipbench.harness import Cell, metric_reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = ["milp_build_ms_per_period", "milp_binaries_per_solve"]
CONTROLLED = [w["name"] for w in BENCH["workloads"]
              if Cell(BENCH, w["name"]).mix["loop"] == "controlled"]


@pytest.mark.parametrize("name,unit", zip(NAMES, ["ms", "binaries"]))
def test_entry_in_the_benchmark(name, unit):
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        unit, "lower", "program_counter", "Allocators", "tuples_per_s")
    assert m["workloads"] == CONTROLLED


def period(solves, binaries, build):
    return {"period": 2, "milp_solves": solves, "milp_binaries": binaries,
            "milp_build_seconds": build, "load_distance": 10.0}


@pytest.mark.parametrize("history,build_ms,per_solve", [
    # One solve a period: the dense 8-node program.
    ([period(1, 960, 0.004), period(1, 960, 0.006)], 5.0, 960.0),
    # Six solves (five back-offs), then one: the scaled program.
    ([period(6, 12_000, 0.06), period(1, 2_000, 0.02)], 40.0, 2_000.0),
])
def test_readers_by_hand(history, build_ms, per_solve):
    rec = {"history": history, "spans": []}
    assert metric_reader(NAMES[0])(rec) == pytest.approx(build_ms)
    assert metric_reader(NAMES[1])(rec) == pytest.approx(per_solve)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("history", [
    None,  # a closed-loop record
    [],  # a window that held no period
    [{"period": 2, "load_distance": 10.0, "solver_seconds": 1.5}],  # no counters
    [period(0, 0, 0.0)],  # no solve
])
def test_reader_finds_nothing_to_read(name, history):
    rec = {"spans": []} if history is None else {"spans": [], "history": history}
    assert metric_reader(name)(rec) is None


@pytest.mark.parametrize("name", CONTROLLED)
def test_counters_sum_every_solve_and_spans_nest_in_solve(name):
    """Three periods of the tiny cell (one folds only): each adapted
    period's counters are the sums over the plans of its solves, ALBIC's
    back-offs among them; each solve gives one ``milp.build`` span, then
    one ``milp.highs`` span, both inside that solve's ``solve`` span."""
    from test_chipbench_cells import SEED, tiny

    from chipbench.harness import Run

    run = Run(tiny(name), SEED, "cpu", log=lambda m: None)
    albic = importlib.import_module("repro_torch.core.albic")
    wrapped, plans = albic.solve_allocation, []

    def keep(*args, **kw):
        plans.append(wrapped(*args, **kw))
        return plans[-1]

    albic.solve_allocation = keep
    try:
        run.spans.on = True
        run.engine.spans = []
        per_period = []
        for _ in range(3):
            before = len(plans)
            run.controller.period()
            per_period.append(plans[before:])
    finally:
        albic.solve_allocation = wrapped
        for undo in run.unwrap:
            undo()
    history = run.controller.history
    assert [len(p) for p in per_period][0] == 0 and all(per_period[1:])
    for m, solves in zip(history, per_period):
        assert m.milp_solves == len(solves)
        assert m.milp_binaries == sum(p.binaries for p in solves)
        assert m.milp_build_seconds == pytest.approx(sum(p.build_seconds for p in solves))
        assert m.milp_highs_seconds == pytest.approx(sum(p.highs_seconds for p in solves))
    solve_spans = [(s, e) for n, s, e in run.spans.items if n == "solve"]
    program = [sp for sp in run.engine.spans if sp[0].startswith("milp.")]
    assert len(solve_spans) == len(plans) and len(program) == 2 * len(plans)
    for (s, e), (b, hi) in zip(solve_spans, zip(program[::2], program[1::2])):
        assert (b[0], hi[0]) == ("milp.build", "milp.highs")
        assert s <= b[1] <= b[2] == hi[1] <= hi[2] <= e
