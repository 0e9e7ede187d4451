"""Every cell's loop at a tiny size on the CPU, with the timed path sound and
broken underneath; the per-layer readers on a hand-made record; the
control; and one cell on the card."""

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chipbench import control  # noqa: E402
from chipbench.harness import Cell, metric_reader, run_cell  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 3  # beyond 32 signed bits: a run takes any whole-number seed


def tiny(name: str) -> Cell:
    """The cell at 50 key groups an operator at most and 4,096-tuple batches; under
    the controller, 3-tick periods, 1 s solves and the service rate
    scaled with the batch, so that the loads stay what they are."""
    cell = Cell(BENCH, name)
    cell.config["keygroups_per_op"] = min(cell.config["keygroups_per_op"], 50)
    if cell.mix["loop"] == "controlled":
        cell.config["service_rate"] *= 4096 / cell.mix["batch"]
        ctl = cell.config["controller"]
        ctl["ticks_per_period"] = 3
        ctl["framework"]["albic_params"]["time_limit"] = 1.0
    cell.mix.update(batch=4096, pool_batches=3)
    cell.mix.update(warmup_batches=2, full_credit=8192)
    return cell


def run_tiny(name: str, trace: bool = False) -> dict:
    return run_cell(tiny(name), seed=SEED, seconds=0.6, trace=trace, device="cpu",
                    t_start=0.0, log=lambda m: None)


CONTROLLED = [c for c in CELLS if Cell(BENCH, c).mix["loop"] == "controlled"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name):
    res = run_tiny(name)
    assert res["correct"], res["checks"]
    cell = Cell(BENCH, name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(v["value"] > 0 for v in res["metrics"].values())
    # Counters and spans only: the device readers find nothing on the CPU.
    traced = run_tiny(name, trace=True)
    assert traced["correct"], traced["checks"]
    dev = {m["name"] for m in cell.per_layer if m["source"] == "device_trace"}
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer} - dev
    assert not set(traced["metrics"]) & {m["name"] for m in cell.end_to_end}


def _sum_delay_state_unchanged(monkeypatch):
    from repro_torch.data import jobs

    body = jobs._sum_delay_jit

    def unchanged(state, *args):
        _, out, lens = body(state, *args)
        return state, out, lens

    monkeypatch.setattr(jobs, "_sum_delay_jit", unchanged)


def _topk_state_unchanged(monkeypatch):
    from repro_torch.data import jobs

    make = jobs.make_real_job_1

    def frozen_topk(**kw):
        topo = make(**kw)
        op = topo.operators[topo._resolve("topk")]
        seg, fn = op.fn_seg, op.fn

        def seg_unchanged(store, kgs, *args):
            saved = {kg: copy.deepcopy(store[kg]) for kg in kgs}
            out = seg(store, kgs, *args)
            for kg, st in saved.items():
                store[kg] = st
            return out

        op.fn_seg = seg_unchanged
        op.fn = lambda state, *a: (copy.deepcopy(state), fn(copy.deepcopy(state), *a)[1])
        return topo

    monkeypatch.setattr(jobs, "make_real_job_1", frozen_topk)


def _half_batch(monkeypatch):
    from repro_torch.engine.executor import Engine

    admit = Engine._admit_source

    def half(self, oid, keys, values, ts, n):
        return admit(self, oid, keys, values, ts, max(1, n // 2))

    monkeypatch.setattr(Engine, "_admit_source", half)


def _route_delay_altered(monkeypatch):
    from repro_torch.data import jobs

    body = jobs._route_delay_jit

    def altered(state, kgs, starts, ends, keys, values, ts):
        values = dict(values)
        values["delay"] = values["delay"].clone()
        values["delay"][0] += 1.0
        return body(state, kgs, starts, ends, keys, values, ts)

    monkeypatch.setattr(jobs, "_route_delay_jit", altered)


def _global_ranking_altered(monkeypatch):
    from repro_torch.data import jobs

    make = jobs.make_real_job_1

    def altered_global(**kw):
        topo = make(**kw)
        op = topo.operators[topo._resolve("global_topk")]
        seg = op.fn_seg

        def seg_altered(*args):
            out, lens = seg(*args)
            if out is not None:
                value = out[1][0]
                art, c = value["top"][0]
                out[1][0] = dict(value, top=[(art, c + 1)] + value["top"][1:])
            return out, lens

        op.fn_seg = seg_altered
        return topo

    monkeypatch.setattr(jobs, "make_real_job_1", altered_global)


def _install_drops_state(monkeypatch):
    from repro_torch.engine.executor import Engine

    install = Engine.install

    def dropping(self, keygroup, dst, blob):
        install(self, keygroup, dst, blob)
        self.store.put(keygroup, {})

    monkeypatch.setattr(Engine, "install", dropping)


# Step 3's faults a one-card cell can have (no exchange between chips).
FAULTS = {
    "job3": {"state unchanged": _sum_delay_state_unchanged, "half batch": _half_batch,
             "answer altered": _route_delay_altered},
    "job1": {"state unchanged": _topk_state_unchanged, "half batch": _half_batch,
             "answer altered": _global_ranking_altered},
}


@pytest.mark.parametrize("name, fault", [(c, f) for c in CELLS for f in FAULTS["job1"]])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    job = Cell(BENCH, name).config["job"].replace("real_", "").replace("_", "")
    FAULTS[job][fault](monkeypatch)
    res = run_tiny(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CONTROLLED)
def test_controlled_loop_runs_whole_periods_inside_its_window(name):
    cell = tiny(name)
    ctl = cell.config["controller"]
    res = run_cell(cell, seed=SEED + 1, seconds=2.5, trace=True, device="cpu", t_start=0.0,
                   log=lambda m: None)
    assert res["correct"], res["checks"]
    periods = len(res["history"])
    # The first period always runs; any later one only where it fit.
    assert periods >= 1 and (periods == 1 or res["window_s"] <= 2.5)
    assert res["ticks"] == periods * ctl["ticks_per_period"] + cell.config["drain_ticks"]
    # The window's periods follow the warm-up's, and every one adapted.
    first = cell.mix["warmup_periods"]
    assert [p["period"] for p in res["history"]] == list(range(first, first + periods))
    assert first > ctl["warmup_periods"]
    assert {"adapt_ms_per_period", "solver_ms_per_period", "end_period_ms_per_period",
            "load_distance.albic"} <= set(res["metrics"])


def test_controlled_window_starts_a_period_only_where_it_fits(monkeypatch):
    """On a made clock: warm-up periods of 1 and 2 s, window periods of 1.5,
    2.5, 1.0, ... s, ticks of 0.1 s, 4 drain ticks to 20-tick periods."""
    from types import SimpleNamespace

    from chipbench import harness

    clock = [0.0]
    lengths = iter([1.0, 2.0, 1.5, 2.5, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0])
    started = []

    def period():
        started.append(clock[0])
        clock[0] += next(lengths)

    def tick():
        clock[0] += 0.1

    monkeypatch.setattr(harness, "time", SimpleNamespace(perf_counter=lambda: clock[0]))
    run = harness.Run.__new__(harness.Run)
    run.cell = SimpleNamespace(config={"drain_ticks": 4})
    run.controller = SimpleNamespace(config=SimpleNamespace(ticks_per_period=20),
                                     period=period)
    run.engine = SimpleNamespace(tick=tick)
    run.cuda, run.longest_period = False, 0.0
    assert run.controlled(2, None, drain=False) == (0.0, 3.0)
    assert run.longest_period == 2.0  # the last warm-up period's
    t0, t1 = run.controlled(None, 8.0, drain=True)
    # The first starts at 3; a later one only where the time so far plus the
    # longest period yet, 1.2 times for the drain, fits 8 s: 1.5 + 2.4,
    # 4.0 + 3.0 and 5.0 + 3.0 do, 6.0 + 3.0 does not.
    assert started[2:] == [3.0, 4.5, 7.0, 8.0]
    assert t1 - t0 == pytest.approx(6.0 + 0.4) and t1 - t0 <= 8.0


@pytest.mark.parametrize("name", CONTROLLED)
def test_controlled_cell_migrates_and_is_correct(name):
    res = run_tiny(name)
    assert res["correct"], res["checks"]
    checks = {n: (v, lim) for n, v, lim in res["checks"]}
    for n in ("periods_over_budget", "no_migration", "alloc_err", "refused"):
        assert checks[n] == (0.0, 0.0), n
    budget = Cell(BENCH, name).config["controller"]["framework"]["max_migrations"]
    moved = [p["num_migrations"] for p in res["history"]]
    assert sum(moved) > 0 and max(moved) <= budget
    # The solves' wrappers are gone with the run.
    import importlib

    solve = importlib.import_module("repro_torch.core.milp").solve_allocation
    for mod in ("repro_torch.core.albic", "repro_torch.core.framework"):
        assert importlib.import_module(mod).solve_allocation is solve, mod


@pytest.mark.parametrize("name", CONTROLLED)
def test_dropped_migration_state_is_not_correct(monkeypatch, name):
    _install_drops_state(monkeypatch)
    res = run_tiny(name)
    assert not res["correct"], res["checks"]
    checks = {n: v for n, v, lim in res["checks"]}
    assert checks["key_err"] > 0 or checks["sum_err"] > 1e-9, checks


@pytest.mark.parametrize("name", CONTROLLED)
def test_a_budget_broken_is_not_correct(monkeypatch, name):
    """A framework that ignores its budget (the plan solved without it)
    fails ``periods_over_budget``."""
    from repro_torch.core import framework

    albic = framework.albic

    def unbudgeted(state, **kw):
        return albic(state, **dict(kw, max_migrations=None))

    monkeypatch.setattr(framework, "albic", unbudgeted)
    res = run_tiny(name)
    checks = {n: v for n, v, lim in res["checks"]}
    assert checks["periods_over_budget"] > 0 and not res["correct"], checks


def test_anti_collocated_start_is_the_controller_phase_s_definition():
    from repro_torch.data.jobs import real_job_3

    from chipbench.harness import initial_alloc

    topo = real_job_3(keygroups_per_op=50)
    nodes = 16
    want = np.zeros(topo.num_keygroups, dtype=np.int64)
    for op in range(topo.num_operators):
        base, n_op = topo.kg_base(op), topo.operators[op].num_keygroups
        want[base:base + n_op] = (np.arange(n_op) + op * (nodes // 2 + 1)) % nodes
    got = initial_alloc("anti_collocated", [o.num_keygroups for o in topo.operators],
                        nodes, SEED)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    # No two neighbouring operators put a key group index on one node.
    per_op = got.reshape(topo.num_operators, -1)
    assert not (per_op[1:] == per_op[:-1]).any()
    with pytest.raises(ValueError):
        initial_alloc("round_robin", [50], nodes, SEED)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name):
    cell = tiny(name)
    ranges = control.admissions(cell, 3)
    checks = control.run_control(cell, SEED, ranges)
    assert any(v > lim for _, v, lim in checks), checks


def _record(device):
    """Four ticks of two operators: 100 tuples routed to each, all through
    both kernels; 0.2 s of push and tick spans, 0.04 s of round trips."""
    return {
        "window_s": 1.0, "window": (0.0, 1.0), "admitted": 100, "nodes": 4,
        "nkg": {0: 10, 1: 10},
        "delta": {"ticks": 4, "device_route_seconds": 0.04, "host_device_bytes": 4000,
                  "jit_host_syncs": 8, "jit_calls": 8},
        "spans": [("push_source", 0.0, 0.05), ("tick", 0.05, 0.2), ("end_period", 0.2, 0.9)],
        "device": device,
        "routed_batches": {0: 4, 1: 4}, "partition_kernel_batches": {0: 4, 1: 4},
        "sort_kernel_batches": {0: 4, 1: 2}, "op_tuples": {0: 100, 1: 100},
    }


def test_readers_by_hand():
    device = [("keygroup_partition_kernel<long long, true>", 0.1, 0.1 + 1e-6),
              ("radix_pass_kernel<short>", 0.3, 0.3 + 2e-6), ("Memcpy HtoD", 0.5, 0.7)]
    rec = _record(device)
    read = {m["name"]: metric_reader(m["name"])(rec) for m in BENCH["per_layer"]}
    assert read["host_ms_per_tick.saturate"] == pytest.approx(1e3 * (0.2 - 0.04) / 4)
    assert read["route_roundtrip_ms_per_tick.saturate"] == pytest.approx(10.0)
    assert read["host_device_bytes_per_tuple.saturate"] == pytest.approx(40.0)
    assert read["jit_host_syncs_per_tick"] == pytest.approx(2.0)
    # 200 tuples x 16 B + 8 batches x 10 x 8 B = 3,840 B over 1 us at 3.35 TB/s.
    assert read["keygroup_partition_roofline"] == pytest.approx(
        100 * 3840 / 3.35e12 / 1e-6)
    # (100 + 50) tuples x (2 + 8) B over 2 us.
    assert read["radix_sort_roofline"] == pytest.approx(100 * 1500 / 3.35e12 / 2e-6)
    busy = 1e-6 + 2e-6 + 0.2
    assert read["device_idle_share.saturate"] == pytest.approx(100 * (1 - busy))
    # Nothing to read: no trace, no compiled tier.
    rec = _record(None)
    rec["delta"]["jit_calls"] = 0
    for name in ("keygroup_partition_roofline", "radix_sort_roofline",
                 "device_idle_share.saturate", "jit_host_syncs_per_tick"):
        assert metric_reader(name)(rec) is None, name


CONTROLLER_READERS = ["adapt_ms_per_period", "solver_ms_per_period",
                      "migration_pause_ms_per_period", "end_period_ms_per_period",
                      "load_distance.albic"]


def test_controller_readers_by_hand():
    """Two adapted periods in the window: 3.0 s of ``adapt``, 1.9 s of
    ``solve`` inside them (two solves, then one) and 0.5 s of ``end_period``
    spans among the tick spans; the last solve of each period, as the
    program's counter keeps it, is not what the solver metric reads."""
    rec = _record(None)
    rec["spans"] = [("push_source", 0.0, 0.05), ("tick", 0.05, 0.2), ("end_period", 0.2, 0.4),
                    ("adapt", 0.4, 2.4), ("solve", 0.5, 1.5), ("solve", 1.6, 2.0),
                    ("tick", 2.5, 2.6), ("end_period", 2.6, 2.9), ("adapt", 2.9, 3.9),
                    ("solve", 3.0, 3.5)]
    rec["history"] = [
        {"period": 2, "solver_seconds": 1.5, "migration_pause_s": 0.004, "load_distance": 30.0,
         "num_migrations": 10},
        {"period": 3, "solver_seconds": 0.5, "migration_pause_s": 0.0, "load_distance": 20.0,
         "num_migrations": 0},
    ]
    read = {name: metric_reader(name)(rec) for name in CONTROLLER_READERS}
    assert read == {
        "adapt_ms_per_period": pytest.approx(1500.0),
        "solver_ms_per_period": pytest.approx(950.0),
        "migration_pause_ms_per_period": pytest.approx(2.0),
        "end_period_ms_per_period": pytest.approx(250.0),
        "load_distance.albic": pytest.approx(25.0),
    }
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in CONTROLLER_READERS:
        assert entries[name]["workloads"] == CONTROLLED
        assert entries[name]["layer"] in ("Controller", "Allocators")


@pytest.mark.parametrize("name", CONTROLLER_READERS)
def test_controller_reader_finds_nothing_to_read(name):
    """No controller: a closed-loop record (no history), and one whose
    window held no period."""
    read = metric_reader(name)
    rec = _record(None)
    assert read(rec) is None
    rec["history"] = []
    assert read(rec) is None


def test_no_jax_guard_in_a_subprocess():
    code = (
        "import sys, types\n"
        "sys.path[:0] = ['src', '.']\n"
        "import repro_torch.engine\n"
        "from chipbench import guard\n"
        "assert guard.forbidden_modules() == [], guard.forbidden_modules()\n"
        "assert guard.forbidden_modules(['repro_torch.x', 'reprox', 'jaxtyping']) == []\n"
        "sys.modules['repro.core'] = types.ModuleType('repro.core')\n"
        "sys.modules['jax.numpy'] = types.ModuleType('jax.numpy')\n"
        "print(guard.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["['jax',", "'repro']"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    res = run_cell(tiny(name), seed=SEED, seconds=1.0, trace=True, device=card,
                   t_start=0.0, log=lambda m: None)
    assert res["correct"], res["checks"]
    assert res["busy_s"] > 0 and res["breakdown"]["device_ops"]
    assert all(np.isfinite(v["value"]) for v in res["metrics"].values())
