"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the numbers of the result's line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is data found by name from the cell's entry in ``BENCHMARK.json``:
``chipbench/configs/<config>.json`` (the job, its deployment, its stream and
its reference's limits), ``chipbench/traffic/<mix>.json`` (the loop, its
batch, the initial allocation), ``chipbench/metrics/<metric>.py`` (a reader
of the run's record) and ``chipbench/reference/<job>.py`` (the plain
reference).  Two loops exist: the closed one, and the controlled one, which
admits the closed loop's batches inside the program's controller periods
(the configuration's ``controller`` block); everything else is read.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path

import numpy as np

from chipbench import stats
from chipbench.gen.pool import Pool
from chipbench.trace import DeviceTrace, Spans, breakdown

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, mix and the
    metrics it reports."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        self.chips = self.entry["chips"]
        cfg = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(root / cfg["file"])
        self.mix = load_json(BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]


def metric_reader(name: str):
    """``chipbench/metrics/<name>.py``'s ``read(record)``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"chipbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference_module(config: dict):
    return importlib.import_module(f"chipbench.reference.{config['job']}")


def _call(dotted: str):
    mod, _, fn = dotted.rpartition(".")
    return getattr(importlib.import_module(mod), fn)


def initial_alloc(kind: str, op_kgs: list[int], nodes: int, seed: int) -> np.ndarray:
    """``seeded``: every key group on a node drawn from the seed.
    ``anti_collocated``: operator ``op``'s key groups dealt round robin over
    the nodes from the offset ``op * (nodes // 2 + 1)``, so neighbouring
    operators' key groups of one index sit on different nodes."""
    if kind == "seeded":
        rng = np.random.default_rng([seed, 7])
        return rng.integers(0, nodes, size=sum(op_kgs)).astype(np.int64)
    if kind == "anti_collocated":
        return np.concatenate([(np.arange(n) + op * (nodes // 2 + 1)) % nodes
                               for op, n in enumerate(op_kgs)]).astype(np.int64)
    raise ValueError(f"unknown initial allocation {kind!r}")


def warmup_batches(cell: Cell) -> int:
    """The batches a run of ``cell`` admits before its window."""
    mix = cell.mix
    if mix["loop"] == "controlled":
        return mix["warmup_periods"] * cell.config["controller"]["ticks_per_period"]
    return mix["warmup_batches"]


class Run:
    """The program under test, built from a cell's data, and what the
    harness records of it."""

    def __init__(self, cell: Cell, seed: int, device, *, log):
        import torch

        from repro_torch.engine import Engine, ExecutionConfig

        self.cell = cell
        cfg, mix = cell.config, cell.mix
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        if self.cuda and cfg.get("kernels"):
            from repro_torch.kernels import _build

            built = _build.build(cfg["kernels"])
            log(f"kernels {built} (seconds; 0 = found in the build cache)")
        topo = _call(cfg["topology"]["factory"])(
            keygroups_per_op=cfg["keygroups_per_op"], **cfg["topology"]["kwargs"])
        self.topology = topo
        self.op_kgs = [op.num_keygroups for op in topo.operators]
        self.nodes = cfg["nodes"]
        self.alloc = initial_alloc(mix["initial_alloc"], self.op_kgs, self.nodes, seed)
        t0 = time.perf_counter()
        gen = cfg["generator"]
        self.pool = Pool(gen["stream"], gen["params"], mix["batch"], mix["pool_batches"], seed)
        log(f"pool of {mix['pool_batches']} x {mix['batch']} tuples in "
            f"{time.perf_counter() - t0:.3f} s")
        self.engine = Engine(
            topo, self.nodes, config=getattr(ExecutionConfig, cfg["tier"])(),
            initial_alloc=self.alloc, service_rate=cfg["service_rate"],
            ser_cost=cfg["ser_cost"], seed=seed,
            collect_sinks=cfg["collect_sinks"], device=self.dev)
        self.engine.backpressure.full_credit = mix["full_credit"]
        self.source = cfg["source_operator"]
        self.admissions: list[tuple[int, int]] = []  # stream tuple ranges admitted
        self.offered = 0
        self.stream_pos = 0  # next stream tuple
        self.spans = Spans()
        self.captured = np.zeros(self.topology.num_keygroups, dtype=np.int64)
        self.folds: list[tuple[float, float]] = []  # each fold's (max node load, distance)
        eng = self.engine
        end_period = eng.end_period

        def capturing_end_period():
            self.captured += eng.window.kg_arrivals[: len(self.captured)].astype(np.int64)
            state = end_period()
            self.folds.append((float(state.node_loads()[state.alive].max()),
                               state.load_distance()))
            return state

        eng.end_period = capturing_end_period
        for attr in ("push_source", "tick"):
            self.spans.wrap(eng, attr, attr)
        self.controller = None
        self.unwrap: list = []  # what puts the program's module functions back
        self.longest_period = 0.0
        if mix["loop"] == "controlled":
            self.controller = self._controller(cfg["controller"], mix["batch"])

    def _controller(self, block: dict, batch: int):
        """The program's ``Controller`` over the engine, configured by the
        ``controller`` block (``ControllerConfig``'s fields, and under
        ``framework`` ``AdaptationFramework``'s, ``albic_params`` as
        ``AlbicParams``), fed one whole batch a tick.  The controller's own
        ``end_period`` calls go through the capturing wrapper above.  Every
        MILP solve, ALBIC's back-offs among them, is a ``solve`` span: the
        program's ``solve_allocation`` wrapped where the allocators call it,
        until the run puts them back."""
        from repro_torch.core import AdaptationFramework, AlbicParams
        from repro_torch.engine import Controller, ControllerConfig

        fw = dict(block["framework"])
        if "albic_params" in fw:
            fw["albic_params"] = AlbicParams(**fw["albic_params"])
        framework = AdaptationFramework(**fw)
        ctl_cfg = ControllerConfig(**{k: v for k, v in block.items() if k != "framework"})
        self.spans.wrap(framework, "adapt", "adapt")
        self.spans.wrap(self.engine, "end_period", "end_period")
        for mod in ("repro_torch.core.albic", "repro_torch.core.framework"):
            self.unwrap.append(self.spans.wrap(importlib.import_module(mod),
                                               "solve_allocation", "solve"))
        return Controller(self.engine, framework, ctl_cfg,
                          feeder=lambda engine, tick: self.admit(batch))

    # ------------------------------------------------------------ admission
    def admit(self, n: int) -> int:
        """Offer the next ``n`` stream tuples; returns those admitted."""
        a = self.stream_pos
        k, v, ts = self.pool.tuples(a, a + n)
        got = self.engine.push_source(self.source, k, v, ts)
        self.admissions.append((a, a + got))
        self.offered += n
        self.stream_pos = a + n
        return got

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.dev)

    def counters(self) -> dict:
        """Every count and time of ``EngineMetrics`` (per operator where it
        keeps one per operator), and the arrivals at every key group."""
        m = self.engine.metrics
        out = {}
        for f in dataclasses.fields(m):
            v = getattr(m, f.name)
            if isinstance(v, (int, float)):
                out[f.name] = v
            elif isinstance(v, dict):
                out[f.name] = dict(v)
        out["arrivals"] = self.captured + self.engine.window.kg_arrivals[
            : len(self.captured)].astype(np.int64)
        return out

    # ----------------------------------------------------------------- loop
    def closed(self, batches: int | None, seconds: float | None) -> tuple[float, float]:
        """One whole batch admitted a tick, as fast as the engine takes it,
        for ``batches`` ticks or until ``seconds`` have passed, then the
        drain ticks.  Returns the loop's (start, end) on the host clock, the
        end after a device synchronization."""
        eng, b = self.engine, self.cell.mix["batch"]
        t0 = time.perf_counter()
        i = 0
        while (i < batches) if seconds is None else (time.perf_counter() - t0 < seconds):
            self.admit(b)
            eng.tick()
            i += 1
        for _ in range(self.cell.config["drain_ticks"]):
            eng.tick()
        self.sync()
        return t0, time.perf_counter()

    def controlled(self, periods: int | None, seconds: float | None, *,
                   drain: bool) -> tuple[float, float]:
        """Whole controller periods (``ticks_per_period`` ticks of one batch
        each, the fold, the adaptation and its migrations): ``periods`` of
        them, or those that fit into ``seconds``.  A period starts only if
        the time so far, the longest period yet (the last warm-up period's
        to begin with) and the drain ticks at that period's pace per tick
        fit; the first always starts.  Then, with ``drain``, the drain
        ticks.  Returns the loop's (start, end) on the host clock, the end
        after a device synchronization."""
        ctl = self.controller
        drain_ticks = self.cell.config["drain_ticks"] if drain else 0
        reserve = 1.0 + drain_ticks / ctl.config.ticks_per_period
        t0 = time.perf_counter()
        i = 0
        while (i < periods) if seconds is None else (
                i == 0 or time.perf_counter() - t0 + self.longest_period * reserve <= seconds):
            p0 = time.perf_counter()
            ctl.period()
            last = time.perf_counter() - p0
            self.longest_period = last if seconds is None else max(self.longest_period, last)
            i += 1
        for _ in range(drain_ticks):
            self.engine.tick()
        self.sync()
        return t0, time.perf_counter()

    # --------------------------------------------------------------- output
    def program_result(self) -> dict:
        """What the program produced, for the reference to judge: the final
        end_period folds the compiled tier's device columns into the store."""
        eng = self.engine
        eng.end_period()
        m = eng.metrics
        out = {
            "admitted": sum(b - a for a, b in self.admissions),
            "arrivals": self.captured.copy(),
            "states": [st for _, st in eng.store.items()],
            "counts": {f: getattr(m, f) for f in ("processed_tuples", "emitted_tuples",
                                                  "sink_tuples")},
            "refused": m.dropped_credits,
        }
        if eng.collect_sinks:
            out["sink_outputs"] = list(m.sink_outputs)
        return out

    def reference(self):
        ref_mod = reference_module(self.cell.config)
        ref = ref_mod.Reference(self.cell.config, self.alloc)
        for a, b in self.admissions:
            if b > a:
                ref.admit(*self.pool.tuples(a, b))
        if hasattr(ref, "finish"):
            ref.finish()
        return ref_mod, ref


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> dict:
    """One run of ``cell``: the result line's fields, its checks last."""
    import torch

    cfg, mix = cell.config, cell.mix
    if mix["loop"] not in ("closed", "controlled"):
        raise ValueError(f"unknown loop {mix['loop']!r}")
    run = Run(cell, seed, device, log=log)
    ctl = run.controller
    # Set-up: warm every shape the window will use; under the controller,
    # whole periods, at least one of them adapted (the solver, the
    # migrations, the compiled tier's eviction and re-push).
    if ctl is None:
        run.closed(mix["warmup_batches"], None)
    else:
        if mix["warmup_periods"] <= ctl.config.warmup_periods:
            raise ValueError("the warm-up has to run at least one adapted period")
        run.controlled(mix["warmup_periods"], None, drain=False)
    setup_s = time.perf_counter() - t_start
    before = run.counters()
    periods0 = len(ctl.history) if ctl is not None else 0
    offered0, admitted0 = run.offered, sum(b - a for a, b in run.admissions)
    tracer = DeviceTrace() if trace and run.cuda else None
    run.spans.on = trace
    if trace:
        run.engine.spans = []
    if tracer is not None:
        tracer.__enter__()
    try:
        if ctl is None:
            t0, t1 = run.closed(None, seconds)
        else:
            t0, t1 = run.controlled(None, seconds, drain=True)
    finally:
        t_stop = time.perf_counter()
        if tracer is not None:
            tracer.__exit__(None, None, None)
    run.spans.on = False
    program_spans = run.engine.spans or []
    run.engine.spans = None
    t_read = time.perf_counter()
    device_events = tracer.events() if tracer is not None else None
    if tracer is not None:
        log(f"trace: profiler stopped in {t_read - t_stop:.3f} s, {len(device_events)} "
            f"device events read in {time.perf_counter() - t_read:.3f} s")
    after = run.counters()
    peak = torch.cuda.max_memory_allocated(run.dev) if run.cuda else 0
    window_s = t1 - t0
    admitted = sum(b - a for a, b in run.admissions) - admitted0
    offered = run.offered - offered0
    history = [dataclasses.asdict(m) for m in ctl.history[periods0:]] if ctl is not None else []
    record = {
        "window_s": window_s,
        "window": (t0, t1),
        "admitted": admitted,
        "delta": {f: v - before[f] for f, v in after.items()
                  if not isinstance(v, (dict, np.ndarray))},
        "nodes": run.nodes,
        "nkg": dict(enumerate(run.op_kgs)),
        "spans": list(run.spans.items),
        "device": device_events,
        "history": history,  # the controller's periods in the window
    }
    for f, v in after.items():
        if isinstance(v, dict):  # per operator
            record[f] = {op: v.get(op, 0) - before[f].get(op, 0)
                         for op in range(len(run.op_kgs))}
    base = np.concatenate([[0], np.cumsum(run.op_kgs)])
    arr = after["arrivals"] - before["arrivals"]
    record["op_tuples"] = {op: int(arr[base[op]: base[op + 1]].sum())
                           for op in range(len(run.op_kgs))}
    out = {"attempted": offered, "failed": offered - admitted,
           "ticks": record["delta"]["ticks"], "history": history}
    metrics = {}
    lines = []
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev_iv = record["device"] or []
        if tracer is not None:
            busy = stats.busy_seconds([(s, e) for _, s, e in dev_iv], t0, t1)
            out["busy_s"] = busy
            out["breakdown"] = breakdown(dev_iv, record["spans"], t0, t1)
            # Beside it, the idle time by the innermost span open over the
            # harness's spans and the program's: the program's own inside
            # the harness's, the harness's (the controller's fold,
            # adaptation and solves among them) elsewhere.
            from repro_torch.engine.tracing import flatten

            merged = flatten(record["spans"] + program_spans)
            out["idle_gaps_by_span"] = breakdown(dev_iv, merged, t0, t1)["idle_gaps"]
    lines.append(f"{mix['loop']} loop: {admitted} tuples admitted of {offered} offered in "
                 f"{record['delta']['ticks']} ticks, {window_s:.6f} s")
    if ctl is not None:
        lines.append(f"{len(history)} whole periods in the window of {seconds} s")
        for m, (top, dist) in zip(ctl.history, run.folds):
            lines.append(
                f"period {m.period}: folded max node load {top:.3f} %, load distance "
                f"{dist:.3f}; adapted: load distance {m.load_distance:.3f}, collocation "
                f"{m.collocation_factor:.3f} %, {m.num_migrations} migrations, last solve "
                f"{m.solver_seconds:.3f} s, pause {m.migration_pause_s:.6f} s")
        adapts = [(s, e) for n, s, e in record["spans"] if n == "adapt"]
        if adapts:
            solves = [[e - s for n, s, e in record["spans"] if n == "solve" and a <= s < b]
                      for a, b in adapts]
            lines.append("solves in each adapted period of the window: "
                         + ", ".join(f"{len(x)} ({sum(x):.3f} s)" for x in solves))
    for m in cell.end_to_end:
        name = m["name"]
        if name == "setup_s":
            v = setup_s
        elif name == "tuples_per_s":
            v = admitted / window_s
        else:
            raise ValueError(f"the harness measures no end-to-end metric {name!r}")
        if not trace:
            metrics[name] = {"value": float(v), "unit": m["unit"]}
        lines.append(f"{name} {v}")
    lines.append("first calls of the compiled tier in the window: "
                 f"{record['delta']['jit_compiles']}")
    controls = []
    if ctl is not None:
        # The controller's guarantees: the budget held in every period, the
        # window moved something, and every key group is routed to a live
        # node.
        budget = ctl.framework.max_migrations
        over = sum(budget is not None and m.num_migrations > budget for m in ctl.history)
        moved = sum(m["num_migrations"] for m in history)
        table, alive = run.engine.router.table, run.engine.alive
        inside = (table >= 0) & (table < len(alive))
        alloc_err = int(np.count_nonzero(~inside)) + int(
            np.count_nonzero(~alive[table[inside]]))
        controls = [("periods_over_budget", float(over), 0.0),
                    ("no_migration", float(moved == 0), 0.0),
                    ("alloc_err", float(alloc_err), 0.0)]
        run.controller = ctl = None  # so that freeing the engine frees it
        for undo in run.unwrap:
            undo()
    # The check: the program's state is read, the program freed, then the
    # plain reference runs on the host.
    prog = run.program_result()
    checks = [("refused", float(prog["refused"]), 0.0)]
    del run.engine
    run.engine = None
    gc.collect()
    t_ref = time.perf_counter()
    ref_mod, ref = run.reference()
    checks += ref_mod.compare(prog, ref, cfg["limits"])
    checks += controls
    lines.append(f"reference {time.perf_counter() - t_ref:.3f} s")
    out.update(correct=all(v <= lim for _, v, lim in checks), metrics=metrics, peak=peak,
               window_s=window_s, checks=checks, lines=lines)
    return out
