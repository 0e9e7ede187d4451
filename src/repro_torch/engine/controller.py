"""The controller (paper §3): collects statistics, runs Algorithm 1, applies
migrations and scaling against the live engine.

One `period()` call = one SPL: run ``ticks_per_period`` engine ticks (the
caller feeds sources between ticks), fold statistics, adapt, migrate, and
append a metrics row — the rows are exactly the series plotted in the paper's
Figures 6–14 (load distance, #migrations, collocation factor, load index).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.framework import AdaptationFramework, AdaptationResult
from repro_torch.core.migration import execute_plan
from repro_torch.core.stats import ClusterState
from repro_torch.engine.executor import Engine


@dataclasses.dataclass
class ControllerConfig:
    ticks_per_period: int = 20
    warmup_periods: int = 1  # discarded, like the paper's JIT warm-up window


@dataclasses.dataclass
class PeriodMetrics:
    period: int
    load_distance: float
    collocation_factor: float
    system_load: float
    load_index: float
    num_migrations: int
    migration_cost: float
    migration_pause_s: float
    latency: dict[str, float]
    num_nodes_alive: int
    scaling_added: int
    scaling_marked: int
    solver_seconds: float
    # Hot-key splitting activity this period (0 without a splitter policy).
    num_splits: int = 0
    num_unsplits: int = 0
    #: Worker recoveries (supervised respawn + rewind) completed this period.
    num_recoveries: int = 0


class Controller:
    """Periodic adaptation driver for a live :class:`Engine`."""

    def __init__(
        self,
        engine: Engine,
        framework: AdaptationFramework,
        config: ControllerConfig | None = None,
        feeder: Optional[Callable[[Engine, int], None]] = None,
    ) -> None:
        self.engine = engine
        self.framework = framework
        self.config = config or ControllerConfig()
        self.feeder = feeder  # called before each tick to push source data
        self.history: list[PeriodMetrics] = []
        self._period = 0
        self._baseline_system_load: Optional[float] = None

    def run_ticks(self, ticks: int) -> None:
        for t in range(ticks):
            if self.feeder is not None:
                self.feeder(self.engine, self.engine.metrics.ticks)
            self.engine.tick()

    def period(self, *, adapt: bool = True) -> PeriodMetrics:
        """One SPL: execute ticks, snapshot stats, adapt, migrate, record."""
        recoveries_before = len(getattr(self.engine, "recoveries", ()))
        self.run_ticks(self.config.ticks_per_period)
        snapshot = self.engine.end_period()

        result: Optional[AdaptationResult] = None
        pause_s = 0.0
        num_splits = num_unsplits = 0
        if adapt and self._period >= self.config.warmup_periods:
            splitting = self.framework.splitter is not None
            result = self.framework.adapt(
                snapshot,
                split_families=(
                    self.engine.split_families() if splitting else None
                ),
                split_eligible=(
                    self.engine.split_eligible() if splitting else None
                ),
            )
            # Elastic scaling against the engine.
            if result.scaling.add_nodes:
                self.engine.add_nodes(result.scaling.add_nodes)
            # Terminated nodes: drop from engine liveness.
            for node in result.terminated:
                self.engine.alive[node] = False
            # Direct state migration over the engine (StateMover protocol).
            report = execute_plan(result.migration_plan, self.engine)
            pause_s = report.pause_seconds
            # Apply the advisory split decision after the migrations: the
            # plan ran synchronously, so no family member is in flight, and
            # new replicas become ordinary key groups in the next snapshot.
            if result.split is not None:
                degree = self.engine.config.split_degree
                for kg in result.split.unsplit:
                    self.engine.unsplit_keygroup(kg)
                    num_unsplits += 1
                for kg in result.split.split:
                    if self.engine.split_slots_free < degree - 1:
                        break  # reserve exhausted; retry next period
                    self.engine.split_keygroup(kg)
                    num_splits += 1

        alloc = self.engine.router.table
        # Post-adaptation view: after scaling, `snapshot` predates the new
        # nodes while `alloc` may already reference them.
        if result is not None:
            snapshot = result.state
        # Measured kg_load already embeds serialization CPU (the engine charges
        # it per cross-node tuple), so no analytic ser term is added here.
        sys_load = snapshot.system_load(alloc, ser_cost=0.0)
        warmed = self._period >= self.config.warmup_periods
        if self._baseline_system_load is None and warmed:
            self._baseline_system_load = max(sys_load, 1e-9)
        load_index = (
            100.0 * sys_load / self._baseline_system_load
            if self._baseline_system_load
            else 100.0
        )

        metrics = PeriodMetrics(
            period=self._period,
            load_distance=snapshot.load_distance(alloc),
            collocation_factor=snapshot.collocation_factor(alloc),
            system_load=sys_load,
            load_index=load_index,
            num_migrations=result.migration_plan.num_migrations if result else 0,
            migration_cost=result.migration_plan.total_cost if result else 0.0,
            migration_pause_s=pause_s,
            latency=self.engine.latency.summary(),
            num_nodes_alive=int(np.sum(self.engine.alive)),
            scaling_added=result.scaling.add_nodes if result else 0,
            scaling_marked=len(result.scaling.mark_for_removal) if result else 0,
            solver_seconds=result.plan.solve_seconds if result else 0.0,
            num_splits=num_splits,
            num_unsplits=num_unsplits,
            num_recoveries=(
                len(getattr(self.engine, "recoveries", ())) - recoveries_before
            ),
        )
        self.engine.latency.reset()
        self.history.append(metrics)
        self._period += 1
        return metrics

    # -- fault tolerance ------------------------------------------------------
    def handle_node_failure(
        self, node: int, snapshot: ClusterState
    ) -> AdaptationResult:
        """Crash path: orphan the node's key groups and re-plan immediately.

        `snapshot` is the last folded statistics (or checkpointed) state; the
        failed node is marked dead so the MILP excludes it, and the orphaned
        key groups' migration cost is zeroed (their state is restored from the
        checkpoint, not serialized from the dead node).
        """
        orphans = self.engine.fail_node(node)
        snap = snapshot.copy()
        snap.alive[node] = False
        snap.kg_state_bytes = snap.kg_state_bytes.copy()
        snap.kg_state_bytes[orphans] = 0.0  # recovery is not a migration cost
        # Reallocate: a plan must exist, so lift the budget for the emergency.
        saved_cost = self.framework.max_migr_cost
        saved_migr = self.framework.max_migrations
        self.framework.max_migr_cost, self.framework.max_migrations = None, None
        try:
            result = self.framework.adapt(snap)
        finally:
            self.framework.max_migr_cost, self.framework.max_migrations = (
                saved_cost,
                saved_migr,
            )
        # Apply routing for orphans without serialize (state from checkpoint).
        for kg in orphans:
            dst = int(result.state.alloc[kg])
            self.engine.router.redirect(int(kg), dst)
            self.engine.install(int(kg), dst, self.engine.store.serialize(int(kg)))
        # Remaining moves use the normal mover path.
        orphan_set = set(orphans)
        rest = [
            m for m in result.migration_plan.moves if m.keygroup not in orphan_set
        ]
        for m in rest:
            self.engine.redirect(m.keygroup, m.dst)
            self.engine.install(m.keygroup, m.dst, self.engine.serialize(m.keygroup))
        return result
