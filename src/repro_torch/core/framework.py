"""The integrative adaptation framework (paper §4.1, Algorithm 1).

    1  for each node marked for removal in previous periods:
    2      if it holds no key groups:
    3          terminate it
    4  plan ← keyGroupAlloc()                    # balancing (+ collocation)
    5  if Scaling(plan):                         # decide USING the plan
    6      wait until new nodes are allocated
    7      plan ← keyGroupAlloc()                # re-plan integratively
    8  apply(plan)

The three sub-problems stay coupled through two levers: (i) the scaler sees
the *potential* plan, so balancing/collocation that would absorb an overload
suppresses scale-out, and un-balanceable scale-in is vetoed by the re-plan;
(ii) the allocator sees ``kill`` marks and the migration budget together, so
draining B competes with urgent rebalancing for the same budget (the paper's
Fig. 5 behaviour, guaranteed by Lemmas 1–2 to still converge to a full drain).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.albic import AlbicParams, albic
from repro_torch.core.migration import MigrationPlan, plan_from_allocations
from repro_torch.core.milp import AllocationPlan, solve_allocation
from repro_torch.core.scaling import NullScaler, Scaler, ScalingDecision, apply_scaling
from repro_torch.core.splitting import HotKeySplitter, SplitDecision
from repro_torch.core.stats import ClusterState

Allocator = Callable[[ClusterState], AllocationPlan]


@dataclasses.dataclass
class AdaptationResult:
    state: ClusterState  # post-adaptation snapshot (alloc updated)
    plan: AllocationPlan
    migration_plan: MigrationPlan
    scaling: ScalingDecision
    terminated: list[int]
    # Advisory hot-key split/unsplit picks (None when no splitter is
    # configured); the controller applies them after the migrations run.
    split: Optional[SplitDecision] = None
    # Every MILP solve of the period in order, ALBIC's back-offs and the
    # re-plans after scaling among them; the last is ``plan``.
    solves: list[AllocationPlan] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AdaptationFramework:
    """Periodic controller implementing Algorithm 1.

    ``mode`` selects the allocator: "milp" (pure §4.3.1) or "albic"
    (§4.3.2).  Budgets mirror the paper: exactly one of max_migr_cost /
    max_migrations (the latter for Flux-comparable experiments).
    """

    scaler: Scaler = dataclasses.field(default_factory=NullScaler)
    mode: str = "albic"
    # Optional hot-key splitting policy: when set, adapt() also emits an
    # advisory SplitDecision from the same snapshot (and the same
    # kg_tuple_rate leading signal) the allocation plan was computed from.
    splitter: Optional[HotKeySplitter] = None
    max_migr_cost: Optional[float] = None
    max_migrations: Optional[int] = None
    albic_params: AlbicParams = dataclasses.field(default_factory=AlbicParams)
    time_limit: float = 10.0
    alpha: float = 1.0
    # Previous period's kg_tuple_rate — the leading-load signal: ALBIC's
    # step-3 node scoring AND the MILP balance objective's gLoad vector
    # project with it (mirrors the scalers' rate projection; see
    # repro_torch.core.scaling.rate_growth).
    _prev_rate: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def _allocate(
        self, state: ClusterState, solves: list[AllocationPlan]
    ) -> AllocationPlan:
        """The allocator's plan; every solve it took is appended to ``solves``."""
        if self.mode == "albic":
            result = albic(
                state,
                max_migr_cost=self.max_migr_cost,
                max_migrations=self.max_migrations,
                params=self.albic_params,
                prev_rate=self._prev_rate,
            )
            solves.extend(result.solves)
            return result.plan
        plan = solve_allocation(
            state,
            max_migr_cost=self.max_migr_cost,
            max_migrations=self.max_migrations,
            alpha=self.alpha,
            time_limit=self.time_limit,
            prev_rate=self._prev_rate,
        )
        solves.append(plan)
        return plan

    def adapt(
        self,
        state: ClusterState,
        *,
        split_families: Optional[dict] = None,
        split_eligible: Optional[np.ndarray] = None,
    ) -> AdaptationResult:
        """One adaptation period.  Returns the updated snapshot + artifacts.

        ``split_families`` / ``split_eligible`` carry the engine's live
        split map and mergeability mask to the splitter policy (ignored
        when no :attr:`splitter` is configured).
        """
        state = state.copy()

        # Lines 1–3: terminate drained nodes marked in previous periods.
        terminated: list[int] = []
        kg_per_node = np.bincount(state.alloc, minlength=state.num_nodes)
        for i in np.where(state.kill & state.alive)[0]:
            if kg_per_node[i] == 0:
                state.alive[i] = False
                terminated.append(int(i))

        # Line 4: potential allocation plan (balancing + collocation).
        solves: list[AllocationPlan] = []
        plan = self._allocate(state, solves)

        # Lines 5–7: scaling decision *on the plan*, then integrative re-plan.
        decision = self.scaler.decide(state, plan)
        if decision.scaled:
            state = apply_scaling(state, decision)
            plan = self._allocate(state, solves)
            # Veto scale-in that the re-plan cannot balance: unmark nodes whose
            # removal leaves the survivors outside maxLD.
            if decision.mark_for_removal and self.mode == "albic":
                if plan.load_distance > self.albic_params.max_ld:
                    for i in decision.mark_for_removal:
                        state.kill[i] = False
                    decision = ScalingDecision()
                    plan = self._allocate(state, solves)

        # Line 8: apply(plan) — emit the migration plan and commit the alloc.
        migration_plan = plan_from_allocations(state, plan.alloc, alpha=self.alpha)
        state.alloc = plan.alloc.copy()
        # Hot-key splitting rides the same snapshot: the splitter projects
        # with its own copy of the rate signal, so a surge that grows the
        # migration plan also surfaces the key group that migration cannot
        # fix.  The decision is advisory — the controller applies it against
        # the engine after the migrations execute.
        split = None
        if self.splitter is not None:
            split = self.splitter.decide(
                state, split_families or {}, eligible=split_eligible
            )
        # Remember this period's arrival rates for next period's projection.
        self._prev_rate = (
            None if state.kg_tuple_rate is None else state.kg_tuple_rate.copy()
        )
        return AdaptationResult(
            state=state,
            plan=plan,
            migration_plan=migration_plan,
            scaling=decision,
            terminated=terminated,
            split=split,
            solves=solves,
        )
