"""The paper's primary contribution: integrative dynamic reconfiguration.

Public surface:

* :class:`repro_torch.core.stats.ClusterState` — the shared allocation/statistics
  snapshot (gLoad, load_i, out(g_i,g_j), kill marks, capacities).
* :func:`repro_torch.core.milp.solve_allocation` — the Table-2 MILP (load balancing
  + integrated scale-in) over migration units.
* :func:`repro_torch.core.albic.albic` — Algorithm 2 (collocation on top of MILP).
* :class:`repro_torch.core.framework.AdaptationFramework` — Algorithm 1.
"""

from repro_torch.core.albic import AlbicParams, AlbicResult, albic
from repro_torch.core.framework import AdaptationFramework, AdaptationResult
from repro_torch.core.migration import (
    Migration,
    MigrationPlan,
    execute_plan,
    plan_from_allocations,
)
from repro_torch.core.milp import AllocationPlan, solve_allocation
from repro_torch.core.scaling import (
    LatencyProxyScaler,
    NullScaler,
    ScalingDecision,
    UtilizationScaler,
    apply_scaling,
)
from repro_torch.core.stats import ClusterState, PairRates, SPLWindow

__all__ = [
    "AdaptationFramework",
    "AdaptationResult",
    "AlbicParams",
    "AlbicResult",
    "albic",
    "AllocationPlan",
    "ClusterState",
    "LatencyProxyScaler",
    "Migration",
    "MigrationPlan",
    "NullScaler",
    "PairRates",
    "ScalingDecision",
    "SPLWindow",
    "UtilizationScaler",
    "apply_scaling",
    "execute_plan",
    "plan_from_allocations",
    "solve_allocation",
]
