"""Flux [36] — adaptive pairwise partition movement (paper §2.2, §5.2.1).

At the end of each period, nodes are sorted by load descending.  The most
loaded node is paired with the least loaded, the 2nd with the 2nd-last, and so
on; within each pair Flux moves the *largest suitable* partition (key group)
from donor to receiver — "suitable" meaning the move reduces the pair's load
imbalance (it must not overshoot past the mean of the pair).  The number of
migrations per period is capped (maxMigrations), which is exactly the knob the
paper matches its MILP against in §5.2.1.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.milp import AllocationPlan
from repro_torch.core.stats import ClusterState


def flux_rebalance(state: ClusterState, *, max_migrations: int = 13) -> AllocationPlan:
    alloc = state.alloc.copy()
    budget = max_migrations
    loads = state.node_loads(alloc).copy()
    live = np.where(state.alive)[0]
    migrations: list[tuple[int, int, int]] = []

    order = live[np.argsort(-loads[live])]
    i, j = 0, len(order) - 1
    while i < j and budget > 0:
        donor, receiver = int(order[i]), int(order[j])
        moved_any = False
        # Keep moving the biggest suitable key group donor→receiver while the
        # pair's imbalance shrinks and budget remains.
        while budget > 0:
            gap = loads[donor] - loads[receiver]
            if gap <= 0:
                break
            kgs = np.where(alloc == donor)[0]
            if len(kgs) == 0:
                break
            # Largest key group that still fits in half the gap (no overshoot).
            g_loads = state.kg_load[kgs] / state.capacity[receiver]
            suitable = kgs[g_loads <= gap / 2.0 + 1e-12]
            if len(suitable) == 0:
                break
            pick = int(suitable[np.argmax(state.kg_load[suitable])])
            alloc[pick] = receiver
            delta = state.kg_load[pick]
            loads[donor] -= delta / state.capacity[donor]
            loads[receiver] += delta / state.capacity[receiver]
            migrations.append((pick, donor, receiver))
            budget -= 1
            moved_any = True
        i += 1
        j -= 1
        if not moved_any and budget <= 0:
            break

    mc = state.migration_costs()
    moved = [m[0] for m in migrations]
    return AllocationPlan(
        alloc=alloc,
        d=float("nan"),
        d_u=0.0,
        d_l=0.0,
        objective=float("nan"),
        status="heuristic",
        solve_seconds=0.0,
        load_distance=state.load_distance(alloc),
        migrations=migrations,
        migration_cost=float(mc[moved].sum()) if moved else 0.0,
    )
