"""The Power of Two Choices (PoTC) [29] (paper §2.2, §5.2.1).

Each key x has two candidate downstream instances h1(x), h2(x); every sender
routes x's tuples to whichever candidate is currently less loaded.  State for
a key is therefore *split* across two instances and must be merged (each
window) before the final computation — a continuous overhead that exists even
when no balancing is needed, and whose cost varies with the split state sizes,
skewing load in a way PoTC itself does not see (the effect the paper
demonstrates in Fig. 6).

This simulator reproduces those dynamics at key-group granularity: each key
group k has two candidate nodes (hash-derived); per period its input rate is
routed greedily to the lighter candidate; merge load proportional to the
*smaller* split fraction's accumulated state is charged to the candidate
hosting the merge (the first hash choice — the merge "cannot be balanced").
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.stats import ClusterState


@dataclasses.dataclass
class PotcSimulator:
    state: ClusterState
    merge_cost_factor: float = 0.25  # load points of merge per split-state unit
    seed: int = 0

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        g, n = self.state.num_keygroups, self.state.num_nodes
        self.h1 = rng.integers(0, n, size=g)
        self.h2 = (self.h1 + 1 + rng.integers(0, n - 1, size=g)) % n
        # Fraction of each key group's state accumulated at its h2 replica.
        self.split_frac = np.zeros(g)

    def step(self, kg_load: np.ndarray) -> tuple[np.ndarray, float]:
        """One SPL: greedy two-choice routing; returns (node_loads, load_distance)."""
        n = self.state.num_nodes
        loads = np.zeros(n)
        # Route in descending-load order (heavy hitters first, as senders do).
        order = np.argsort(-kg_load)
        for k in order:
            a, b = int(self.h1[k]), int(self.h2[k])
            if loads[a] <= loads[b]:
                loads[a] += kg_load[k]
                self.split_frac[k] = 0.9 * self.split_frac[k]  # decays toward h1
            else:
                loads[b] += kg_load[k]
                self.split_frac[k] = 0.9 * self.split_frac[k] + 0.1
        # Merge overhead: charged at h1, proportional to split state moved.
        for k in range(len(kg_load)):
            split = min(self.split_frac[k], 1.0 - self.split_frac[k]) * 2.0
            loads[self.h1[k]] += (
                self.merge_cost_factor * split * self.state.kg_state_bytes[k] * 0.01
            )
        loads = loads / self.state.capacity
        live = self.state.nodes_a
        mean = loads[live].mean() if len(live) else 0.0
        ld = float(np.max(np.abs(loads[live] - mean))) if len(live) else 0.0
        return loads, ld

    @property
    def continuous_overhead(self) -> float:
        """Total merge load charged last period even with perfect balance."""
        split = np.minimum(self.split_frac, 1.0 - self.split_frac) * 2.0
        return float(
            (self.merge_cost_factor * split * self.state.kg_state_bytes * 0.01).sum()
        )
