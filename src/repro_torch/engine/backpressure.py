"""Short-term fluctuation handling: bounded queues + credit-based backpressure.

The paper (§3, "Workload Fluctuations") distinguishes short-term spikes —
handled by buffering/backpressure — from the long-term balance its optimizer
maintains.  This module provides the short-term half so the engine exhibits
the same dynamics: an overloaded node grows a queue, queueing latency rises,
and sources are throttled when depth crosses the high watermark.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CreditController:
    """Grants per-tick source credits from global queue depth.

    Credits scale linearly from `full_credit` (all queues empty) to 0 (any
    node at `high_wm` cost-units of queued work).
    """

    num_nodes: int
    high_wm: float = 500.0
    full_credit: int = 10_000

    def credits(self, queue_costs: np.ndarray) -> int:
        worst = float(queue_costs.max()) if len(queue_costs) else 0.0
        return self.credits_from_worst(worst)

    def credits_from_worst(self, worst: float) -> int:
        """Scalar form: credits given the deepest queue's cost-units."""
        frac = max(0.0, 1.0 - worst / self.high_wm)
        return int(self.full_credit * frac)


@dataclasses.dataclass
class LatencyTracker:
    """Queueing-latency samples (ticks) with cheap percentile queries.

    Samples are stored as (value, weight) pairs — weight is the number of
    tuples the sample covers, capped at 16 — and expanded only at query time,
    so the record path is one list append per admission.
    """

    samples: list[tuple[float, int]] = dataclasses.field(default_factory=list)

    def record(self, latency_ticks: float, weight: int = 1) -> None:
        self.samples.append((latency_ticks, min(weight, 16)))

    def summary(self) -> dict[str, float]:
        if not self.samples:
            return {"avg": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0}
        vals = np.fromiter(
            (v for v, _ in self.samples),
            np.float64,
            count=len(self.samples),
        )
        wts = np.fromiter(
            (w for _, w in self.samples),
            np.int64,
            count=len(self.samples),
        )
        arr = np.repeat(vals, wts)
        return {
            "avg": float(arr.mean()),
            "p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99)),
            "max": float(arr.max()),
        }

    def reset(self) -> None:
        self.samples.clear()
