"""Horizontal scaling policies (paper §4.2).

The paper deliberately plugs in *existing* scaling estimators ([10, 12]) —
"developing a novel scaling optimizer is outside the scope".  We do the same:
:class:`UtilizationScaler` is the standard watermark policy used by Gedik et
al. [12]; :class:`LatencyProxyScaler` approximates DRS [10] with an M/M/1-style
latency proxy.  What the paper *does* contribute is the integration contract
(Algorithm 1): the scaler decides **on the basis of the potential allocation
plan**, so load that mere re-balancing or collocation would absorb never
triggers a scale-out, and scale-in is refused when the survivors could not be
balanced.  That contract is enforced in :mod:`repro_torch.core.framework`.

Both scalers additionally consume ``ClusterState.kg_tuple_rate`` — the
per-key-group arrival rates measured from the partition histograms — as a
*leading* load signal: CPU load lags arrivals by up to one statistics period
(tuples admitted late in the period are still queued), so a key group whose
arrival rate is surging will overload its node one period before the
utilization watermark sees it.  The scalers remember the previous period's
rates, project each key group's load forward by its (clipped) rate-growth
ratio, and scale out as soon as the *projected* planned loads breach the
watermark.  The projection only ever raises loads (growth is clipped to
``[1, max growth]``), so it can trigger a scale-out early but never masks
one; scale-in additionally requires the projection to agree, so surging
arrivals also veto premature consolidation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol

import numpy as np

from repro_torch.core.milp import AllocationPlan
from repro_torch.core.stats import ClusterState


@dataclasses.dataclass
class ScalingDecision:
    add_nodes: int = 0
    mark_for_removal: list[int] = dataclasses.field(default_factory=list)

    @property
    def scaled(self) -> bool:
        return self.add_nodes > 0 or bool(self.mark_for_removal)


class Scaler(Protocol):
    def decide(self, state: ClusterState, plan: AllocationPlan) -> ScalingDecision: ...


# Per-key-group rate growth is clipped to this factor before projecting load
# forward: small-sample Poisson noise easily produces 2× single-kg ratios,
# but a genuine hotspot sustains them across most of its tuples, so the cap
# bounds the damage of noise while keeping real surges visible.
MAX_RATE_GROWTH = 4.0


def rate_growth(
    state: ClusterState,
    prev_rate: Optional[np.ndarray],
    *,
    max_growth: float = MAX_RATE_GROWTH,
    min_rate: float = 0.5,
) -> Optional[np.ndarray]:
    """Per-key-group arrival-rate growth ratios versus the previous period.

    Clipped to ``[1, max_growth]``; key groups below ``min_rate``
    tuples/tick previously stay at 1 — their ratios are noise.  Returns
    None when rates are unavailable for either period.  This is the shared
    leading-load signal: the scalers and ALBIC's step-3 scoring project
    node loads with it, and :func:`repro_torch.core.milp.solve_allocation` scales
    its gLoad vector by it so the balance objective itself anticipates the
    surge.
    """
    cur = state.kg_tuple_rate
    if cur is None or prev_rate is None or len(prev_rate) != len(cur):
        return None
    growth = np.ones_like(cur)
    meaningful = prev_rate >= min_rate
    growth[meaningful] = cur[meaningful] / prev_rate[meaningful]
    np.clip(growth, 1.0, max_growth, out=growth)
    return growth


def projected_loads(
    state: ClusterState,
    alloc: np.ndarray,
    prev_rate: Optional[np.ndarray],
    *,
    max_growth: float = MAX_RATE_GROWTH,
    min_rate: float = 0.5,
) -> Optional[np.ndarray]:
    """Planned node loads one period ahead, using arrival-rate growth.

    Each key group's measured ``gLoad`` is scaled by its
    :func:`rate_growth` ratio.  Returns None when rates are unavailable for
    either period, so callers fall back to utilization-only behaviour.
    """
    growth = rate_growth(
        state, prev_rate, max_growth=max_growth, min_rate=min_rate
    )
    if growth is None:
        return None
    raw = np.bincount(alloc, weights=state.kg_load * growth, minlength=state.num_nodes)
    return raw / state.capacity


def _take_rate_projection(scaler, state: ClusterState, alloc: np.ndarray):
    """One period's leading-load bookkeeping, shared by both scalers: compute
    the projected planned loads from the previous period's rates (None when
    disabled or unavailable), then remember this period's rates."""
    proj = (
        projected_loads(state, alloc, scaler._prev_rate)
        if scaler.use_rate_signal
        else None
    )
    scaler._prev_rate = (
        None if state.kg_tuple_rate is None else state.kg_tuple_rate.copy()
    )
    return proj


@dataclasses.dataclass
class UtilizationScaler:
    """Watermark policy over the *planned* (not current) node loads.

    Scale out when the planned average load exceeds ``high_wm`` (enough nodes
    to bring it to ``target``); scale in when it sits below ``low_wm`` and the
    survivors stay under ``target`` — Algorithm 1 re-plans afterwards and will
    veto the removal if balance under ``maxLD`` is unattainable.

    With ``use_rate_signal`` (default) the per-key-group arrival rates lead
    the decision: loads projected by rate growth can breach ``high_wm`` a
    period before the measured loads do, and surging rates veto scale-in.
    """

    high_wm: float = 80.0
    low_wm: float = 40.0
    target: float = 60.0
    max_step: int = 8  # nodes added/removed per adaptation round
    use_rate_signal: bool = True
    _prev_rate: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def decide(self, state: ClusterState, plan: AllocationPlan) -> ScalingDecision:
        a = state.nodes_a
        if len(a) == 0:
            return ScalingDecision(add_nodes=1)
        proj = _take_rate_projection(self, state, plan.alloc)
        loads = state.node_loads(plan.alloc)
        avg = float(loads[a].mean())
        total = float((loads[a] * state.capacity[a]).sum())
        if avg > self.high_wm:
            want = math.ceil(total / self.target)
            return ScalingDecision(add_nodes=min(max(want - len(a), 1), self.max_step))
        if proj is not None and float(proj[a].mean()) > self.high_wm:
            # Leading signal: arrivals are surging into key groups whose load
            # will breach the watermark next period — provision now.
            total_p = float((proj[a] * state.capacity[a]).sum())
            want = math.ceil(total_p / self.target)
            return ScalingDecision(add_nodes=min(max(want - len(a), 1), self.max_step))
        if (
            avg < self.low_wm
            and len(a) > 1
            and (proj is None or float(proj[a].mean()) < self.low_wm)
        ):
            keep = max(math.ceil(total / self.target), 1)
            drop = min(len(a) - keep, self.max_step)
            if drop <= 0:
                return ScalingDecision()
            # Prefer removing the least-loaded nodes: cheapest to drain.
            order = a[np.argsort(loads[a])]
            return ScalingDecision(mark_for_removal=[int(i) for i in order[:drop]])
        return ScalingDecision()


@dataclasses.dataclass
class LatencyProxyScaler:
    """DRS-style [10] latency-constrained sizing with an M/M/1 proxy.

    Expected queueing delay on a node with utilization ρ scales as ρ/(1−ρ);
    size the cluster so the *maximum planned* utilization keeps the proxy
    under ``latency_budget`` (expressed in the same arbitrary units).

    Like :class:`UtilizationScaler`, the per-key-group arrival rates lead
    the decision: a hotspot key group whose rate is surging breaches the
    *projected* peak utilization one period before the measured one.
    """

    latency_budget: float = 4.0  # ρ/(1−ρ) ≤ budget  ⇒  ρ ≤ b/(1+b)
    max_step: int = 8
    use_rate_signal: bool = True
    _prev_rate: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def decide(self, state: ClusterState, plan: AllocationPlan) -> ScalingDecision:
        a = state.nodes_a
        if len(a) == 0:
            return ScalingDecision(add_nodes=1)
        proj = _take_rate_projection(self, state, plan.alloc)
        rho_cap = 100.0 * self.latency_budget / (1.0 + self.latency_budget)
        loads = state.node_loads(plan.alloc)
        peak = float(loads[a].max())
        total = float((loads[a] * state.capacity[a]).sum())
        if peak > rho_cap:
            want = math.ceil(total / rho_cap)
            return ScalingDecision(add_nodes=min(max(want - len(a), 1), self.max_step))
        if proj is not None and float(proj[a].max()) > rho_cap:
            total_p = float((proj[a] * state.capacity[a]).sum())
            want = math.ceil(total_p / rho_cap)
            return ScalingDecision(add_nodes=min(max(want - len(a), 1), self.max_step))
        # Scale in when even after consolidation the cap holds with slack —
        # unless the projection says the slack is about to vanish.
        if len(a) > 1 and (proj is None or float(proj[a].max()) <= rho_cap):
            keep = max(math.ceil(total / (0.8 * rho_cap)), 1)
            drop = min(len(a) - keep, self.max_step)
            if drop > 0:
                order = a[np.argsort(loads[a])]
                return ScalingDecision(mark_for_removal=[int(i) for i in order[:drop]])
        return ScalingDecision()


@dataclasses.dataclass
class NullScaler:
    """Never scales — pure load-balancing mode (used by several benchmarks)."""

    def decide(  # noqa: ARG002
        self, state: ClusterState, plan: AllocationPlan
    ) -> ScalingDecision:
        return ScalingDecision()


def apply_scaling(
    state: ClusterState,
    decision: ScalingDecision,
    *,
    new_node_capacity: float = 1.0,
) -> ClusterState:
    """Materialize a scaling decision on the cluster snapshot.

    Adding nodes grows every per-node array (simulating instant provisioning;
    Algorithm 1's "wait until new nodes are allocated").  Marking nodes only
    flips ``kill`` — draining and termination are the MILP's and the
    framework's job respectively (Lemmas 1–2).
    """
    out = state.copy()
    if decision.add_nodes > 0:
        n_new = decision.add_nodes
        out.num_nodes += n_new
        out.capacity = np.concatenate([out.capacity, np.full(n_new, new_node_capacity)])
        out.kill = np.concatenate([out.kill, np.zeros(n_new, dtype=bool)])
        out.alive = np.concatenate([out.alive, np.ones(n_new, dtype=bool)])
    for i in decision.mark_for_removal:
        out.kill[i] = True
    return out
