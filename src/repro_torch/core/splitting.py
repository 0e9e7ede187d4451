"""Hot-key splitting policy: when migration alone cannot balance, split.

Key-group migration — the framework's whole repertoire — moves *whole* key
groups.  A single key group hotter than a node's fair share of the arrival
rate is therefore unbalanceable by any allocator: wherever it lands, that
node overloads (the partial-key-grouping observation; see PAPERS.md).  The
:class:`HotKeySplitter` watches the same ``kg_tuple_rate`` leading signal
the scalers and allocators project with, and when a key group's projected
rate crosses ``hot_frac`` of the per-node fair share it decides to split it
across replicas (``Engine.split_keygroup``).  Cooled families fold back
(``Engine.unsplit_keygroup``) under a hysteresis band so a rate hovering at
the threshold does not thrash.

The decision is *advisory*: :class:`~repro_torch.core.framework.AdaptationFramework`
computes it alongside the allocation plan (same snapshot, same projection)
and the controller applies it against the live engine after the period's
migrations execute — replicas then show up as ordinary key groups in the
next snapshot, so balancing, collocation scoring and migration budgeting
compose with splitting for free.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.scaling import MAX_RATE_GROWTH
from repro_torch.core.stats import ClusterState


@dataclasses.dataclass(frozen=True)
class SplitDecision:
    """Advisory outcome of one period's splitting policy."""

    split: tuple[int, ...] = ()  # parents to split, hottest first
    unsplit: tuple[int, ...] = ()  # cooled families to fold back

    @property
    def acted(self) -> bool:
        return bool(self.split or self.unsplit)


@dataclasses.dataclass
class HotKeySplitter:
    """Threshold policy over the projected per-key-group arrival rate.

    A key group is *hot* when its projected rate exceeds
    ``hot_frac × (total rate / alive nodes)`` — hotter than that, no
    placement balances it, so it splits.  A split family folds back when
    its combined projected rate drops below ``cool_frac`` of the same
    threshold (any ``cool_frac < 1`` leaves a hysteresis band between the
    two, so a rate hovering at the boundary does not thrash).

    Projection mirrors :func:`repro_torch.core.scaling.rate_growth`: each key
    group's rate is scaled by its clipped growth ratio versus the previous
    period, so a flash crowd's ramp triggers the split one period early —
    the same leading-signal treatment the scalers and allocators get.
    """

    hot_frac: float = 0.5
    cool_frac: float = 0.25
    max_splits_per_period: int = 2
    min_rate: float = 0.5
    _prev_rate: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def decide(
        self,
        state: ClusterState,
        families: dict[int, list[int]],
        eligible: Optional[np.ndarray] = None,
    ) -> SplitDecision:
        """One period's split/unsplit picks.

        ``families`` is the engine's live ``split_families()`` map;
        ``eligible`` (bool mask over key groups, or None = all) excludes
        key groups whose operator is not split-mergeable, so the decision
        never asks the engine for an impossible split.
        """
        rate = state.kg_tuple_rate
        if rate is None:
            return SplitDecision()
        proj = rate.astype(np.float64, copy=True)
        prev = self._prev_rate
        if prev is not None and len(prev) == len(rate):
            meaningful = prev >= self.min_rate
            growth = np.ones_like(proj)
            growth[meaningful] = rate[meaningful] / prev[meaningful]
            np.clip(growth, 1.0, MAX_RATE_GROWTH, out=growth)
            proj *= growth
        self._prev_rate = rate.copy()

        alive = int(state.alive.sum())
        total = float(proj.sum())
        if alive == 0 or total <= 0.0:
            return SplitDecision()
        threshold = self.hot_frac * total / alive

        replica_of = {s: p for p, slots in families.items() for s in slots}
        split: list[int] = []
        for kg in np.argsort(-proj, kind="stable").tolist():
            if proj[kg] <= threshold or len(split) >= self.max_splits_per_period:
                break
            if kg in families or kg in replica_of:
                continue  # already spread across a family
            if eligible is not None and not eligible[kg]:
                continue
            split.append(int(kg))

        unsplit: list[int] = []
        for parent in sorted(families):
            fam = [parent] + list(families[parent])
            if float(proj[fam].sum()) < self.cool_frac * threshold:
                unsplit.append(parent)
        return SplitDecision(tuple(split), tuple(unsplit))
