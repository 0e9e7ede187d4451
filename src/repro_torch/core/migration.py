"""Direct state migration (paper §3, "State Migration"; Madsen & Zhou [27]).

Moving key group g_k from n1 to n2:

  1. upstream instances are told to *redirect* new tuples for g_k to n2;
  2. n2 buffers the redirected tuples;
  3. n1 serializes σ_k — plus g_k's queued backlog, extracted at redirect —
     and ships the envelope to n2 (schema-typed engines encode the backlog
     as raw buffer slices; see repro_torch.engine.serde);
  4. n2 deserializes, reconstructs g_k, replays backlog + buffer, resumes.

The cost model is mc_k = α·|σ_k| — the serialization time on an average-loaded
node.  The adaptation algorithms are independent of the mechanism (paper:
alternative techniques [9, 27, 40] can be swapped in), so this module exposes
a :class:`MigrationPlan` plus an executor protocol; the streaming engine and
the LM serving/training planes each implement the executor against their own
state (keyed pytrees / KV pages / expert weights).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Protocol

import numpy as np

from repro_torch.core.stats import ClusterState


@dataclasses.dataclass(frozen=True)
class Migration:
    keygroup: int
    src: int
    dst: int
    cost: float  # mc_k


@dataclasses.dataclass
class MigrationPlan:
    moves: list[Migration]

    @property
    def total_cost(self) -> float:
        return sum(m.cost for m in self.moves)

    @property
    def num_migrations(self) -> int:
        return len(self.moves)

    def by_source(self) -> dict[int, list[Migration]]:
        out: dict[int, list[Migration]] = {}
        for m in self.moves:
            out.setdefault(m.src, []).append(m)
        return out


def plan_from_allocations(
    state: ClusterState,
    new_alloc: np.ndarray,
    *,
    alpha: float = 1.0,
) -> MigrationPlan:
    mc = state.migration_costs(alpha)
    moves = [
        Migration(int(k), int(state.alloc[k]), int(new_alloc[k]), float(mc[k]))
        for k in np.where(new_alloc != state.alloc)[0]
    ]
    return MigrationPlan(moves=moves)


class StateMover(Protocol):
    """What an execution plane must provide for direct state migration."""

    def redirect(self, keygroup: int, dst: int) -> None:
        """Point upstream routing for `keygroup` at `dst` (starts buffering)."""

    def serialize(self, keygroup: int) -> bytes:
        """Extract σ_k from its current owner."""

    def install(self, keygroup: int, dst: int, blob: bytes) -> None:
        """Reconstruct σ_k at `dst` and replay the buffered tuples."""


@dataclasses.dataclass
class MigrationReport:
    applied: int
    total_cost: float
    pause_seconds: float  # summed per-key-group pause (paper Fig. 9 metric)
    # Total serialized envelope bytes shipped (σ_k state + queued segments;
    # schema-typed engines encode the segments as raw buffer slices, so this
    # is the real wire cost the α·|σ_k| model approximates).
    bytes_moved: int = 0


def execute_plan(
    plan: MigrationPlan,
    mover: StateMover,
    *,
    measure: bool = True,
) -> MigrationReport:
    """Run direct state migration for every move in the plan.

    The pause of one key group spans serialize→install (steps 3–4); redirect
    and buffering keep upstream flowing meanwhile — this is what keeps the
    paper's per-key-group latency at ~2.5 s rather than a full-job stall.
    """
    pause = 0.0
    bytes_moved = 0
    for m in plan.moves:
        mover.redirect(m.keygroup, m.dst)
        t0 = time.perf_counter() if measure else 0.0
        blob = mover.serialize(m.keygroup)
        mover.install(m.keygroup, m.dst, blob)
        if measure:
            pause += time.perf_counter() - t0
        bytes_moved += len(blob)
    return MigrationReport(
        applied=len(plan.moves),
        total_cost=plan.total_cost,
        pause_seconds=pause,
        bytes_moved=bytes_moved,
    )


def apply_to_state(state: ClusterState, moves: Iterable[Migration]) -> None:
    """Bookkeeping-only application (simulation paths, benchmarks)."""
    for m in moves:
        state.alloc[m.keygroup] = m.dst
