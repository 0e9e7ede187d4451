"""Deterministic fault injection for the multi-worker runtime.

A :class:`FaultPlan` is a seeded, fully materialized schedule of fault
events — SIGKILL a worker, wedge it in a busy-hang, or delay its command
loop — keyed on coordinator-observed progress (tick number or SPL period
boundary).  Because the coordinator applies events at deterministic points
of its own control flow, a plan plus an engine seed reproduces the same
failure interleaving run after run: the 25-run fault soak becomes a chaos
*suite*, not a dice roll.

Injection points (see :class:`repro_torch.engine.cluster.ClusterEngine`):

* ``at_tick=t``   — applied immediately before tick ``t`` is commanded.
* ``at_period=p`` — applied at the end of the ``p``-th ``end_period()``
  call (1-indexed), *after* the window fold and any checkpoint, so a kill
  lands between periods the way a real mid-stream crash does.

Kills are raw ``SIGKILL`` from the coordinator (no cooperation from the
victim); hangs and delays ship to the worker as a ``("fault", ...)``
command it executes in-line, which is exactly what a wedged or slow
command loop looks like from the outside.

A copy of ``repro.engine.faults``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

#: Supported fault kinds.
KINDS = ("kill", "hang", "delay")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault against one worker.

    Exactly one of ``at_tick`` / ``at_period`` must be set.  ``seconds``
    sizes hangs and delays (ignored for kills); ``ignore_term`` makes a
    hang also ignore SIGTERM — the shutdown-escalation worst case.
    """

    kind: str
    worker: int
    at_tick: Optional[int] = None
    at_period: Optional[int] = None
    seconds: float = 60.0
    ignore_term: bool = False

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if (self.at_tick is None) == (self.at_period is None):
            raise ValueError("exactly one of at_tick/at_period must be set")
        if self.worker < 0:
            raise ValueError("worker must be >= 0")
        if self.seconds < 0:
            raise ValueError("seconds must be >= 0")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of :class:`FaultEvent`\\ s."""

    events: tuple[FaultEvent, ...] = ()

    @classmethod
    def of(cls, events: Iterable[FaultEvent]) -> "FaultPlan":
        return cls(events=tuple(events))

    @classmethod
    def kill_at_period(cls, worker: int, period: int) -> "FaultPlan":
        """The canonical scenario: SIGKILL one worker at a period boundary."""
        return cls(events=(FaultEvent("kill", worker, at_period=period),))

    @classmethod
    def random(
        cls,
        seed: int,
        *,
        num_workers: int,
        periods: int,
        events: int = 3,
        kinds: tuple[str, ...] = ("kill", "hang", "delay"),
        hang_seconds: float = 0.5,
    ) -> "FaultPlan":
        """Draw a reproducible plan: ``events`` faults over ``periods``.

        Workers are drawn uniformly; worker 0 is a valid victim like any
        other.  Events are sorted by period so application order matches
        schedule order.  ``hang_seconds`` bounds hang/delay durations so a
        seeded chaos run stays bounded even when escalation is disabled.
        """
        if num_workers < 2:
            raise ValueError("fault plans target the multi-worker runtime")
        rng = np.random.default_rng(
            [np.uint32(seed), np.uint32(0xFA17)]  # domain-separated stream
        )
        drawn = []
        for _ in range(events):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            drawn.append(
                FaultEvent(
                    kind=kind,
                    worker=int(rng.integers(0, num_workers)),
                    at_period=int(rng.integers(1, periods + 1)),
                    seconds=float(rng.uniform(0.05, hang_seconds)),
                )
            )
        drawn.sort(key=lambda e: (e.at_period, e.worker, e.kind))
        return cls(events=tuple(drawn))

    def at_tick(self, tick: int) -> list[FaultEvent]:
        return [e for e in self.events if e.at_tick == tick]

    def at_period(self, period: int) -> list[FaultEvent]:
        return [e for e in self.events if e.at_period == period]
