"""Skew workload scenarios: deterministic, seed-threaded stream generation.

The paper's comparative claims (ALBIC/MILP vs COLA/Flux/PoTC) only
differentiate on *skewed, drifting* workloads — power-law key popularity,
flash crowds, diurnal traffic, key churn ("Parallel Stream Processing
Against Workload Skewness and Variance", AutoFlow).  This module generates
exactly those shapes as batched (keys, values, ts) streams, composable per
scenario through one small :class:`ScenarioSpec` value.

The composition model is a per-tick **weight vector** over a fixed key
space: a base Zipf/power-law popularity pmf, multiplied elementwise by the
flash-crowd boost (step or ramp on the top-ranked hot-key set), the diurnal
cohort multipliers (phase-shifted sinusoids over key cohorts, so the hot
cohort *rotates* instead of the whole stream merely breathing), and the
churn liveness mask (each key alive for ``lifetime_ticks`` out of every
``2·lifetime_ticks``, phases randomized once per stream).  The tick's
arrival count is Poisson with mean ``rate × Σw(t)`` — a flash crowd adds
traffic, it does not just reshape it — and keys are drawn from the
normalized weights.

Determinism contract: a scenario stream is a pure function of its spec.
All randomness flows from one ``np.random.default_rng(spec.seed)`` created
at stream start and consumed in a fixed order, so two streams built from
equal specs are **byte-identical** tick by tick (pinned by the hypothesis
property test in ``tests/test_workloads.py``), and any seed change reshapes
the whole stream.  Nothing here reads global RNG state or wall-clock time.

Batches are schema-typed: values are native :data:`SCENARIO_DTYPE`
structured arrays (the :mod:`repro_torch.data.synthetic` idiom), so a source
declaring :func:`scenario_schema` ingests them without boxing; untyped
sources receive the identical record tuples via the object path.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.engine.topology import Batch, Schema

# Record layout of scenario tuples: the partition-key entity plus a float
# payload operators can aggregate (weights are part of the determinism
# contract — they are drawn from the stream's rng like everything else).
SCENARIO_DTYPE = np.dtype([("entity", "i8"), ("weight", "f8")])


def scenario_schema() -> Schema:
    """The ingestion :class:`~repro_torch.engine.topology.Schema` for scenario
    streams (declare it on the source operator for boxing-free ingestion)."""
    return Schema(value=SCENARIO_DTYPE, key=np.dtype(np.int64))


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    """A surge of the ``hot_keys`` most popular keys.

    The hot set's popularity mass is multiplied by ``1 + (boost−1)·f(t)``
    where ``f`` rises from 0 to 1 starting at ``at_tick`` — as a step when
    ``ramp_ticks == 0``, linearly over ``ramp_ticks`` otherwise — holds 1
    for ``duration`` ticks (forever when None), then steps back to 0.
    Because weights are unnormalized, the surge raises the total arrival
    rate too, like a real crowd.
    """

    at_tick: int = 0
    hot_keys: int = 2
    boost: float = 16.0
    ramp_ticks: int = 0
    duration: Optional[int] = None

    def factor(self, tick: int) -> float:
        dt = tick - self.at_tick
        if dt < 0:
            return 0.0
        if self.duration is not None and dt >= max(self.ramp_ticks, 0) + self.duration:
            return 0.0
        if self.ramp_ticks > 0 and dt < self.ramp_ticks:
            return dt / self.ramp_ticks
        return 1.0


@dataclasses.dataclass(frozen=True)
class Diurnal:
    """Sinusoidal rate modulation with phase-shifted key cohorts.

    Key rank ``r`` belongs to cohort ``r % cohorts``; cohort ``c``'s weight
    is multiplied by ``1 + amplitude·sin(2π·t/period + 2π·c/cohorts)``
    (clipped at 0).  With one cohort the stream merely breathes; with
    several, popularity *drifts* — the hot cohort rotates once per period,
    the workload shape migration has to chase.
    """

    period_ticks: float = 200.0
    amplitude: float = 0.6
    cohorts: int = 4

    def multipliers(self, tick: int) -> np.ndarray:
        phase = 2.0 * np.pi * np.arange(self.cohorts) / self.cohorts
        wave = np.sin(2.0 * np.pi * tick / self.period_ticks + phase)
        return np.maximum(1.0 + self.amplitude * wave, 0.0)


@dataclasses.dataclass(frozen=True)
class Churn:
    """Birth/death of keys: each key alive ``lifetime_ticks`` out of every
    ``2·lifetime_ticks``, with per-key phases drawn once at stream start —
    so roughly half the key space is alive at any tick and the alive set
    turns over completely every lifetime."""

    lifetime_ticks: int = 64


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One composable skew scenario (see the module docstring).

    Attributes:
      name: label (benchmark row names, registry key).
      rate: mean tuples per tick at weight-sum 1 (Poisson).
      key_space: number of distinct keys.
      zipf_a: power-law exponent of the base popularity pmf
        (``p(rank) ∝ (rank+1)^-zipf_a``); 0 → uniform.
      flash / diurnal / churn: optional modulation components.
      seed: the single root seed every draw derives from.
    """

    name: str = "zipf"
    rate: float = 512.0
    key_space: int = 4096
    zipf_a: float = 1.2
    flash: Optional[FlashCrowd] = None
    diurnal: Optional[Diurnal] = None
    churn: Optional[Churn] = None
    seed: int = 0

    def __post_init__(self) -> None:
        if self.key_space < 1:
            raise ValueError("key_space must be >= 1")
        if self.rate < 0:
            raise ValueError("rate must be >= 0")
        if self.zipf_a < 0:
            raise ValueError("zipf_a must be >= 0 (0 = uniform)")


def _base_pmf(spec: ScenarioSpec) -> np.ndarray:
    ranks = np.arange(1, spec.key_space + 1, dtype=np.float64)
    p = ranks ** (-spec.zipf_a) if spec.zipf_a > 0 else np.ones_like(ranks)
    return p / p.sum()


def scenario_stream(spec: ScenarioSpec) -> Iterator[Batch]:
    """Infinite per-tick batch iterator for one scenario.

    Yields ``(keys, values, ts)`` with int64 keys, :data:`SCENARIO_DTYPE`
    values and a constant-per-tick float64 ``ts``; ticks may be empty
    (zero-length arrays) when the Poisson draw is 0.
    """
    rng = np.random.default_rng(spec.seed)
    p = _base_pmf(spec)
    # Rank → key id: a seeded shuffle so popularity rank and key identity
    # (hence key-group placement) are decoupled.
    perm = rng.permutation(spec.key_space).astype(np.int64)
    cohort = (
        np.arange(spec.key_space) % spec.diurnal.cohorts
        if spec.diurnal is not None
        else None
    )
    churn_phase = (
        rng.integers(0, 2 * spec.churn.lifetime_ticks, size=spec.key_space)
        if spec.churn is not None
        else None
    )
    tick = 0
    while True:
        w = p
        if spec.flash is not None:
            f = spec.flash.factor(tick)
            if f > 0.0:
                w = w.copy()
                w[: spec.flash.hot_keys] *= 1.0 + (spec.flash.boost - 1.0) * f
        if spec.diurnal is not None:
            w = w * spec.diurnal.multipliers(tick)[cohort]
        if spec.churn is not None:
            L = spec.churn.lifetime_ticks
            alive = (tick + churn_phase) % (2 * L) < L
            if not alive.any():  # never emit from an all-dead key space
                alive = np.ones(spec.key_space, dtype=bool)
            w = np.where(alive, w, 0.0)
        total = float(w.sum())
        n = int(rng.poisson(spec.rate * total))
        ranks = rng.choice(spec.key_space, size=n, p=w / total)
        keys = perm[ranks]
        values = np.empty(n, dtype=SCENARIO_DTYPE)
        values["entity"] = keys
        values["weight"] = rng.exponential(1.0, size=n)
        yield keys, values, np.full(n, float(tick))
        tick += 1


def scenario_batches(spec: ScenarioSpec, ticks: int) -> list[Batch]:
    """The first ``ticks`` batches of :func:`scenario_stream`, materialized
    (the shape ``Engine.run_supersteps`` / ``ClusterEngine.run_stream``
    consume)."""
    stream = scenario_stream(spec)
    return [next(stream) for _ in range(ticks)]


def drive_scenario(engine, source, spec: ScenarioSpec, ticks: int) -> int:
    """Feed a scenario into a live engine: one ``push_source`` + ``tick``
    per generated batch (works on every execution tier — the engine's
    ingestion edge handles typed and untyped sources alike).  Returns the
    number of tuples accepted past the backpressure gate."""
    accepted = 0
    for keys, values, ts in scenario_batches(spec, ticks):
        if len(keys):
            accepted += engine.push_source(source, keys, values, ts)
        engine.tick()
    return accepted


# -- named scenario grid -------------------------------------------------------
def make_scenario(
    name: str,
    *,
    rate: float = 512.0,
    key_space: int = 4096,
    seed: int = 0,
) -> ScenarioSpec:
    """The four canonical grid scenarios (``benchmarks/skew_grid.py``).

    ``zipf``: stationary power-law popularity (a = 1.2).
    ``flash_crowd``: mild zipf plus a 16× step surge of the top 2 keys.
    ``diurnal``: four phase-shifted cohorts, ±60% sinusoidal swing.
    ``churn``: zipf popularity over a key space turning over every 64 ticks.
    """
    if name == "zipf":
        return ScenarioSpec(
            name=name, rate=rate, key_space=key_space, zipf_a=1.2, seed=seed
        )
    if name == "flash_crowd":
        return ScenarioSpec(
            name=name,
            rate=rate,
            key_space=key_space,
            zipf_a=0.8,
            flash=FlashCrowd(at_tick=16, hot_keys=2, boost=16.0, ramp_ticks=0),
            seed=seed,
        )
    if name == "flash_ramp":
        return ScenarioSpec(
            name=name,
            rate=rate,
            key_space=key_space,
            zipf_a=0.8,
            flash=FlashCrowd(at_tick=16, hot_keys=2, boost=16.0, ramp_ticks=24),
            seed=seed,
        )
    if name == "diurnal":
        return ScenarioSpec(
            name=name,
            rate=rate,
            key_space=key_space,
            zipf_a=1.0,
            diurnal=Diurnal(period_ticks=48.0, amplitude=0.6, cohorts=4),
            seed=seed,
        )
    if name == "churn":
        return ScenarioSpec(
            name=name,
            rate=rate,
            key_space=key_space,
            zipf_a=1.2,
            churn=Churn(lifetime_ticks=64),
            seed=seed,
        )
    raise ValueError(f"unknown scenario {name!r} (see make_scenario docstring)")


#: The canonical grid, in benchmark row order.
GRID_SCENARIOS = ("zipf", "flash_crowd", "diurnal", "churn")
