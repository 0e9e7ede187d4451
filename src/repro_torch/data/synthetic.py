"""Stream generators shaped like the paper's three datasets (§5 "Datasets").

The container is offline, so the Wikipedia edit history, Airline On-Time and
NOAA GSOD datasets are reproduced *distributionally*: heavy-tailed entity
popularity (Zipf — Wikipedia article edits famously follow one), diurnal rate
fluctuation, and the attribute schemas the paper's jobs consume.  Each
generator yields (keys, values, ts) batches suitable for
:meth:`repro_torch.engine.Engine.push_source`.

Values are emitted as **native structured arrays** (the declared ingestion
schema's dtype), generated column-wise: the whole batch is one C-level
assembly, so ``push_source`` on a schema-typed source passes the buffer
straight through — no per-tuple record boxing anywhere on the ingestion
edge (the last boxed boundary the ROADMAP named).  Untyped consumers are
unaffected: a structured array ``tolist()``s to the identical record
tuples the old per-tuple generators produced.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class StreamSpec:
    rate: float = 200.0  # tuples per tick (paper: hundreds/s, scaled)
    fluctuation: float = 0.3  # relative amplitude of the rate wave
    period_ticks: float = 200.0
    seed: int = 0


def _rate_at(spec: StreamSpec, tick: int, rng: np.random.Generator) -> int:
    wave = 1.0 + spec.fluctuation * np.sin(2 * np.pi * tick / spec.period_ticks)
    lam = max(spec.rate * wave, 0.0)
    return int(rng.poisson(lam))


# Wikipedia revision record layout: tuples in the ``W_*`` positional order
# below, with the matching structured dtype for schema-typed ingestion.
W_ARTICLE, W_EDITOR, W_BYTES, W_MINOR = range(4)
WIKI_DTYPE = np.dtype(
    [("article", "i8"), ("editor", "i8"), ("bytes_changed", "i8"), ("minor", "?")]
)


def wiki_edit_stream(
    spec: StreamSpec | None = None, *, num_articles: int = 5_000, zipf_a: float = 1.3
) -> Iterator[tuple[np.ndarray, list, np.ndarray]]:
    """Parsed-Wikipedia-edit-history-shaped stream.

    Keys are article ids with Zipf popularity; values carry the ≥14-attribute
    revision record (truncated to what the jobs read) as record tuples in the
    ``W_*`` layout — ``WIKI_DTYPE`` is the corresponding declared schema.
    """
    spec = spec or StreamSpec()
    rng = np.random.default_rng(spec.seed)
    tick = 0
    while True:
        n = _rate_at(spec, tick, rng)
        arts = np.minimum(rng.zipf(zipf_a, size=n) - 1, num_articles - 1)
        values = np.empty(n, dtype=WIKI_DTYPE)
        values["article"] = arts
        values["editor"] = rng.integers(0, 100_000, size=n)
        values["bytes_changed"] = rng.integers(-500, 2_000, size=n)
        values["minor"] = rng.random(n) < 0.3
        ts = np.full(n, float(tick))
        yield arts.astype(np.int64), values, ts
        tick += 1


# Airline On-Time (RITA/DoT 2004–2013): airplane, origin, dest, delays, year.
_NUM_AIRPLANES = 4_000
_NUM_AIRPORTS = 300

# Airline record layout: tuples, not dicts — a typed ingestion schema whose
# columns segment-vectorized operators read as structured column views (or
# extract with one ``zip(*values)`` on the object path).
A_PLANE, A_ORIGIN, A_DEST, A_DEP_DELAY, A_ARR_DELAY, A_YEAR = range(6)
AIRLINE_DTYPE = np.dtype(
    [
        ("plane", "i8"),
        ("origin", "i8"),
        ("dest", "i8"),
        ("dep_delay", "f8"),
        ("arr_delay", "f8"),
        ("year", "i8"),
    ]
)


def airline_stream(
    spec: StreamSpec | None = None,
) -> Iterator[tuple[np.ndarray, list, np.ndarray]]:
    """Airline-On-Time-shaped stream keyed by airplane id (jobs 2–4).

    Values are record tuples in the ``A_*`` layout above.
    """
    spec = spec or StreamSpec()
    rng = np.random.default_rng(spec.seed + 1)
    tick = 0
    while True:
        n = _rate_at(spec, tick, rng)
        planes = np.minimum(rng.zipf(1.2, size=n) - 1, _NUM_AIRPLANES - 1)
        origins = rng.integers(0, _NUM_AIRPORTS, size=n)
        jump = 1 + rng.integers(0, _NUM_AIRPORTS - 1, size=n)
        values = np.empty(n, dtype=AIRLINE_DTYPE)
        values["plane"] = planes
        values["origin"] = origins
        values["dest"] = (origins + jump) % _NUM_AIRPORTS
        values["dep_delay"] = np.maximum(rng.normal(8.0, 20.0, size=n), -10.0)
        values["arr_delay"] = np.maximum(rng.normal(6.0, 25.0, size=n), -20.0)
        values["year"] = 2004 + (tick // 500) % 10
        ts = np.full(n, float(tick))
        yield planes.astype(np.int64), values, ts
        tick += 1


_NUM_STATIONS = 2_000
_MAX_PRECIP = 30.0

# GSOD observation layout: record tuples in the ``WX_*`` positional order.
WX_STATION, WX_PRECIP, WX_TEMP, WX_VIS, WX_AIRPORT = range(5)
WEATHER_DTYPE = np.dtype(
    [
        ("station", "i8"),
        ("precip", "f8"),
        ("mean_temp", "f8"),
        ("visibility", "f8"),
        ("airport", "i8"),
    ]
)


def weather_stream(
    spec: StreamSpec | None = None,
) -> Iterator[tuple[np.ndarray, list, np.ndarray]]:
    """NOAA GSOD-shaped stream keyed by station (job 4 rainscore input).

    Values are record tuples in the ``WX_*`` layout above; stations map onto
    airports for the job-4 join.
    """
    spec = spec or StreamSpec(rate=50.0)
    rng = np.random.default_rng(spec.seed + 2)
    tick = 0
    while True:
        n = _rate_at(spec, tick, rng)
        stations = rng.integers(0, _NUM_STATIONS, size=n)
        values = np.empty(n, dtype=WEATHER_DTYPE)
        values["station"] = stations
        values["precip"] = np.clip(rng.exponential(2.0, size=n), 0.0, _MAX_PRECIP)
        values["mean_temp"] = rng.normal(12.0, 10.0, size=n)
        values["visibility"] = np.clip(rng.normal(9.0, 3.0, size=n), 0.0, 20.0)
        values["airport"] = stations % _NUM_AIRPORTS
        ts = np.full(n, float(tick))
        yield stations.astype(np.int64), values, ts
        tick += 1


def max_precip() -> float:
    """Maximal historically measured precipitation (rainscore denominator)."""
    return _MAX_PRECIP


def num_airports() -> int:
    return _NUM_AIRPORTS
