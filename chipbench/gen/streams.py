"""Frozen copies of the port's dataset streams (the benchmark's yardstick).

Copied from ``src/repro_torch/data/synthetic.py`` as of commit 1b40d26:
``StreamSpec``, ``_rate_at``, ``WIKI_DTYPE``/``wiki_edit_stream``,
``AIRLINE_DTYPE``/``airline_stream``, with every distribution unchanged
but one.  The edits: the shape constants the original keeps at module level
(articles, airplanes, airports, Zipf exponents) are keyword arguments whose
defaults are those constants, so a configuration file states them; and
``zipf_tail`` chooses how a key is drawn.  ``"clamp"`` (the default) is the
original's ``min(zipf(a) - 1, n - 1)``, which piles every draw past the
range onto the last key (17 % of airline tuples on plane 3,999 at a = 1.2);
``"truncate"`` draws from the Zipf law truncated to the range, p(k) ∝
(k + 1)^-a for k < n, by inverse transform of one uniform draw a key.
``chipbench/tests/test_chipbench_gen.py`` holds the ``"clamp"`` copies
equal to the port's at the defaults; a later change to the port's
generators does not move the benchmark's load.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class StreamSpec:
    rate: float = 200.0  # tuples per tick
    fluctuation: float = 0.3  # relative amplitude of the rate wave
    period_ticks: float = 200.0
    seed: int = 0


def _zipf_keys(rng: np.random.Generator, a: float, n_keys: int, size: int,
               tail: str) -> np.ndarray:
    if tail == "clamp":
        return np.minimum(rng.zipf(a, size=size) - 1, n_keys - 1)
    if tail == "truncate":
        cdf = np.cumsum(np.arange(1, n_keys + 1, dtype=np.float64) ** -a)
        cdf /= cdf[-1]
        return np.searchsorted(cdf, rng.random(size), side="right").astype(np.int64)
    raise ValueError(f"unknown zipf_tail {tail!r}")


def _rate_at(spec: StreamSpec, tick: int, rng: np.random.Generator) -> int:
    wave = 1.0 + spec.fluctuation * np.sin(2 * np.pi * tick / spec.period_ticks)
    lam = max(spec.rate * wave, 0.0)
    return int(rng.poisson(lam))


WIKI_DTYPE = np.dtype(
    [("article", "i8"), ("editor", "i8"), ("bytes_changed", "i8"), ("minor", "?")]
)


def wiki_edit_stream(
    spec: StreamSpec | None = None,
    *,
    num_articles: int = 5_000,
    zipf_a: float = 1.3,
    zipf_tail: str = "clamp",
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Wikipedia-edit-shaped stream: article ids with Zipf popularity."""
    spec = spec or StreamSpec()
    rng = np.random.default_rng(spec.seed)
    tick = 0
    while True:
        n = _rate_at(spec, tick, rng)
        arts = _zipf_keys(rng, zipf_a, num_articles, n, zipf_tail)
        values = np.empty(n, dtype=WIKI_DTYPE)
        values["article"] = arts
        values["editor"] = rng.integers(0, 100_000, size=n)
        values["bytes_changed"] = rng.integers(-500, 2_000, size=n)
        values["minor"] = rng.random(n) < 0.3
        ts = np.full(n, float(tick))
        yield arts.astype(np.int64), values, ts
        tick += 1


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


def airline_year(tick: int) -> int:
    """The airline stream's year column at a stream tick."""
    return 2004 + (tick // 500) % 10


def airline_stream(
    spec: StreamSpec | None = None,
    *,
    num_airplanes: int = 4_000,
    num_airports: int = 300,
    zipf_a: float = 1.2,
    zipf_tail: str = "clamp",
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Airline-On-Time-shaped stream keyed by airplane id."""
    spec = spec or StreamSpec()
    rng = np.random.default_rng(spec.seed + 1)
    tick = 0
    while True:
        n = _rate_at(spec, tick, rng)
        planes = _zipf_keys(rng, zipf_a, num_airplanes, n, zipf_tail)
        origins = rng.integers(0, num_airports, size=n)
        jump = 1 + rng.integers(0, num_airports - 1, size=n)
        values = np.empty(n, dtype=AIRLINE_DTYPE)
        values["plane"] = planes
        values["origin"] = origins
        values["dest"] = (origins + jump) % num_airports
        values["dep_delay"] = np.maximum(rng.normal(8.0, 20.0, size=n), -10.0)
        values["arr_delay"] = np.maximum(rng.normal(6.0, 25.0, size=n), -20.0)
        values["year"] = airline_year(tick)
        ts = np.full(n, float(tick))
        yield planes.astype(np.int64), values, ts
        tick += 1


def _retime_airline(values: np.ndarray, tick: int) -> None:
    values["year"] = airline_year(tick)


#: Per stream, what a replayed batch rewrites when it is handed over at a
#: later stream tick (beyond its timestamps): the airline year.
RETIME = {"airline_stream": _retime_airline}
