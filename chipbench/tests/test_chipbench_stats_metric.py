"""The reader of routing's send-statistics counter
(``EngineMetrics.stats_seconds``), by hand on a made record, and on records
that lack the counter (a program without it) or read 0."""

import json
from pathlib import Path

import pytest

from chipbench.harness import metric_reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "route_stats_ms_per_tick.saturate"


def test_entry_in_the_benchmark():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "ms", "lower", "program_span", "Routing", "tuples_per_s")
    assert m["workloads"] == [w["name"] for w in BENCH["workloads"]]
    assert BENCH["per_layer"][-1] is m  # appended after every accepted metric


@pytest.mark.parametrize("seconds,ticks,ms", [(0.12, 4, 30.0), (2.25, 45, 50.0)])
def test_reader_by_hand(seconds, ticks, ms):
    rec = {"delta": {"ticks": ticks, "stats_seconds": seconds, "gather_seconds": 0.5,
                     "device_route_seconds": 0.04}}
    assert metric_reader(NAME)(rec) == pytest.approx(ms)


@pytest.mark.parametrize("delta", [
    {"ticks": 4, "gather_seconds": 0.2, "device_route_seconds": 0.04},  # no counter
    {"ticks": 0, "stats_seconds": 0.2},  # no ticks
    {"ticks": 4, "stats_seconds": 0.0},  # no hop carried source attribution
])
def test_reader_finds_nothing_to_read(delta):
    assert metric_reader(NAME)({"delta": delta}) is None
