"""The reader of routing's gather counter (``EngineMetrics.gather_seconds``),
by hand on a made record, and on records that lack the counter or read 0."""

import json
from pathlib import Path

import pytest

from chipbench.harness import metric_reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "route_gather_ms_per_tick.saturate"


def test_entry_in_the_benchmark():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "ms", "lower", "program_span", "Routing", "tuples_per_s")
    assert m["workloads"] == [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("seconds,ticks,ms", [(0.2, 4, 50.0), (1.5, 3, 500.0)])
def test_reader_by_hand(seconds, ticks, ms):
    rec = {"delta": {"ticks": ticks, "gather_seconds": seconds, "device_route_seconds": 0.04}}
    assert metric_reader(NAME)(rec) == pytest.approx(ms)


@pytest.mark.parametrize("delta", [
    {"ticks": 4, "device_route_seconds": 0.04},  # a program without the counter
    {"ticks": 0, "gather_seconds": 0.2},  # no ticks
    {"ticks": 4, "gather_seconds": 0.0},  # no batch needed a permutation
])
def test_reader_finds_nothing_to_read(delta):
    assert metric_reader(NAME)({"delta": delta}) is None
