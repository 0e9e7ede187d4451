"""The readers of the program's own layer counters (``EngineMetrics``' host
seconds at the engine's boundaries), by hand on a made record, and on
records that lack the counters or read 0."""

import json
from pathlib import Path

import pytest

from chipbench.harness import metric_reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ["admit_ms_per_tick.saturate", "route_host_ms_per_tick.saturate",
           "flush_ms_per_tick.saturate", "op_body_ms_per_tick", "jit_put_ms_per_tick",
           "jit_call_ms_per_tick", "jit_fetch_ms_per_tick", "jit_assemble_ms_per_tick"]


def _record(**delta):
    """Four ticks: what a traced run's record holds of the program's
    counters (scalars under ``delta``, per-operator dicts beside it)."""
    d = {"ticks": 4, "device_route_seconds": 0.04, "admit_seconds": 0.2,
         "flush_seconds": 0.1, "jit_seconds": 1.0, "jit_put_seconds": 0.3,
         "jit_call_seconds": 0.08, "jit_fetch_seconds": 0.12}
    d.update(delta)
    return {"delta": d, "route_seconds": {0: 0.1, 1: 0.3, 2: 0.0},
            "op_seconds": {1: 0.6, 2: 0.2}}


def test_every_reader_is_in_the_benchmark():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "ms", "lower", "program_span", "tuples_per_s")


def test_readers_by_hand():
    rec = _record()
    read = {name: metric_reader(name)(rec) for name in READERS}
    assert read == {
        "admit_ms_per_tick.saturate": pytest.approx(50.0),
        "route_host_ms_per_tick.saturate": pytest.approx(1e3 * (0.4 - 0.04) / 4),
        "flush_ms_per_tick.saturate": pytest.approx(25.0),
        "op_body_ms_per_tick": pytest.approx(200.0),
        "jit_put_ms_per_tick": pytest.approx(75.0),
        "jit_call_ms_per_tick": pytest.approx(20.0),
        "jit_fetch_ms_per_tick": pytest.approx(30.0),
        "jit_assemble_ms_per_tick": pytest.approx(1e3 * (1.0 - 0.5) / 4),
    }


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_to_read(name):
    read = metric_reader(name)
    # A program without the counters (the parent of the change that added
    # them) and a record of no ticks.
    bare = {"delta": {"ticks": 4, "device_route_seconds": 0.04}}
    assert read(bare) is None
    assert read(_record(ticks=0)) is None
    # Counters that ran nothing: no compiled tier, no host bodies.
    idle = _record(admit_seconds=0.0, flush_seconds=0.0, jit_seconds=0.0,
                   jit_put_seconds=0.0, jit_call_seconds=0.0, jit_fetch_seconds=0.0)
    idle["route_seconds"] = {0: 0.0}
    idle["op_seconds"] = {}
    assert read(idle) is None
