"""BENCHMARK.json against the benchmark's contract, and every cell's data
found by name."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["command"][1] == "chipbench/run.py" and len(BENCH["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"tuples_per_s", "setup_s"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("chipbench/") and len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_cell_reports_what_it_must():
    from chipbench.harness import Cell

    for w in BENCH["workloads"]:
        cell = Cell(BENCH, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
        assert cell.mix["loop"] in ("closed", "controlled")
        if cell.mix["loop"] == "controlled":
            assert cell.config["controller"]["framework"]["max_migrations"] > 0


def test_cell_data_resolves_by_name():
    from chipbench.harness import Cell, metric_reader, reference_module

    for w in BENCH["workloads"]:
        cell = Cell(BENCH, w["name"])
        assert reference_module(cell.config).Reference
        assert (ROOT / "chipbench" / "traffic" / f"{w['traffic']}.json").exists()
    for m in BENCH["per_layer"]:
        assert callable(metric_reader(m["name"]))
    assert sorted(p.stem for p in (ROOT / "chipbench" / "metrics").glob("[!_]*.py")) == sorted(
        m["name"] for m in BENCH["per_layer"])


def test_config_files_state_their_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank")) and "width" not in key


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files_name_what_they_assume(config):
    """Every assumed size is a parameter the run reads (the stream's, the
    topology's, the deployment's own, the controller's), and the configured
    stream draws its keys from the truncated Zipf law."""
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    read = {**cfg["generator"]["params"], **cfg["topology"]["kwargs"]}
    read.update((k, v) for k, v in cfg.items() if isinstance(v, (int, float)))
    blocks = [cfg.get("controller", {})]
    while blocks:
        block = blocks.pop()
        for k, v in block.items():
            if isinstance(v, dict):
                blocks.append(v)
            else:
                read[k] = v
    assert cfg["assumed"] and set(cfg["assumed"]) <= set(read)
    assert cfg["generator"]["params"]["zipf_tail"] == "truncate"
    assert "assumed" in entry["source"] and "assumed" in cfg["paper"]


def test_harness_names_no_cell_config_mix_or_metric():
    code = "".join((ROOT / "chipbench" / f).read_text()
                   for f in ("run.py", "harness.py", "trace.py", "stats.py", "gen/pool.py"))
    names = [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [m["name"] for m in BENCH["per_layer"]]
    for name in names:
        assert name not in code, name


def test_list_mode_prints_every_cell():
    out = subprocess.run([sys.executable, "chipbench/run.py", "--list"], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    for w in BENCH["workloads"]:
        line = next(x for x in out.stdout.splitlines() if x.startswith(w["name"] + ":"))
        assert w["config"] in line and w["traffic"] in line


@pytest.mark.parametrize("argv", [["--workload", "job3-jit-saturate"], ["--seconds", "1"]])
def test_run_refuses_incomplete_arguments(argv):
    out = subprocess.run([sys.executable, "chipbench/run.py", *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and not out.stdout.strip()
