"""Skew workload subsystem: deterministic scenario streams (see scenarios.py
for the composition model and the determinism contract, docs/workloads.md
for the authoring guide)."""

from repro_torch.workloads.scenarios import (
    GRID_SCENARIOS,
    SCENARIO_DTYPE,
    Churn,
    Diurnal,
    FlashCrowd,
    ScenarioSpec,
    drive_scenario,
    make_scenario,
    scenario_batches,
    scenario_schema,
    scenario_stream,
)

__all__ = [
    "GRID_SCENARIOS",
    "SCENARIO_DTYPE",
    "Churn",
    "Diurnal",
    "FlashCrowd",
    "ScenarioSpec",
    "drive_scenario",
    "make_scenario",
    "scenario_batches",
    "scenario_schema",
    "scenario_stream",
]
