"""Baselines the paper compares against: Flux [36], PoTC [29], COLA [21]."""

from repro_torch.core.baselines.cola import cola_allocate
from repro_torch.core.baselines.flux import flux_rebalance
from repro_torch.core.baselines.potc import PotcSimulator

__all__ = ["flux_rebalance", "PotcSimulator", "cola_allocate"]
