"""Optimization substrate: LP/MILP solving and balanced graph partitioning.

The paper uses IBM CPLEX v12.6.1 and METIS v5.1.  This package provides the
equivalents used by :mod:`repro_torch.core`:

* :mod:`repro_torch.solver.lp` — a time-limited MILP interface backed by SciPy's
  HiGHS (``scipy.optimize.milp``) with a pure-numpy greedy-repair fallback.
* :mod:`repro_torch.solver.graphpart` — multilevel balanced graph partitioning
  (heavy-edge-matching coarsening + greedy growth + FM boundary refinement),
  standing in for METIS.
"""

from repro_torch.solver.lp import MilpProblem, MilpResult, solve_milp
from repro_torch.solver.graphpart import partition_graph

__all__ = ["MilpProblem", "MilpResult", "solve_milp", "partition_graph"]
