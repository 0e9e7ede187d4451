"""The streaming engine the paper's controller reconfigures at runtime.

The port of ``repro.engine``: :class:`Engine` executes a topology over
logical nodes with routing on the card (see
:mod:`repro_torch.engine.executor`), and :class:`Controller` runs
Algorithm 1 against it once per statistics period.  ``ExecutionConfig.jit()``
runs the compiled tier's ``fn_jit`` bodies over device state columns
(:mod:`repro_torch.engine.jitexec`, declared through :class:`StateSchema`),
and ``ExecutionConfig.superstep()`` fuses whole ticks of a linear
``jit_fusible`` chain on the device (:mod:`repro_torch.engine.superstep`;
``Engine.run_supersteps`` runs K of them per host read).

How a topology executes is one value — :class:`ExecutionConfig` — and
:func:`make_engine` dispatches it: ``num_workers == 1`` builds the
single-process :class:`Engine`, ``num_workers > 1`` the multi-worker
:class:`repro_torch.engine.cluster.ClusterEngine` (real OS worker
processes, each routing on the card; imported lazily).  A
:class:`CheckpointPolicy` adds periodic checkpoints
(:mod:`repro_torch.engine.checkpointing`), a :class:`SupervisionPolicy`
worker supervision and respawn (:mod:`repro_torch.engine.supervisor`).
"""

from typing import Optional

from repro_torch.engine.config import CheckpointPolicy, ExecutionConfig, SupervisionPolicy
from repro_torch.engine.controller import Controller, ControllerConfig
from repro_torch.engine.executor import Engine, EngineMetrics
from repro_torch.engine.router import Router
from repro_torch.engine.serde import Envelope
from repro_torch.engine.state import KeyedStore
from repro_torch.engine.topology import (
    OperatorSpec,
    Schema,
    StateField,
    StateSchema,
    Topology,
)
from repro_torch.engine.workqueue import DequeWorkQueue, SoAWorkQueue


def make_engine(
    topology: Topology,
    num_nodes: int,
    *,
    config: Optional[ExecutionConfig] = None,
    **kwargs,
):
    """Build the engine an :class:`ExecutionConfig` selects.

    The one construction path that covers every execution tier including
    ``ExecutionConfig.workers(n)`` — the multi-worker runtime is imported
    only when asked for (it forks worker processes at construction).
    """
    if config is not None and config.num_workers > 1:
        from repro_torch.engine.cluster import ClusterEngine

        return ClusterEngine(topology, num_nodes, config=config, **kwargs)
    return Engine(topology, num_nodes, config=config, **kwargs)


__all__ = [
    "CheckpointPolicy",
    "Controller",
    "ControllerConfig",
    "DequeWorkQueue",
    "Engine",
    "EngineMetrics",
    "Envelope",
    "ExecutionConfig",
    "KeyedStore",
    "OperatorSpec",
    "Router",
    "Schema",
    "SoAWorkQueue",
    "StateField",
    "StateSchema",
    "SupervisionPolicy",
    "Topology",
    "make_engine",
]
