"""The streaming engine the paper's controller reconfigures at runtime.

The port of ``repro.engine``'s classic tick: :class:`Engine` executes a
topology over logical nodes with routing on the card (see
:mod:`repro_torch.engine.executor`), and :class:`Controller` runs
Algorithm 1 against it once per statistics period.  ``ExecutionConfig.jit()``
runs the compiled tier's ``fn_jit`` bodies over device state columns
(:mod:`repro_torch.engine.jitexec`, declared through :class:`StateSchema`),
and ``ExecutionConfig.superstep()`` fuses whole ticks of a linear
``jit_fusible`` chain on the device (:mod:`repro_torch.engine.superstep`;
``Engine.run_supersteps`` runs K of them per host read).  Checkpoints and
the multi-worker runtime are not ported yet (see
:mod:`repro_torch.engine.config`).
"""

from repro_torch.engine.config import ExecutionConfig
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

__all__ = [
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
    "Topology",
]
