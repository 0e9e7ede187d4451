"""Execution configuration of the port's engine.

The port of ``repro.engine.config.ExecutionConfig`` for the tiers this
slice carries:

======================  =====================================================
preset                  meaning
======================  =====================================================
``.oracle()``           legacy deque queue, per-run ``fn`` only — the
                        semantic oracle every other tier is pinned against
``.seg()``              SoA queues + segment-vectorized ``fn_seg``, schemas
                        stripped (object-array edges)
``.typed()``            ``.seg()`` plus declared schemas honored (columnar
                        structured-array edges) — the default
``.split(d)``           ``.typed()`` plus hot-key splitting at degree ``d``
``.jit()``              ``.typed()`` plus the compiled tier (``fn_jit``
                        bodies over device state columns, single device)
``.superstep()``        ``.jit()`` plus whole-tick fusion of a linear
                        ``jit_fusible`` chain on the device, and K-tick
                        scans (``Engine.run_supersteps``) captured into a
                        CUDA graph on the card
======================  =====================================================

Every preset routes through the card's kernels.  The reference's other
tiers raise :class:`NotImplementedError` naming the ROADMAP.md item (queue
1) that brings them: ``.workers(n)`` (multi-worker runtime), a
``checkpoint`` policy (jax-free checkpoints), and ``.jit(mesh=...)`` and
``.superstep(mesh=...)`` (item 11, mesh and dry-run tooling).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP.md queue 1, "
        f"{item!r}"
    )


def _no_mesh(preset: str, mesh: Any, mesh_axis: Optional[str]) -> None:
    if mesh is not None or mesh_axis is not None:
        raise NotImplementedError(
            f"ExecutionConfig.{preset}(mesh=...) is not ported to repro_torch yet: "
            "ROADMAP.md queue 1, item 11 (mesh and dry-run tooling)"
        )


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How a topology executes: queue layout and operator tier."""

    queue_impl: str = "soa"
    use_fn_seg: bool = True
    use_schema: bool = True
    #: The compiled tier: operators declaring ``fn_jit`` run their
    #: contiguous segments over device state columns.
    use_fn_jit: bool = False
    #: Whole-tick fusion of a linear ``jit_fusible`` chain on the device
    #: (the preset is :meth:`superstep`; requires ``use_fn_jit``).
    use_superstep: bool = False
    #: Hot-key splitting (``split_degree >= 2`` enables
    #: ``Engine.split_keygroup``; 0 = disabled, no reserve slots).
    split_degree: int = 0
    #: Replica key-group slots reserved when ``split_degree > 0``.
    split_reserve: int = 16
    #: Periodic checkpoints: not ported (must stay None).
    checkpoint: Optional[Any] = None

    def __post_init__(self) -> None:
        if self.queue_impl not in ("soa", "deque"):
            raise ValueError(f"unknown queue_impl {self.queue_impl!r}")
        if self.use_fn_jit and (self.queue_impl != "soa" or not self.use_schema):
            raise ValueError(
                "use_fn_jit requires queue_impl='soa' and use_schema=True "
                "(the jit tier executes native columns over SoA segments)"
            )
        if self.use_superstep and not self.use_fn_jit:
            raise ValueError(
                "use_superstep requires use_fn_jit=True (the fused tick "
                "compiles fn_jit bodies)"
            )
        if self.split_degree:
            if self.split_degree < 2:
                raise ValueError(
                    "split_degree must be 0 (disabled) or >= 2 (a split fans "
                    "a key group across at least two replicas)"
                )
            if self.split_reserve < self.split_degree - 1:
                raise ValueError(
                    "split_reserve must fit at least one split "
                    "(split_degree - 1 replica slots)"
                )
            if self.use_fn_jit:
                raise ValueError(
                    "hot-key splitting runs on the numpy tiers only (replica "
                    "key groups live outside the jit tier's per-operator "
                    "column space)"
                )
        if self.split_reserve < 0:
            raise ValueError("split_reserve must be >= 0")
        if self.checkpoint is not None:
            raise _not_ported("ExecutionConfig.checkpoint", "Jax-free checkpoints")

    # -- presets --------------------------------------------------------------
    @classmethod
    def oracle(cls) -> "ExecutionConfig":
        """Legacy deque queue, per-run ``fn`` only — the semantic oracle."""
        return cls(queue_impl="deque", use_fn_seg=False, use_schema=False)

    @classmethod
    def seg(cls) -> "ExecutionConfig":
        """SoA queues + ``fn_seg``, schemas stripped (object-array edges)."""
        return cls(use_schema=False)

    @classmethod
    def typed(cls) -> "ExecutionConfig":
        """SoA + ``fn_seg`` + declared schemas — the default configuration."""
        return cls()

    @classmethod
    def split(cls, degree: int = 2, *, reserve: int = 16) -> "ExecutionConfig":
        """``.typed()`` plus hot-key splitting at ``degree`` replicas."""
        return cls(split_degree=int(degree), split_reserve=int(reserve))

    @classmethod
    def jit(cls, *, mesh: Any = None, mesh_axis: Optional[str] = None) -> "ExecutionConfig":
        """``.typed()`` plus the compiled ``fn_jit`` tier, on one device."""
        _no_mesh("jit", mesh, mesh_axis)
        return cls(use_fn_jit=True)

    @classmethod
    def superstep(
        cls, *, mesh: Any = None, mesh_axis: Optional[str] = None
    ) -> "ExecutionConfig":
        """``.jit()`` plus whole-tick fusion into device programs, on one
        device."""
        _no_mesh("superstep", mesh, mesh_axis)
        return cls(use_fn_jit=True, use_superstep=True)

    @classmethod
    def workers(cls, n: int, **_kw) -> "ExecutionConfig":
        raise _not_ported("ExecutionConfig.workers()", "Multi-worker runtime")

    # -- plumbing -------------------------------------------------------------
    def replace(self, **changes) -> "ExecutionConfig":
        return dataclasses.replace(self, **changes)

    @property
    def name(self) -> str:
        """Short display name, as the reference's config labels."""
        parts = [self.queue_impl, "seg" if self.use_fn_seg else "fn"]
        if self.use_schema:
            parts.append("schema")
        if self.use_fn_jit:
            parts.append("jit")
        if self.use_superstep:
            parts.append("superstep")
        if self.split_degree:
            parts.append(f"split{self.split_degree}")
        return "+".join(parts)
