"""Execution configuration of the port's engine.

The port of ``repro.engine.config.ExecutionConfig``:

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
``.workers(n)``         ``.typed()`` sharded over ``n`` OS worker processes
                        (:class:`repro_torch.engine.cluster.ClusterEngine`),
                        each routing on the card
======================  =====================================================

Every preset routes through the card's kernels.  A :class:`CheckpointPolicy`
adds periodic checkpoints (single-process engine or the multi-worker
coordinator) and a :class:`SupervisionPolicy` worker supervision (heartbeat
deadlines and respawn).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


#: Default capacity (bytes) of one shared-memory exchange lane — the
#: documented ``ExecutionConfig.workers(n, shm=...)`` default.
SHM_LANE_BYTES = 1 << 20


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Periodic engine checkpoints.

    The engine (or the multi-worker coordinator) snapshots the routing
    table, every key group's state envelope, split cursors, the partial SPL
    window and the ingestion cursor under one atomic manifest every
    :attr:`every` SPL periods, via
    :class:`repro_torch.checkpoint.CheckpointManager` rooted at
    :attr:`directory`.
    """

    directory: str
    #: Checkpoint every N ``end_period()`` calls (N >= 1).
    every: int = 2
    #: Complete checkpoints retained on disk (older ones are pruned).
    keep: int = 3

    def __post_init__(self) -> None:
        if not self.directory:
            raise ValueError("CheckpointPolicy.directory must be a path")
        if self.every < 1:
            raise ValueError("CheckpointPolicy.every must be >= 1")
        if self.keep < 1:
            raise ValueError("CheckpointPolicy.keep must be >= 1")


@dataclasses.dataclass(frozen=True)
class SupervisionPolicy:
    """Worker supervision: liveness deadlines and bounded respawn.

    Workers heartbeat over their report queue after every command; a worker
    with outstanding commands that stays silent for ``hb_interval_s *
    hb_misses`` seconds is presumed wedged and escalated to SIGKILL (wedged
    is not dead — escalation turns it into a clean death the respawn path
    handles).  Dead workers are respawned with bounded exponential backoff
    and their key groups restored from the latest checkpoint (recovery *is*
    reconfiguration: orphans are re-homed through the allocator).
    """

    hb_interval_s: float = 5.0
    #: Consecutive missed heartbeat intervals before SIGKILL escalation.
    hb_misses: int = 6
    #: Respawn dead workers (False → supervise liveness only; a death
    #: permanently fails the worker's nodes).
    respawn: bool = True
    #: Give up on a worker after this many respawns without an intervening
    #: completed checkpoint.
    max_respawns: int = 3
    #: Exponential backoff before the k-th respawn: min(base * 2**k, cap).
    backoff_base_s: float = 0.0
    backoff_cap_s: float = 5.0
    #: How recovered key groups are re-homed: "albic" (Algorithm 2),
    #: "milp" (solve_allocation), or "keep" (checkpointed placement as-is).
    rehome: str = "albic"

    def __post_init__(self) -> None:
        if self.hb_interval_s <= 0:
            raise ValueError("hb_interval_s must be > 0")
        if self.hb_misses < 1:
            raise ValueError("hb_misses must be >= 1")
        if self.max_respawns < 0:
            raise ValueError("max_respawns must be >= 0")
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff times must be >= 0")
        if self.rehome not in ("albic", "milp", "keep"):
            raise ValueError(f"unknown rehome strategy {self.rehome!r}")

    @property
    def deadline_s(self) -> float:
        """Silence (with outstanding commands) that triggers escalation."""
        return self.hb_interval_s * self.hb_misses


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How a topology executes: queue layout, operator tier, worker count."""

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
    #: OS worker processes (``> 1``: the multi-worker runtime).
    num_workers: int = 1
    #: Bytes per (sender → receiver) shared-memory exchange lane in the
    #: multi-worker runtime (default :data:`SHM_LANE_BYTES` = 1 MiB); a full
    #: ring falls back to the queue path (correct, just slower).  ``0``
    #: disables shm lanes (pure pickled-queue exchange).
    shm_lane_bytes: int = SHM_LANE_BYTES
    #: Periodic checkpoint cadence (None disables checkpoints).  Applies to
    #: the coordinator only — worker shards never checkpoint themselves.
    checkpoint: Optional[CheckpointPolicy] = None
    #: Worker supervision (heartbeat deadlines + respawn).  Multi-worker
    #: runtime only; None disables supervision.
    supervision: Optional[SupervisionPolicy] = None

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
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.shm_lane_bytes < 0:
            raise ValueError("shm_lane_bytes must be >= 0 (0 disables shm lanes)")
        if 0 < self.shm_lane_bytes < 64:
            raise ValueError(
                "shm_lane_bytes must be 0 or >= 64 (a ring smaller than one "
                "record header can never deliver)"
            )
        if self.num_workers > 1 and (self.use_fn_jit or self.use_superstep):
            raise ValueError(
                "the multi-worker runtime runs the numpy tiers only "
                "(use_fn_jit/use_superstep are single-process)"
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
            if self.num_workers > 1 or self.use_fn_jit:
                raise ValueError(
                    "hot-key splitting runs on the single-process numpy "
                    "tiers only (replica key groups live outside the jit "
                    "tier's per-operator column space)"
                )
        if self.split_reserve < 0:
            raise ValueError("split_reserve must be >= 0")
        if self.supervision is not None and self.num_workers == 1:
            raise ValueError(
                "supervision requires the multi-worker runtime "
                "(num_workers > 1); the single-process engine has no worker "
                "processes to supervise"
            )
        if (
            self.supervision is not None
            and self.supervision.respawn
            and self.checkpoint is None
        ):
            raise ValueError(
                "supervision with respawn=True requires a CheckpointPolicy "
                "(a respawned worker restores its key groups from the "
                "latest checkpoint)"
            )

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
    def jit(cls) -> "ExecutionConfig":
        """``.typed()`` plus the compiled ``fn_jit`` tier."""
        return cls(use_fn_jit=True)

    @classmethod
    def superstep(cls) -> "ExecutionConfig":
        """``.jit()`` plus whole-tick fusion into device programs."""
        return cls(use_fn_jit=True, use_superstep=True)

    @classmethod
    def workers(
        cls,
        n: int,
        *,
        shm: int = SHM_LANE_BYTES,
        checkpoint: Optional[CheckpointPolicy] = None,
        supervision: Optional[SupervisionPolicy] = None,
    ) -> "ExecutionConfig":
        """``.typed()`` sharded over ``n`` OS worker processes.

        ``shm`` sizes each (sender → receiver) shared-memory exchange lane
        in bytes (default 1 MiB; see :data:`SHM_LANE_BYTES`).  ``shm=0``
        disables the shm lanes and exchanges everything over the pickled
        queue path.  ``checkpoint``/``supervision`` enable the self-healing
        layer (:mod:`repro_torch.engine.supervisor`).
        """
        return cls(
            num_workers=int(n),
            shm_lane_bytes=int(shm),
            checkpoint=checkpoint,
            supervision=supervision,
        )

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
        if self.num_workers > 1:
            parts.append("workers")
        if self.split_degree:
            parts.append(f"split{self.split_degree}")
        if self.checkpoint is not None:
            parts.append(f"ckpt{self.checkpoint.every}")
        if self.supervision is not None:
            parts.append("supervised")
        return "+".join(parts)
