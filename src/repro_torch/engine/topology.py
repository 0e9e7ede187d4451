"""Job topology: a DAG of operators connected by keyed streams (paper §3).

A job is ⟨O, E⟩ with src operators producing input and sink operators
producing none.  Each operator's input keys are hash-partitioned into a fixed
number of *key groups*; the processing of key groups is independent (the
paper's main execution-model assumption), which is what makes key groups the
unit of allocation and migration.

Operator logic is opaque to the system (paper §4.3.2: no pre-analysis of key
relations is possible) — the engine only sees tuples, keys and measured rates.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

# A tuple batch: parallel arrays ⟨key, value, ts⟩.  Values are object arrays so
# operators may carry arbitrary payloads (dicts, floats, small arrays).
Batch = tuple[np.ndarray, np.ndarray, np.ndarray]


def make_batch(keys: Sequence, values: Sequence, ts: Sequence) -> Batch:
    k = np.asarray(keys)
    if isinstance(values, np.ndarray):
        # Preserve the native dtype: a numeric values array flows through
        # slicing/gather/concat unboxed (object arrays pay per-element
        # refcounting on every gather).  Copied, not aliased — queued
        # batches must survive a caller refilling its buffer.
        v = values.copy()
    else:
        v = np.empty(len(values), dtype=object)
        v[:] = values if isinstance(values, list) else list(values)
    return k, v, np.asarray(ts, dtype=np.float64)


def empty_batch() -> Batch:
    return np.empty(0, dtype=np.int64), np.empty(0, dtype=object), np.empty(0)


# Operator state-transition function:
#   fn(state: dict, keys, values, ts) -> (state', outputs)
# where outputs is either a list of (out_key, out_value, out_ts) tuples or —
# the fast, array-native protocol — a Batch of three parallel arrays.
# It is called once per (key group, batch); `state` is that key group's σ_k.
OperatorFn = Callable[[dict, np.ndarray, np.ndarray, np.ndarray], tuple[dict, list]]

# Segment-level state transition (optional, the vectorized protocol):
#   fn_seg(store, kgs, starts, ends, keys, values, ts) -> (outputs, out_counts)
# One call covers every key group a node drains for this operator in a tick:
# `store` is the engine's state list (index by global key-group id), `kgs` the
# run key groups, and `starts`/`ends` slice bounds into the contiguous
# key/value/ts arrays.  `outputs` is a Batch (or None) concatenated over the
# runs in run order; `out_counts` gives per-run output lengths (None means
# each run emitted exactly its input length).  Must be semantically identical
# to calling `fn` run by run — the engine falls back to `fn` whenever the
# segment is not contiguous (in-flight migrations, partial budgets), and the
# routing-equivalence tests pin the two protocols against each other.
SegmentFn = Callable[
    [list, list, list, list, np.ndarray, np.ndarray, np.ndarray],
    tuple[Optional[Batch], Optional[list]],
]


@dataclasses.dataclass(frozen=True)
class Schema:
    """Declared record layout of a typed edge: value dtype + key dtype.

    ``value`` is a numpy dtype for the tuple *values* flowing over an edge —
    usually a structured record dtype (``Schema.record``), but any native
    scalar dtype works (e.g. plain ``float64`` payloads).  ``key`` types the
    partition keys.  Neither may be ``object``: a Schema is exactly the claim
    that the edge needs no object boxing, which is what lets the engine keep
    the routing permutation, the SoA work queues, sink buffers and migration
    codecs on native-dtype operations end to end.

    Two schemas are equal iff both dtypes are equal — topology validation
    compares them structurally, so declaring the same field layout twice
    (e.g. in the producer's ``out_schema`` and the consumer's ``schema``)
    compares equal even through distinct ``np.dtype`` instances.
    """

    value: np.dtype
    key: np.dtype = np.dtype(np.int64)

    def __post_init__(self) -> None:
        object.__setattr__(self, "value", np.dtype(self.value))
        object.__setattr__(self, "key", np.dtype(self.key))
        if self.value.kind == "O" or self.key.kind == "O":
            raise ValueError(
                "Schema dtypes must be native (object is the untyped path)"
            )

    @staticmethod
    def record(
        fields: Sequence[tuple[str, object]], key: object = np.int64
    ) -> "Schema":
        """Build a schema whose value layout is a structured record dtype."""
        return Schema(value=np.dtype(list(fields)), key=np.dtype(key))

    @property
    def names(self) -> Optional[tuple[str, ...]]:
        return self.value.names

    def typed_values(self, values) -> np.ndarray:
        """Coerce a value sequence/array to this schema's native layout.

        Lists of per-tuple records (python tuples) convert in one C-level
        ``np.array(..., dtype)``; object arrays go through ``tolist`` first
        (numpy cannot cast object arrays to structured dtypes directly); a
        native array of the right dtype passes through unchanged.
        """
        if isinstance(values, np.ndarray):
            if values.dtype == self.value:
                return values
            if values.dtype.kind == "O":
                return np.array(values.tolist(), dtype=self.value)
            return values.astype(self.value, copy=False)
        return np.array(
            values if isinstance(values, list) else list(values), dtype=self.value
        )

    def typed_keys(self, keys) -> np.ndarray:
        return np.asarray(keys, dtype=self.key)


# Compiled segment-level state transition (optional, the jit tier):
#   fn_jit(state_cols, kgs, starts, ends, keys, values, ts)
#       -> (state_cols', outputs, out_counts)
# A *pure JAX* function over column arrays, compiled once per (operator,
# padding bucket) by :mod:`repro_torch.engine.jitexec` and executed as one
# ``jax.jit`` call per (node, operator) contiguous segment.  ``state_cols``
# is the operator's declared :class:`StateSchema` layout (per-key-group
# device columns — scalar vectors and keyed tables — instead of the python
# ``store`` dicts); ``kgs`` holds *local* key-group ids padded with the
# operator's key-group count, ``starts``/``ends`` are padded with the real
# tuple count (padding runs are empty), and ``values`` is a dict of native
# column arrays on record schemas (a plain array on scalar schemas).  Tuple
# validity is derived from the run bounds (``jitexec.tuple_valid``), never
# from array lengths, so the same body runs under padding and under
# ``shard_map`` run-sharding unchanged.  ``outputs`` is ``None`` or
# ``(out_keys, out_values, out_ts)`` with ``out_values`` a column dict /
# array in the operator's output layout; ``out_counts`` follows the fn_seg
# contract (None = one output per input tuple).  Must be semantically
# identical to ``fn_seg`` — bit-exact on integers and single float ops, with
# XLA reduction-order divergence allowed *only* for multi-term float
# reductions (running sums), see docs/operator_authoring.md.
JitFn = Callable[..., tuple]


@dataclasses.dataclass(frozen=True)
class StateField:
    """One declared per-key-group state column of a jit-tier operator.

    ``kind="scalar"``: one ``dtype`` cell per key group (counters,
    watermarks), materialized into the oracle state dict as
    ``{name: py(cell)}``.

    ``kind="table"``: a keyed accumulator — per key group a bounded table of
    ``(int64 code, dtype value)`` entries plus insertion sequence numbers,
    materialized as ``{name: {key_decode(code): float(value), ...}}`` in
    insertion order (the order the per-run oracle would have inserted them).
    ``key_encode``/``key_decode`` convert between the oracle's dict keys and
    the int64 codes the device table stores; codes must be unique per dict
    key and — because a table row belongs to one key group — equal codes
    must always hash to the same key group (keying the table by the
    operator's partition key guarantees this).  Capacity is managed by the
    runtime (power-of-two growth; a growth step is a recompile bucket).

    ``kind="vector"``: a bounded per-key-group ring of ``length`` ``dtype``
    cells plus an occupancy count (sliding windows), materialized as
    ``{name: [py(x) for x in cells[:count]]}`` oldest-first — exactly the
    list the per-run oracle keeps.
    """

    name: str
    kind: str = "scalar"
    dtype: object = np.int64
    init: object = 0
    py: Callable = int  # python scalar constructor used by to_dict
    key_encode: Optional[Callable[[object], int]] = None
    key_decode: Optional[Callable[[int], object]] = None
    length: int = 0  # vector kind: bounded window capacity

    def __post_init__(self) -> None:
        if self.kind not in ("scalar", "table", "vector"):
            raise ValueError(f"unknown StateField kind {self.kind!r}")
        if self.kind == "table" and (
            self.key_encode is None or self.key_decode is None
        ):
            raise ValueError(f"table field {self.name!r} needs key_encode/decode")
        if self.kind == "vector" and self.length <= 0:
            raise ValueError(f"vector field {self.name!r} needs length > 0")


@dataclasses.dataclass(frozen=True)
class StateSchema:
    """Declared array layout of a jit-tier operator's per-key-group state.

    Field order is the contract: it must match the order the per-run ``fn``
    first inserts the corresponding keys into its state dict, and every
    field must be written by ``fn`` for every processed run (the standard
    ``setdefault`` + update pattern satisfies both) — that is what lets the
    runtime materialize device columns back into dicts that are equal to the
    oracle's, including insertion order.
    """

    fields: tuple[StateField, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "fields", tuple(self.fields))
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError("duplicate StateSchema field names")


def _identity_key(k: object) -> object:
    return k


def _is_int_key(x: object) -> bool:
    """Keys eligible for the vectorized integer mix (bool excluded: its hash
    semantics follow Python's, and streams never key by bool)."""
    return type(x) is int or isinstance(x, np.integer)


# splitmix/murmur3-style 32-bit finisher over the 64→32 folded key.  Chosen
# 32-bit so the same mix runs on the device path (the CUDA kernel, see
# repro_torch.kernels.keygroup_partition) and in numpy; the scalar and vectorized
# forms below are bit-identical by construction.
_MIX_C1 = 0x85EBCA6B
_MIX_C2 = 0xC2B2AE35
_MASK31 = 0x7FFFFFFF


def mix32_scalar(x: int) -> int:
    u = int(x) & 0xFFFFFFFFFFFFFFFF
    h = (u ^ (u >> 32)) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * _MIX_C1) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * _MIX_C2) & 0xFFFFFFFF
    h ^= h >> 16
    return h


import sys as _sys

_LITTLE_ENDIAN = _sys.byteorder == "little"


def mix32(x: np.ndarray) -> np.ndarray:
    """Vectorized :func:`mix32_scalar` over an integer array → uint32."""
    with np.errstate(over="ignore"):
        if (
            _LITTLE_ENDIAN
            and x.dtype in (np.dtype(np.int64), np.dtype(np.uint64))
            and x.flags.c_contiguous
        ):
            # (u ^ (u >> 32)) & 0xFFFFFFFF == lo ^ hi on uint32 lanes —
            # stays on 32-bit ops instead of widening to uint64.
            pair = x.view(np.uint32).reshape(-1, 2)
            h = pair[:, 0] ^ pair[:, 1]
        else:
            u = x.astype(np.uint64)
            h = ((u ^ (u >> np.uint64(32))) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(_MIX_C1)
        h ^= h >> np.uint32(13)
        h = h * np.uint32(_MIX_C2)
        h ^= h >> np.uint32(16)
    return h


def hash_key(x: object) -> int:
    """31-bit partition hash of one key: integer mix for ints, `hash` else."""
    if _is_int_key(x):
        return mix32_scalar(x) & _MASK31
    return hash(x) & _MASK31


def _mixed_keygroups(h: np.ndarray, base: int, nkg: int) -> np.ndarray:
    """(mix32 output → global key-group ids), staying on uint32 lanes.

    Bit-identical to ``base + ((h & MASK31) % nkg)`` on int64: the masked
    value is non-negative, so the uint32 modulo (and the bitwise-and
    shortcut when nkg is a power of two) gives the same residues.
    """
    h = h & np.uint32(_MASK31)
    if nkg & (nkg - 1) == 0:  # power of two: mod is a mask
        loc = h & np.uint32(nkg - 1)
    else:
        loc = h % np.uint32(nkg)
    return loc.astype(np.int64) + base


@dataclasses.dataclass
class OperatorSpec:
    """One operator O_i.

    Attributes:
      name: unique id.
      fn: keyed state transition (None for sources; sources are driven by the
        engine's input feeder).
      num_keygroups: how many key groups this operator's input is split into.
      cost_per_tuple: load points charged per processed tuple (the measured
        CPU cost in the paper's statistics; calibrated per operator).
      key_fn: maps an input tuple key to the partitioning key (defaults to
        identity).  The engine hashes the result into a key group.
      key_by_value: optional — partition by a function of the tuple *value*
        instead (e.g. RouteDelay partitions extract's airplane-keyed tuples
        by (origin, dest)).  Takes precedence over key_fn.
      key_by_value_col: optional columnar form of ``key_by_value`` — applied
        to a whole schema-typed values array at once (field expressions like
        ``v["origin"] * na + v["dest"]`` vectorize over structured columns).
        Must return one partition key per tuple, elementwise identical to
        ``key_by_value``; ignored for untyped (object) batches.
      is_source / is_sink: role flags.
      schema: optional :class:`Schema` declaring the operator's *input* edge
        layout.  Schema-typed operators receive native structured value
        arrays (column views in ``fn_seg``); undeclared operators keep the
        object-array path behind the same API.
      out_schema: optional :class:`Schema` for the operator's *output* edge
        (sources forward their input, so their out schema is ``schema``).
        Validated against every downstream operator's declared input schema
        at construction time.
      jit_fusible: the author's claim that ``fn_jit`` is eligible for the
        fused device superstep: strictly 1:1 (``out_counts is None`` and one
        output per input tuple), state updates are pure per-run scatters
        (insensitive to run order and to empty runs), and — for
        non-terminal operators — ``out_schema`` is declared so the device
        can route outputs without a host conform step.  The superstep
        runtime additionally checks the structural conditions (linear
        chain, identity key_fn, integer keys, scalar-only state) and falls
        back to the per-operator jit tick when any fail.
      merge_state: optional — the author's declaration that the operator is
        **split-mergeable**: its per-key-group state transition is a
        commutative monoid over disjoint tuple subsets (processing a key
        group's tuples as several partial states, then folding them with
        ``merge_state(a, b) -> merged``, yields the same aggregate values
        the unsplit run would have produced), and its emitted tuples are
        *deltas* a downstream operator re-aggregates (so the merged
        downstream totals are identical no matter how the upstream tuples
        were partitioned).  Declaring it is what makes the operator
        eligible for hot-key splitting (``Engine.split_keygroup`` — a hot
        key group fans its tuples across replica key groups, partial-key-
        grouping style); the engine calls it at unsplit time to fold the
        replicas' σ back into the parent.  Exact-arithmetic payloads
        (ints) stay bit-exact under splitting; float running sums are
        reordered by construction — see docs/workloads.md.
      jit_key_map: optional host-evaluable key transform: the author's claim
        that ``fn_jit`` emits keys equal to ``jit_key_map(input_keys)``
        element-wise, in input order (pass ``lambda keys: keys`` for
        pass-through operators).  When every non-terminal fused operator
        declares one, the superstep scheduler can evaluate the whole routing
        schedule (hashes, stable radix permutations, per-edge count
        matrices) on the host ahead of the K-tick scan, leaving the scan
        body sort-free; chains with an undeclared map still fuse but sort
        on-device.  Must be wrap-consistent with the device body (numpy and
        jax integer arithmetic overflow identically, so plain column math
        qualifies).
    """

    name: str
    fn: Optional[OperatorFn]
    num_keygroups: int = 8
    cost_per_tuple: float = 1.0
    key_fn: Callable[[object], object] = _identity_key
    key_by_value: Optional[Callable[[object], object]] = None
    is_source: bool = False
    is_sink: bool = False
    fn_seg: Optional[SegmentFn] = None  # vectorized protocol (see SegmentFn)
    schema: Optional[Schema] = None
    out_schema: Optional[Schema] = None
    key_by_value_col: Optional[Callable[[np.ndarray], np.ndarray]] = None
    fn_jit: Optional[JitFn] = None  # compiled tier (see JitFn / jitexec)
    state_schema: Optional[StateSchema] = None
    jit_fusible: bool = False  # superstep-fusible fn_jit (see above)
    jit_key_map: Optional[Callable[[np.ndarray], np.ndarray]] = None
    merge_state: Optional[Callable[[dict, dict], dict]] = None  # split-mergeable


class Topology:
    """DAG of :class:`OperatorSpec` plus the global key-group index space.

    Key groups are numbered globally and contiguously per operator, so a
    single allocation vector covers the whole job (matching
    :class:`repro_torch.core.stats.ClusterState`).
    """

    def __init__(self) -> None:
        self.operators: list[OperatorSpec] = []
        self.edges: list[tuple[int, int]] = []
        self._name_to_id: dict[str, int] = {}
        self._kg_base: Optional[np.ndarray] = None  # cached prefix sums

    # -- construction --------------------------------------------------------
    def add_operator(self, spec: OperatorSpec) -> int:
        if spec.name in self._name_to_id:
            raise ValueError(f"duplicate operator {spec.name!r}")
        oid = len(self.operators)
        self.operators.append(spec)
        self._name_to_id[spec.name] = oid
        self._kg_base = None
        return oid

    def connect(self, src: str | int, dst: str | int) -> None:
        s = self._resolve(src)
        d = self._resolve(dst)
        self.edges.append((s, d))

    def _resolve(self, ref: str | int) -> int:
        return ref if isinstance(ref, int) else self._name_to_id[ref]

    # -- derived -------------------------------------------------------------
    @property
    def num_operators(self) -> int:
        return len(self.operators)

    @property
    def num_keygroups(self) -> int:
        return sum(o.num_keygroups for o in self.operators)

    def kg_base_table(self) -> np.ndarray:
        """(num_operators + 1,) prefix sums: kg id space start per operator."""
        if self._kg_base is None or len(self._kg_base) != self.num_operators + 1:
            sizes = np.fromiter(
                (o.num_keygroups for o in self.operators),
                dtype=np.int64,
                count=self.num_operators,
            )
            self._kg_base = np.concatenate(
                [np.zeros(1, dtype=np.int64), np.cumsum(sizes)]
            )
        return self._kg_base

    def kg_base(self, op: int) -> int:
        return int(self.kg_base_table()[op])

    def kg_operator(self) -> np.ndarray:
        return np.concatenate(
            [
                np.full(o.num_keygroups, i, dtype=np.int64)
                for i, o in enumerate(self.operators)
            ]
        )

    def downstream(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {i: [] for i in range(self.num_operators)}
        for s, d in self.edges:
            out[s].append(d)
        return out

    def upstream(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {i: [] for i in range(self.num_operators)}
        for s, d in self.edges:
            out[d].append(s)
        return out

    def topo_order(self) -> list[int]:
        indeg = [0] * self.num_operators
        for _, d in self.edges:
            indeg[d] += 1
        order, stack = [], [i for i, v in enumerate(indeg) if v == 0]
        while stack:
            u = stack.pop()
            order.append(u)
            for s, d in self.edges:
                if s == u:
                    indeg[d] -= 1
                    if indeg[d] == 0:
                        stack.append(d)
        if len(order) != self.num_operators:
            raise ValueError("topology has a cycle")
        return order

    def keygroup_of(self, op: int, key: object, value: object = None) -> int:
        """Hash-partition a tuple into one of the operator's key groups."""
        spec = self.operators[op]
        part_key = (
            spec.key_by_value(value)
            if (spec.key_by_value is not None and value is not None)
            else spec.key_fn(key)
        )
        return self.kg_base(op) + (hash_key(part_key) % spec.num_keygroups)

    def keygroups_of(self, op: int, keys: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Batched :meth:`keygroup_of`: key-group id per tuple, as int64.

        Integer partition keys take a fully vectorized path (the same 32-bit
        mix the TPU kernel uses); object keys (strings, tuples) fall back to
        per-object :func:`hash_key`.  Bit-identical to the scalar method.

        Integer-ness of extracted partition keys is probed with one C-level
        ``np.asarray`` instead of a per-element python scan: a list that
        coerces to an integer dtype is all-int (an all-bool list coerces to
        bool and falls through to the hash path, matching the scalar method;
        partition keys must not *mix* bools with ints — no job does, bools
        are not keys).
        """
        spec = self.operators[op]
        n = len(keys)
        base = self.kg_base(op)
        nkg = spec.num_keygroups
        if (
            spec.key_by_value_col is not None
            and isinstance(values, np.ndarray)
            and values.dtype.names is not None
        ):
            # Schema-typed batch with a columnar key expression: the whole
            # partition-key vector is field arithmetic — no per-tuple python,
            # no object array, straight into the vectorized mix.
            part = spec.key_by_value_col(values)
            if (
                isinstance(part, np.ndarray)
                and part.shape == (n,)
                and part.dtype.kind in "iu"
            ):
                return _mixed_keygroups(mix32(part), base, nkg)
            raise TypeError(
                f"key_by_value_col of operator {spec.name!r} must return an "
                f"integer array of length {n}, got {type(part).__name__}"
            )
        if spec.key_by_value is not None:
            # Match the scalar path: a None value falls back to key_fn(key).
            # Object arrays iterate faster as lists (no per-element boxing).
            kbv, kfn = spec.key_by_value, spec.key_fn
            vlist = values.tolist() if isinstance(values, np.ndarray) else values
            part = [kbv(v) if v is not None else kfn(k) for k, v in zip(keys, vlist)]
        elif spec.key_fn is not _identity_key:
            kfn = spec.key_fn
            part = [kfn(k) for k in keys]
        else:
            part = keys
        if isinstance(part, np.ndarray) and part.dtype.kind in "iu":
            return _mixed_keygroups(mix32(part), base, nkg)
        if isinstance(part, list):
            try:
                arr = np.asarray(part)
            except (OverflowError, ValueError, TypeError):
                arr = None  # out-of-int64 or ragged entries → hash path
            # ndim check: tuple keys coerce to a 2-D array — those hash.
            if arr is not None and arr.ndim == 1 and arr.dtype.kind in "iu":
                # mix32 folds int64 two's complement exactly like the scalar
                # ``int(x) & 0xFFFFFFFFFFFFFFFF``.
                return _mixed_keygroups(mix32(arr), base, nkg)
        h = np.fromiter((hash_key(x) for x in part), dtype=np.int64, count=n)
        return base + h % nkg

    def out_schema_of(self, op: int) -> Optional[Schema]:
        """Effective output schema of an operator (sources forward input)."""
        spec = self.operators[op]
        return spec.schema if spec.fn is None else spec.out_schema

    def validate(self) -> None:
        self.topo_order()  # raises on cycles
        downs = self.downstream()
        for i, o in enumerate(self.operators):
            if o.is_sink and downs[i]:
                raise ValueError(f"sink {o.name!r} has downstream edges")
            if not o.is_source and o.fn is None:
                # This also guarantees every fn_seg operator has the per-run
                # fn the engine falls back to on non-contiguous segments.
                raise ValueError(f"non-source {o.name!r} lacks fn")
            if o.fn_seg is not None and o.is_source:
                raise ValueError(
                    f"source {o.name!r} cannot have fn_seg — sources are "
                    "pass-through; the engine forwards their batches directly"
                )
            if o.key_by_value_col is not None and o.key_by_value is None:
                raise ValueError(
                    f"{o.name!r} declares key_by_value_col without the scalar "
                    "key_by_value it must be elementwise identical to"
                )
            if o.fn_jit is not None:
                if o.is_source:
                    raise ValueError(f"source {o.name!r} cannot have fn_jit")
                if o.schema is None:
                    raise ValueError(
                        f"{o.name!r} declares fn_jit without a Schema — the "
                        "jit tier operates on native column arrays only"
                    )
            if o.state_schema is not None and o.fn_jit is None:
                raise ValueError(
                    f"{o.name!r} declares a StateSchema without fn_jit"
                )
            if o.merge_state is not None and o.fn is None:
                raise ValueError(
                    f"source {o.name!r} cannot declare merge_state — sources "
                    "hold no per-key-group state to split"
                )
        # Schema mismatch across an edge is a construction-time error, not a
        # runtime surprise.  A declared consumer accepts either (a) producers
        # declaring the *same* schema (the fully typed edge) or (b) undeclared
        # producers — the gradual-typing boundary, where the engine coerces
        # object batches into the declared layout at routing time.  A typed
        # producer feeding an undeclared consumer decays to the object path.
        for s, d in self.edges:
            want = self.operators[d].schema
            have = self.out_schema_of(s)
            if want is not None and have is not None and have != want:
                raise ValueError(
                    f"schema mismatch on edge {self.operators[s].name!r} -> "
                    f"{self.operators[d].name!r}: producer emits {have.value} "
                    f"(key {have.key}), consumer declares {want.value} "
                    f"(key {want.key})"
                )
