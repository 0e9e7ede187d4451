"""The compiled operator tier: ``fn_jit`` bodies over device state columns.

The port of ``repro.engine.jitexec`` (single device).  This module is the
runtime behind ``OperatorSpec.fn_jit`` — the third execution tier after the
per-run ``fn`` and the segment-vectorized numpy ``fn_seg``.  A jit-tier
operator's body is a *pure PyTorch function over column tensors*; the
runtime

* keeps the operator's declared :class:`~repro_torch.engine.topology.
  StateSchema` in preallocated **device columns** on the engine's device —
  per-key-group scalar vectors, bounded window rings and keyed-accumulator
  tables — instead of the python ``store`` dicts,
* pads each call's segment tuple count and run count to power-of-two
  buckets on the host, uploads every column once (pinned, asynchronous on
  the card), runs the body eagerly on the device, and reads back the
  tables' used counts and the outputs in **one** synchronization per call
  (``EngineMetrics.jit_host_syncs``), timing each call's put, call and
  fetch (``jit_put_seconds``, ``jit_call_seconds``, ``jit_fetch_seconds``,
  and the owning engine's spans: :mod:`repro_torch.engine.tracing`),
* counts the first call of each ``(tuple bucket, run bucket, table
  capacities)`` key per operator in ``EngineMetrics.jit_compiles`` and its
  time in :attr:`JitRuntime.compile_seconds` — where the reference counts a
  trace — so the port's counters equal the reference's ``.jit()`` run, call
  for call.  There is no compiler: torch keeps int64 and float64 natively,
  so nothing like the reference's process-wide x64 flag exists here.

Coherence with the interpreted tiers is the reference's: the python
``store`` dict and the device columns hold the *same* state in two layouts,
and exactly one of them is authoritative per key group at any time.  A jit
call flips its key groups to column-authoritative (pushing any
dict-authoritative state in first); the engine's per-run ``fn`` fallbacks
and the migration codec call :meth:`JitRuntime.ensure_dict` first, which
materializes the columns back into the dict — including the keyed tables'
**insertion order** (each entry carries its insertion sequence number).

Float-tolerance policy (the reference's): integer columns, single float
operations and the first addend of every running sum are bit-exact;
multi-term float reductions (the within-group prefix sums inside
:func:`keyed_running_sum`) may diverge from the oracle's strict
left-to-right association in the last bits — the conformance tests compare
this tier with ``rtol=1e-9`` on floats in sink outputs and states, and only
there.

Scatters that the reference writes with ``mode="drop"`` (out-of-range
indices are dropped) go to one trash slot past the end of a copy here:
torch's scatters do not drop, and on the card an out-of-range index is a
device-side assert.

The port runs no mesh: the reference's ``.jit(mesh=...)`` shards runs over
devices, and a port mesh holds only the devices present, so on one card
its axis has one shard and the sharded call is the plain call.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import declared_sync
from repro_torch.engine.topology import StateField

# Sentinel for unused table slots and padding tuple codes.  Real codes must
# be < EMPTY_CODE (any keyed state built from finite attributes is).
EMPTY_CODE = np.iinfo(np.int64).max

_MIN_TUPLE_BUCKET = 16
_MIN_RUN_BUCKET = 4
_MIN_TABLE_CAP = 64


def _bucket(x: int, lo: int) -> int:
    b = lo
    while b < x:
        b <<= 1
    return b


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or scalar type)."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class TableState(NamedTuple):
    """One keyed-accumulator state field: a flat append-ordered table.

    Entries of *all* key groups share one capacity-``S`` slab (codes are
    globally unique — a code determines its key group): ``codes``/``vals``/
    ``owner`` hold the entries in insertion order (``cnt`` used,
    :data:`EMPTY_CODE` beyond), ``seq`` carries ``epoch << 32 |
    first_position`` — monotone in insertion order across calls, which is
    what reproduces the oracle dicts' insertion order — and ``perm`` is the
    code-sorted permutation of the slab, maintained incrementally by the
    merge in :func:`keyed_running_sum`.
    """

    codes: torch.Tensor  # (S,) int64, insertion order
    vals: torch.Tensor  # (S,) value dtype
    seq: torch.Tensor  # (S,) int64: epoch << 32 | first position
    owner: torch.Tensor  # (S,) int32 key group of each entry
    perm: torch.Tensor  # (S,) int32: slab indices in code-sorted order
    cnt: torch.Tensor  # () int32 used entries
    epoch: torch.Tensor  # () int64 call counter (seq high bits)


class VectorState(NamedTuple):
    """One bounded-window state field: a per-key-group ring of cells.

    ``data[k, :cnt[k]]`` holds key group ``k``'s window oldest-first — the
    exact list the per-run oracle keeps (``{name: [..]}``), so
    materialization is a slice, not a reconstruction.
    """

    data: torch.Tensor  # (K, length) value dtype, oldest-first per key group
    cnt: torch.Tensor  # (K,) int32 occupancy


# --------------------------------------------------------------------------
# fn_jit authoring helpers (pure PyTorch, no host synchronization; validity
# always derives from the run bounds, never from array lengths).
# --------------------------------------------------------------------------


def scatter_drop(dst: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """``dst`` with ``dst[idx] = src`` where ``idx`` is in range; indices
    equal to ``len(dst)`` land in a trash slot and are dropped.  Returns a
    new tensor; ``dst`` is not written."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    ext[idx] = src
    return ext[:n]


def tuple_valid(starts: torch.Tensor, ends: torch.Tensor, nb: int) -> torch.Tensor:
    """Per-position validity of the (padded) tuple arrays.

    Runs tile a contiguous slice, and padding runs (``start == end`` at the
    real tuple count) are a suffix, so the valid positions are exactly
    ``[starts[0], ends[-1])``.
    """
    pos = torch.arange(nb, device=starts.device)
    return (pos >= starts[0]) & (pos < ends[-1])


def run_of_tuples(ends: torch.Tensor, nb: int) -> torch.Tensor:
    """Run index per tuple position (meaningful where ``tuple_valid``)."""
    pos = torch.arange(nb, device=ends.device, dtype=ends.dtype)
    idx = torch.searchsorted(ends, pos, right=True)
    return torch.clamp(idx, max=ends.shape[0] - 1)


def count_runs(col: torch.Tensor, kgs, starts, ends) -> torch.Tensor:
    """Scalar-counter update: add each run's length to its key group's cell.

    Padding runs carry ``kg == K`` (out of range → the trash slot) and zero
    length.
    """
    k = col.shape[0]
    idx = torch.where((kgs >= 0) & (kgs < k), kgs, k)
    out = torch.cat([col, col.new_zeros(1)])
    out.index_add_(0, idx, (ends - starts).to(col.dtype))
    return out[:k]


def segmented_prefix(x: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of ``x`` within runs of equal ``gid`` (a
    nondecreasing group id per position): ceil(log2 n) doubling steps, each
    adding the partial sum ``off`` places back when that place is in the
    same group.  Exact at each group's first position; elsewhere the sums
    associate pairwise, never through other groups' values."""
    x = x.clone()
    n = x.shape[0]
    off = 1
    while off < n:
        x[off:] = torch.where(gid[off:] == gid[:-off], x[:-off] + x[off:], x[off:])
        off <<= 1
    return x


def keyed_running_sum(
    table: TableState,
    codes: torch.Tensor,
    kg: torch.Tensor,
    addends: torch.Tensor,
    valid: torch.Tensor,
    order: Optional[torch.Tensor] = None,
) -> tuple[TableState, torch.Tensor]:
    """Grouped running sums over one segment, against the keyed table.

    For every tuple ``i``: looks up ``codes[i]`` in the flat table, adds the
    within-segment prefix of its group's ``addends`` and returns the
    per-tuple running totals; new codes are appended to the slab with
    ``seq = epoch << 32 | first_position`` — monotone in first-occurrence
    order, which is exactly the order the per-run oracle inserts them into
    its dicts.  Requirements: equal codes always map to the same key group,
    real codes are non-negative and < 2^63 − 1, and the table has room for
    one new entry per tuple (the runtime grows it before the call).

    One stable sort of the segment (``order``, the stable argsort of
    ``where(valid, codes, EMPTY_CODE)``, may be handed in; stability defines
    it uniquely), then searchsorted, prefix sums and O(segment + capacity)
    gathers and scatters: the table's code-sorted view is merged
    incrementally, never re-sorted.  The within-group prefix is a segmented
    scan (:func:`segmented_prefix`) — the one place the tier's floats may
    diverge from the oracle's association; group heads take ``base +
    addend`` directly, so singleton groups stay bit-exact.  (The reference
    subtracts each group's start from one cumulative sum over the whole
    segment, which rounds at the magnitude of the segment's running total:
    at millions of tuples that alone exceeds the tolerance on groups whose
    sums are small.)
    """
    nb = codes.shape[0]
    cap = table.codes.shape[0]
    dev = codes.device
    mcodes = torch.where(valid, codes, EMPTY_CODE)
    if order is None:
        order = torch.argsort(mcodes, stable=True)  # ties keep tuple order
    order = order.long()
    sc = mcodes[order]
    real = sc != EMPTY_CODE
    sk = torch.where(real, kg[order], 0)
    sa = torch.where(real, addends[order], 0)
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sc[1:] != sc[:-1]])
    # Lookup through the maintained code-sorted view.
    perm = table.perm.long()
    scodes = table.codes[perm]  # (cap,) sorted, EMPTY tail
    lpos = torch.searchsorted(scodes, sc)
    pos = torch.clamp(lpos, max=cap - 1)
    fidx = perm[pos]  # candidate slab index
    has = (scodes[pos] == sc) & real
    base = torch.where(has, table.vals[fidx], 0)
    # Within-group inclusive prefix of the addends (== sa at heads).
    seg = torch.cumsum(head, 0) - 1  # group index per sorted position
    running_sorted = base + segmented_prefix(sa, seg)
    running = torch.empty_like(running_sorted)
    running[order] = running_sorted
    # ---- table update ----------------------------------------------------
    tail = torch.cat([head[1:], torch.ones(1, dtype=torch.bool, device=dev)])
    newhead = head & real & ~has
    nc_in = torch.cumsum(newhead, 0)  # inclusive new count (int64)
    total_new = nc_in[-1]
    rank = nc_in - 1  # code-order rank among new codes (valid at newheads)
    dest = table.cnt.long() + rank  # slab append position
    # Slab index per group (existing: the hit; new: the append slot),
    # broadcast from heads to the whole group.
    slab_head = torch.where(has, fidx, dest)
    hidx = torch.where(head, seg, nb)
    slabarr = scatter_drop(torch.zeros(nb, dtype=torch.int64, device=dev), hidx, slab_head)
    widx = torch.where(tail & real, slabarr[seg], cap)  # cap → dropped
    codes2 = scatter_drop(table.codes, widx, sc)
    vals2 = scatter_drop(table.vals, widx, running_sorted.to(table.vals.dtype))
    # seq/owner only change for new entries (scatter at newheads).
    nidx = torch.where(newhead, dest, cap)
    seq2 = scatter_drop(table.seq, nidx, (table.epoch << 32) | order)
    owner2 = scatter_drop(table.owner, nidx, sk.to(table.owner.dtype))
    # Merge the pre-sorted new codes into the sorted view.  Invariant: the
    # EMPTY tail of ``perm`` is ascending by slab index, so the entries the
    # append consumes are exactly the FIRST ``total_new`` EMPTY pointers.
    ncex = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), nc_in])  # exclusive
    is_empty_old = scodes == EMPTY_CODE
    shift_real = ncex[torch.searchsorted(sc, scodes)]
    jemp = torch.cumsum(is_empty_old, 0) - 1
    arange_cap = torch.arange(cap, device=dev)
    oldpos = torch.where(
        is_empty_old,
        torch.where(jemp < total_new, cap, arange_cap),  # consumed → dropped
        arange_cap + shift_real,
    )
    perm2 = scatter_drop(torch.zeros_like(table.perm), oldpos, table.perm)
    npos = torch.where(newhead, lpos + rank, cap)
    perm2 = scatter_drop(perm2, npos, dest.to(table.perm.dtype))
    return (
        TableState(
            codes2,
            vals2,
            seq2,
            owner2,
            perm2,
            table.cnt + total_new.to(table.cnt.dtype),
            table.epoch + 1,
        ),
        running,
    )


# --------------------------------------------------------------------------
# Per-operator runtime state.
# --------------------------------------------------------------------------


def empty_table(cap: int, dtype, device) -> TableState:
    """A capacity-``cap`` table with no entries, on ``device``."""
    kw = dict(device=device)
    return TableState(
        codes=torch.full((cap,), EMPTY_CODE, dtype=torch.int64, **kw),
        vals=torch.zeros(cap, dtype=torch_dtype(dtype), **kw),
        seq=torch.zeros(cap, dtype=torch.int64, **kw),
        owner=torch.zeros(cap, dtype=torch.int32, **kw),
        perm=torch.arange(cap, dtype=torch.int32, **kw),
        cnt=torch.zeros((), dtype=torch.int32, **kw),
        epoch=torch.ones((), dtype=torch.int64, **kw),
    )


def grown_table(t: TableState, new_cap: int) -> TableState:
    """``t`` extended to ``new_cap`` slots, on its device.  The sorted
    view's EMPTY tail (ascending by slab index) extends with the fresh
    indices — no re-sort."""
    old = t.codes.shape[0]
    pad = new_cap - old
    dev = t.codes.device

    def ext(x, fill=0):
        return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype, device=dev)])

    return TableState(
        codes=ext(t.codes, EMPTY_CODE),
        vals=ext(t.vals),
        seq=ext(t.seq),
        owner=ext(t.owner),
        perm=torch.cat([t.perm, torch.arange(old, new_cap, dtype=t.perm.dtype, device=dev)]),
        cnt=t.cnt,
        epoch=t.epoch,
    )


class _OpState:
    __slots__ = (
        "op",
        "spec",
        "base",
        "nkg",
        "fields",
        "has_vectors",
        "cols",
        "caps",
        "cnt_host",
        "col_auth",
        "value_names",
        "out_dtype",
        "out_names",
        "seen_keys",
    )

    def __init__(self, op: int, spec, base: int, device: torch.device) -> None:
        self.op = op
        self.spec = spec
        self.base = base
        self.nkg = spec.num_keygroups
        self.fields: tuple[StateField, ...] = (
            spec.state_schema.fields if spec.state_schema is not None else ()
        )
        self.has_vectors = any(f.kind == "vector" for f in self.fields)
        self.caps: dict[str, int] = {}
        self.cnt_host: dict[str, int] = {}
        self.col_auth = np.zeros(self.nkg, dtype=bool)
        cols = {}
        for f in self.fields:
            dt = torch_dtype(f.dtype)
            if f.kind == "scalar":
                cols[f.name] = torch.full((self.nkg,), f.init, dtype=dt, device=device)
            elif f.kind == "vector":
                cols[f.name] = VectorState(
                    data=torch.zeros((self.nkg, f.length), dtype=dt, device=device),
                    cnt=torch.zeros(self.nkg, dtype=torch.int32, device=device),
                )
            else:
                self.caps[f.name] = _MIN_TABLE_CAP
                self.cnt_host[f.name] = 0
                cols[f.name] = empty_table(_MIN_TABLE_CAP, f.dtype, device)
        self.cols = cols
        self.value_names = spec.schema.value.names if spec.schema is not None else None
        out_schema = spec.out_schema
        self.out_dtype = None if out_schema is None else out_schema.value
        self.out_names = None if out_schema is None else out_schema.value.names
        self.seen_keys: set = set()


class JitRuntime:
    """Executes fn_jit operators over device state columns for one Engine.

    Reads the engine's topology, store, metrics, key-group → operator map,
    device and spans; ``engine.spans`` at each use, since the owner may set
    it after the runtime is built."""

    def __init__(self, engine) -> None:
        self._engine = engine
        self._store = engine.store
        self._metrics = engine.metrics
        self.device = device = engine.device
        self._pin = device.type == "cuda"
        self.compile_seconds = 0.0
        self._by_op: dict[int, _OpState] = {}
        topology = engine.topology
        for op, spec in enumerate(topology.operators):
            if spec.fn_jit is not None:
                self._by_op[op] = _OpState(op, spec, topology.kg_base(op), device)

    # ------------------------------------------------------ host ↔ device
    def _put(self, src: np.ndarray, nb: int, fill=0) -> torch.Tensor:
        """``src`` padded with ``fill`` to ``nb`` entries, on the device: one
        counted copy (from pinned memory, asynchronous, on the card)."""
        src = np.asarray(src)
        if self._pin:
            host = torch.empty(nb, dtype=torch_dtype(src.dtype), pin_memory=True)
            buf = host.numpy()
        else:
            buf = np.empty(nb, dtype=src.dtype)
            host = torch.from_numpy(buf)
        n = len(src)
        buf[:n] = src
        buf[n:] = fill
        m = self._metrics
        m.host_device_copies += 1
        m.host_device_bytes += buf.nbytes
        return host.to(self.device, non_blocking=True)

    def _fetch(self, tensors: list) -> list[np.ndarray]:
        """Every tensor on the host, after ONE synchronization (asynchronous
        copies into pinned memory on the card): the call's declared read."""
        m = self._metrics
        m.host_device_copies += len(tensors)
        m.host_device_bytes += sum(t.numel() * t.element_size() for t in tensors)
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        host = [t.to("cpu", non_blocking=True) for t in tensors]
        with declared_sync(self.device):
            torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() for h in host]

    def _timed(self, phase: str, ost: _OpState, t0: float) -> float:
        """Add the seconds since ``t0`` to ``jit_<phase>_seconds`` and record
        the span ``jit.<phase>:<op>`` when the engine keeps spans; returns
        the clock's reading."""
        t1 = time.perf_counter()
        m = self._metrics
        name = f"jit_{phase}_seconds"
        setattr(m, name, getattr(m, name) + (t1 - t0))
        spans = self._engine.spans
        if spans is not None:
            spans.append((f"jit.{phase}:{ost.spec.name}", t0, t1))
        return t1

    # ------------------------------------------------------------ execution
    def execute(self, op, kgs, starts, ends, keys, values, ts):
        """Run one contiguous (node, operator) segment through the jit tier.

        ``kgs`` are global key-group ids; ``starts``/``ends`` are bounds
        relative to the ``keys``/``values``/``ts`` slice.  Returns
        ``(outputs, out_counts)`` exactly like an ``fn_seg`` call.
        """
        ost = self._by_op[op]
        n = len(keys)
        r = len(kgs)
        # One host↔device boundary per call (dispatch + output fetch).
        self._metrics.jit_host_syncs += 1
        if ost.has_vectors and len(set(kgs)) != r:
            # Window rings read pre-call occupancy per key group, so a call
            # with duplicate key groups (a budget-leftover segment
            # concatenated with a fresh one after a migration replay) would
            # shift from a stale ring.  Fall back to the numpy fn_seg tier
            # on the oracle dicts for this call.
            if ost.spec.fn_seg is None:
                raise ValueError(
                    f"operator {ost.spec.name!r} declares vector state but "
                    "no fn_seg fallback for duplicate-key-group segments"
                )
            for kg in set(int(k) for k in kgs):
                self.ensure_dict(kg)
            self._metrics.seg_calls += 1
            self._metrics.seg_tuples += n
            return ost.spec.fn_seg(
                self._store.raw(), list(kgs), list(starts), list(ends),
                keys, values, ts,
            )
        nb = _bucket(n, _MIN_TUPLE_BUCKET)
        rb = _bucket(r, _MIN_RUN_BUCKET)
        # The put phase: the pushes of dict-authoritative state, the padding
        # and the uploads, up to the body's call.
        t_put = time.perf_counter()
        lkgs = np.asarray(kgs, dtype=np.int64) - ost.base
        if ost.fields:
            self._prepare_state(ost, lkgs, n)
        put = self._put
        kg_pad = put(lkgs, rb, ost.nkg)
        s_pad = put(np.asarray(starts, dtype=np.int64), rb, n)
        e_pad = put(np.asarray(ends, dtype=np.int64), rb, n)
        key_pad = put(keys, nb)
        ts_pad = put(np.asarray(ts, dtype=np.float64), nb)
        if ost.value_names is None:
            v_arg = put(values, nb)
        else:
            v_arg = {name: put(values[name], nb) for name in ost.value_names}
        first = self._first_call(ost, (nb, rb, tuple(sorted(ost.caps.items()))))
        t0 = self._timed("put", ost, t_put)
        state_new, outputs, out_counts = ost.spec.fn_jit(
            ost.cols, kg_pad, s_pad, e_pad, key_pad, v_arg, ts_pad
        )
        if first:
            self._compiled(t0)
        self._timed("call", ost, t0)
        return self._finish(ost, lkgs, n, r, state_new, outputs, out_counts)

    def _finish(self, ost, lkgs, n, r, state_new, outputs, out_counts):
        """Install a call's state, read back the tables' counts and the
        outputs after one synchronization, and return ``(outputs,
        out_counts)`` as an ``fn_seg`` call does."""
        ost.cols = state_new
        tables = [f.name for f in ost.fields if f.kind == "table"]
        reads = [state_new[name].cnt for name in tables]
        if outputs is not None:
            ok, ov, ot = outputs
            if isinstance(ov, dict):
                if ost.out_dtype is None:
                    raise ValueError(
                        f"fn_jit of operator {ost.spec.name!r} returned record "
                        "columns but the operator declares no out_schema"
                    )
                ov_cols = [ov[name] for name in ost.out_names]
            else:
                ov_cols = [ov]
            reads += [ok, ot, *ov_cols]
            if out_counts is not None:
                reads.append(out_counts)
        t0 = time.perf_counter()
        host = self._fetch(reads)
        self._timed("fetch", ost, t0)
        for i, name in enumerate(tables):
            ost.cnt_host[name] = int(host[i])
        ost.col_auth[lkgs] = True
        self._metrics.jit_calls += 1
        self._metrics.jit_tuples += n
        if outputs is None:
            return None, None
        ok_h, ot_h, *ov_h = host[len(tables):]
        if out_counts is None:
            total, lens = n, None
        else:
            lens_arr = ov_h.pop()[:r]
            total = int(lens_arr.sum())
            lens = lens_arr.tolist()
        if isinstance(ov, dict):
            ov_np = np.empty(total, dtype=ost.out_dtype)
            for name, col in zip(ost.out_names, ov_h):
                ov_np[name] = col[:total]
        else:
            ov_np = ov_h[0][:total]
        return (ok_h[:total], ov_np, ot_h[:total]), lens

    def _first_call(self, ost: _OpState, key) -> bool:
        """Count the first call of ``key`` as a compile, as the reference
        counts a trace."""
        if key in ost.seen_keys:
            return False
        ost.seen_keys.add(key)
        self._metrics.jit_compiles += 1
        return True

    def _compiled(self, t0: float) -> None:
        if self.device.type == "cuda":
            with declared_sync(self.device):
                torch.cuda.synchronize(self.device)
        self.compile_seconds += time.perf_counter() - t0

    # ----------------------------------------------------- state coherence
    def _prepare_state(self, ost: _OpState, lkgs: np.ndarray, n: int) -> None:
        """Push dict-authoritative state, then size tables for this call."""
        pend = lkgs[~ost.col_auth[lkgs]]
        if len(pend):
            self._push(ost, pend)
        for f in ost.fields:
            if f.kind != "table":
                continue
            # The segment can insert at most one entry per tuple.
            need = ost.cnt_host[f.name] + n
            if need > ost.caps[f.name]:
                new_cap = _bucket(need, _MIN_TABLE_CAP)
                ost.cols[f.name] = grown_table(ost.cols[f.name], new_cap)
                ost.caps[f.name] = new_cap

    def _push(self, ost: _OpState, pend: np.ndarray) -> None:
        """Rebuild the columns with the pushed key groups' dict state.

        Scalar and vector fields scatter; table fields rebuild the packed
        slab host side (stale entries of the pushed key groups drop, their
        dict entries re-append with fresh sequence numbers above every kept
        one, and the sorted view is a host argsort — stable, so the EMPTY
        tail stays ascending by slab index).
        """
        store = self._store.raw()
        m = len(pend)
        put = self._put
        idx = put(pend, m)
        for f in ost.fields:
            if f.kind == "scalar":
                rows = np.fromiter(
                    (store[ost.base + int(lk)].get(f.name, f.init) for lk in pend),
                    dtype=f.dtype,
                    count=m,
                )
                ost.cols[f.name] = ost.cols[f.name].index_put((idx,), put(rows, m))
                continue
            if f.kind == "vector":
                v = ost.cols[f.name]
                data = np.zeros((m, f.length), dtype=f.dtype)
                cnt = np.zeros(m, dtype=np.int32)
                for j, lk in enumerate(pend):
                    ring = store[ost.base + int(lk)].get(f.name, [])
                    cnt[j] = len(ring)
                    data[j, : len(ring)] = ring
                ost.cols[f.name] = VectorState(
                    data=v.data.index_put((idx,), put(data.ravel(), m * f.length).view(m, -1)),
                    cnt=v.cnt.index_put((idx,), put(cnt, m)),
                )
                continue
            t = ost.cols[f.name]
            cnt = ost.cnt_host[f.name]
            codes, vals, seq, owner, epoch = self._fetch(
                [t.codes[:cnt], t.vals[:cnt], t.seq[:cnt], t.owner[:cnt], t.epoch]
            )
            keep = ~np.isin(owner, pend)
            new_c, new_v, new_o = [], [], []
            enc = f.key_encode
            for lk in pend:
                d = store[ost.base + int(lk)].get(f.name, {})
                for key, val in d.items():
                    new_c.append(enc(key))
                    new_v.append(val)
                    new_o.append(lk)
            n_keep = int(keep.sum())
            total = n_keep + len(new_c)
            cap = ost.caps[f.name]
            if total > cap:
                cap = _bucket(total, _MIN_TABLE_CAP)
                ost.caps[f.name] = cap
            pc = np.full(cap, EMPTY_CODE, dtype=np.int64)
            pv = np.zeros(cap, dtype=f.dtype)
            ps = np.zeros(cap, dtype=np.int64)
            po = np.zeros(cap, dtype=np.int32)
            pc[:n_keep] = codes[keep]
            pv[:n_keep] = vals[keep]
            ps[:n_keep] = seq[keep]
            po[:n_keep] = owner[keep]
            base_seq = int(ps[:n_keep].max()) + 1 if n_keep else 0
            if new_c:
                pc[n_keep:total] = new_c
                pv[n_keep:total] = new_v
                ps[n_keep:total] = base_seq + np.arange(len(new_c))
                po[n_keep:total] = new_o
            max_seq = int(ps[:total].max()) if total else 0
            ep = max(int(epoch), (max_seq >> 32) + 1)
            ost.cols[f.name] = TableState(
                codes=put(pc, cap),
                vals=put(pv, cap),
                seq=put(ps, cap),
                owner=put(po, cap),
                perm=put(np.argsort(pc, kind="stable").astype(np.int32), cap),
                cnt=put(np.array([total], dtype=np.int32), 1).reshape(()),
                epoch=put(np.array([ep], dtype=np.int64), 1).reshape(()),
            )
            ost.cnt_host[f.name] = total
        ost.col_auth[pend] = True

    def _host_cols(self, ost: _OpState) -> dict:
        """Every state column of ``ost`` on the host (one read); tables'
        used entries grouped by owner in insertion order, with each key
        group's bounds."""
        names, tensors = [], []
        for f in ost.fields:
            c = ost.cols[f.name]
            if f.kind == "scalar":
                got = [c]
            elif f.kind == "vector":
                got = [c.data, c.cnt]
            else:
                cnt = ost.cnt_host[f.name]
                got = [c.codes[:cnt], c.vals[:cnt], c.seq[:cnt], c.owner[:cnt]]
            names.append((f, len(got)))
            tensors += got
        arrs = iter(self._fetch(tensors))
        host = {}
        for f, k in names:
            got = [next(arrs) for _ in range(k)]
            if f.kind == "table":
                codes, vals, seq, owner = got
                order = np.lexsort((seq, owner))  # by owner, then insertion
                bounds = np.searchsorted(owner[order], np.arange(ost.nkg + 1))
                got = (codes[order], vals[order], bounds)
            host[f.name] = got
        return host

    def _to_dict(self, ost: _OpState, lk: int, host: dict) -> dict:
        """Materialize one key group's columns as the oracle state dict."""
        out: dict = {}
        for f in ost.fields:
            if f.kind == "scalar":
                out[f.name] = f.py(host[f.name][0][lk])
            elif f.kind == "vector":
                data, cnt = host[f.name]
                out[f.name] = [f.py(x) for x in data[lk][: int(cnt[lk])].tolist()]
            else:
                codes, vals, bounds = host[f.name]
                a, z = bounds[lk], bounds[lk + 1]
                dec, py = f.key_decode, f.py
                out[f.name] = {
                    dec(c): py(v) for c, v in zip(codes[a:z].tolist(), vals[a:z].tolist())
                }
        return out

    def ensure_dict(self, kg: int) -> None:
        """Make the python store dict authoritative for one key group.

        Called by the engine before any per-run ``fn`` fallback or state
        serialization touches a jit-tier operator's key group.
        """
        ost = self._by_op.get(int(self._engine._kg_op[kg]))
        if ost is None or not ost.fields:
            return
        lk = kg - ost.base
        if not ost.col_auth[lk]:
            return
        self._store.raw()[kg] = self._to_dict(ost, lk, self._host_cols(ost))
        ost.col_auth[lk] = False

    def invalidate(self, kg: int) -> None:
        """Dict state was externally replaced (migration install)."""
        ost = self._by_op.get(int(self._engine._kg_op[kg]))
        if ost is not None and ost.fields:
            ost.col_auth[kg - ost.base] = False

    def sync_store(self) -> None:
        """Refresh the store dicts of every column-authoritative key group
        (columns stay authoritative — this is the read-only statistics /
        conformance snapshot taken at ``end_period``)."""
        store = self._store.raw()
        for ost in self._by_op.values():
            if not ost.fields:
                continue
            lks = np.flatnonzero(ost.col_auth)
            if not len(lks):
                continue
            host = self._host_cols(ost)
            for lk in lks.tolist():
                store[ost.base + lk] = self._to_dict(ost, lk, host)
