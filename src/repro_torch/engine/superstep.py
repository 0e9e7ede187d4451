"""Device-resident superstep: route → drain → ``fn_jit`` fused on the device.

The port of ``repro.engine.superstep``.  The per-operator compiled tier
(:mod:`repro_torch.engine.jitexec`) crosses the host↔device boundary once
per operator per tick: the host drains segments, pads and uploads each
operator's columns, reads the outputs back, hashes and sorts them and pushes
the runs into numpy queues.  For a linear chain of 1:1 ``fn_jit`` operators
all of that inter-operator traffic is avoidable: the routing hash and the
routing sort are the ``keygroup_partition`` and ``radix_sort`` kernels, and
the drained runs of tick ``t`` are exactly the runs routed at tick ``t-1``.

* **Fused tick** (:meth:`SuperstepRuntime.try_fused_tick`): every fused
  operator's body runs over its pending (or uploaded) columns, and each
  non-terminal output is routed on the device (local key groups by
  ``keygroup_partition``, the ``(node, key group)`` composite by
  ``radix_sort``'s stable order, gathers of every column, the source ×
  destination pair matrix by integer scatter-adds).  Routed outputs stay on
  the device as *pending columns*; the queues hold **shadow segments** (run
  metadata with ``None`` arrays), so drain accounting, budgets,
  backpressure and migration bookkeeping replay bit-exactly on the host
  from the pair matrices, which come back with any sink output in ONE read
  per tick (``metrics.jit_host_syncs``), whatever the chain's depth.

* **K-tick scan** (:meth:`SuperstepRuntime.run_supersteps`): K fused ticks
  as one loop over device tensors with no host synchronization inside it,
  then one read.  Staging uploads each source batch once and hashes and
  sorts its source hop on the device.  When every non-terminal fused
  operator declares ``OperatorSpec.jit_key_map`` (a map of key *tensors*
  on the engine's device), staging also walks each batch down the chain
  with the same kernels, so the loop body carries no sort at all;
  otherwise the body routes on the device as the fused tick does.  On the
  card the loop is captured once per scan key into a CUDA graph (the
  counterpart of the reference's compiled ``lax.scan``; its first call per
  key counts in ``jit_compiles``) and replayed: the staged inputs, the
  run layouts and the state columns live in static buffers the graph
  reads.  On the CPU the loop runs eagerly.  Every pinned aggregate
  (metrics, states, sink outputs, arrivals, usage, send pairs, queue costs)
  is folded in exactly; per-admission latency samples and per-tick credit
  checks are not recorded — use :meth:`Engine.tick` when those matter.

Reconfiguration hook: every fused tick re-reads ``Router.table`` (its device
copy refreshed on ``Router.version``) and falls back to the classic tick —
after :meth:`SuperstepRuntime.flush_to_host` materializes the pending device
columns into real segment arrays — whenever a migration is in flight, a node
is dead, a budget would bind mid-segment, or the queues hold anything the
fused replay cannot express.  ``redirect``/``serialize``/``fail_node`` flush
first, so migration envelopes are byte-identical to the classic engine's at
any superstep boundary.

Eligibility is static (checked once per engine): a single source followed by
a linear chain of ``jit_fusible`` 1:1 ``fn_jit`` operators with declared
matching schemas, identity partition keys of integer dtype and scalar-only
state fields.  Anything else never fuses: the engine behaves exactly like the
per-operator tier.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import capture_graph, declared_sync
from repro_torch.engine import jitexec as jx
from repro_torch.engine.router import concat_batches
from repro_torch.engine.topology import _identity_key
from repro_torch.kernels import bucket_argsort, keygroup_partition

__all__ = ["SuperstepRuntime", "local_keygroups", "plan_chain"]


# --------------------------------------------------------------------------
# Device routing helpers.
# --------------------------------------------------------------------------


def local_keygroups(keys: torch.Tensor, nkg: int) -> torch.Tensor:
    """Local key-group ids (int64, base 0) of integer keys: the ids
    ``topology._mixed_keygroups`` gives, by the ``keygroup_partition``
    kernel on a CUDA tensor and by its plain version on a CPU tensor (the
    kernel's fold sign-extends int32 keys, as the reference's mix does)."""
    return keygroup_partition(_hashable(keys), nkg)[0]


def _hashable(keys: torch.Tensor) -> torch.Tensor:
    """Keys as the partition kernel takes them: contiguous int32 or int64
    (narrower integers widen with their sign, as numpy's ``astype``)."""
    if keys.dtype not in (torch.int32, torch.int64):
        keys = keys.to(torch.int64)
    return keys.contiguous()


def _sorted_order(comp: torch.Tensor, buckets: int) -> torch.Tensor:
    """Stable order of routing codes in ``[0, buckets)`` by ``radix_sort``
    (int16 codes when they fit, int32 otherwise)."""
    return bucket_argsort(comp.to(torch.int16 if buckets <= 32768 else torch.int32), buckets)


def _pair_matrix(src: torch.Tensor, dst: torch.Tensor, valid, rows: int, cols: int) -> torch.Tensor:
    """(rows, cols) int64 counts of the (src, dst) pairs where ``valid``
    (None: everywhere): an integer scatter-add, exact in any order; invalid
    pairs land in one trash slot past the end."""
    flat = src * cols + dst
    if valid is not None:
        flat = torch.where(valid, flat, rows * cols)
    out = torch.zeros(rows * cols + 1, dtype=torch.int64, device=src.device)
    out.index_add_(0, flat, torch.ones_like(flat))
    return out[:-1].view(rows, cols)


def _count_routes(metrics, op: int, n: int = 1) -> None:
    """``n`` batches routed to ``op`` on the device, each partitioned by
    ``keygroup_partition`` and sorted by ``radix_sort``."""
    for per_op in (metrics.routed_batches, metrics.partition_kernel_batches,
                   metrics.sort_kernel_batches):
        per_op[op] = per_op.get(op, 0) + n


def _add_repeated(acc: np.ndarray, idx: np.ndarray, counts: np.ndarray, c: float) -> None:
    """``np.add.at(acc, np.repeat(idx, counts), c)`` for distinct ``idx``,
    without the repeats: each ``acc[idx[j]] += c``, ``counts[j]`` times in
    order.  When ``c`` and every ``acc[idx]`` lie on a common power-of-two
    grid and every partial sum stays below 2^52 grid steps, all the adds
    are exact and ``counts * c`` gives the same bits in one add; otherwise
    the adds run one masked vector step at a time."""
    x = acc[idx]
    vals = np.append(x, c)
    for s in range(31):
        q = 2.0**-s
        if np.array_equal(np.floor(vals / q), vals / q):
            top = np.maximum(np.abs(x), np.abs(x + counts * c))
            if top.size == 0 or top.max() < 2.0**52 * q:
                acc[idx] = x + counts * c
                return
            break
    for j in range(int(counts.max(initial=0))):
        x = np.where(j < counts, x + c, x)
    acc[idx] = x


# --------------------------------------------------------------------------
# Static fusion plan.
# --------------------------------------------------------------------------


class _Plan:
    """Static description of the fusible chain: source, then fused ops."""

    __slots__ = ("source", "fops", "fset", "specs", "nkg", "base", "key_maps", "static_route")

    def __init__(self, source, fops, specs, nkg, base):
        self.source = source
        self.fops = fops  # fused operator ids, chain order
        self.fset = frozenset(fops)
        self.specs = specs
        self.nkg = nkg
        self.base = base
        # Key transforms (OperatorSpec.jit_key_map, over key tensors on the
        # engine's device) of the non-terminal fused operators.  When every
        # one is declared, the K-tick scan's routing schedule (hash → stable
        # radix permutation → pair-count matrices) is a pure function of the
        # staged input keys: run_supersteps computes it while staging and the
        # scan body carries no sorts.
        self.key_maps = [s.jit_key_map for s in specs[:-1]]
        self.static_route = all(m is not None for m in self.key_maps)


def plan_chain(engine) -> Optional[_Plan]:
    """Static superstep eligibility; ``None`` → this engine never fuses.

    The reference refuses engines that collect its Pallas partition
    statistics (``kernel_stats``); the port has no such switch (routing
    always runs through its kernels).
    """
    topo = engine.topology
    if not engine.use_schema:
        return None
    downs, ups = topo.downstream(), topo.upstream()
    sources = [i for i, o in enumerate(topo.operators) if o.is_source]
    if len(sources) != 1:
        return None
    src = sources[0]
    if topo.operators[src].fn is not None or topo.operators[src].schema is None:
        return None
    chain = [src]
    cur = src
    while downs[cur]:
        if len(downs[cur]) != 1:
            return None
        nxt = downs[cur][0]
        if len(ups[nxt]) != 1:
            return None
        chain.append(nxt)
        cur = nxt
    if len(chain) < 2 or len(chain) != topo.num_operators:
        return None
    if not engine._op_terminal[chain[-1]]:
        return None
    prev_out = topo.operators[src].schema
    for op in chain[1:]:
        spec = topo.operators[op]
        terminal = op == chain[-1]
        if engine._op_fn_jit[op] is None or not spec.jit_fusible:
            return None
        if spec.fn is None or spec.schema is None:
            return None
        if spec.key_fn is not _identity_key or spec.key_by_value is not None:
            return None
        if not np.issubdtype(spec.schema.key, np.integer):
            return None
        fields = spec.state_schema.fields if spec.state_schema is not None else ()
        if any(f.kind != "scalar" for f in fields):
            return None
        # The routed edge must be conformance-free: producer output layout
        # identical to this operator's declared input layout.
        if prev_out is None:
            return None
        if spec.schema.key != prev_out.key or spec.schema.value != prev_out.value:
            return None
        if not terminal:
            if spec.out_schema is None:
                return None
            prev_out = spec.out_schema
    fops = chain[1:]
    return _Plan(
        src,
        fops,
        [topo.operators[o] for o in fops],
        [topo.operators[o].num_keygroups for o in fops],
        [topo.kg_base(o) for o in fops],
    )


class _DevicePending:
    """Routed-but-undrained tuples of one operator, resident on the device.

    ``keys``/``values``/``ts`` are the comp-sorted padded columns produced by
    the fused routing step (valid rows ``[0, n)``, garbage tail beyond —
    safe under the ``jit_fusible`` run-bounds contract); the matching shadow
    segments in the node queues carry the run metadata referencing them.
    """

    __slots__ = ("keys", "values", "ts", "n")

    def __init__(self, keys, values, ts, n):
        self.keys = keys
        self.values = values
        self.ts = ts
        self.n = n


def _columns(values, names) -> list:
    """A value column or record columns (in ``names`` order) as a list."""
    return [values[nm] for nm in names] if isinstance(values, dict) else [values]


def _records(cols: list, dtype: np.dtype) -> np.ndarray:
    """Host columns (from :func:`_columns`) as one array of ``dtype``."""
    if dtype.names is None:
        return cols[0]
    out = np.empty(cols[0].shape, dtype=dtype)
    for nm, col in zip(dtype.names, cols):
        out[nm] = col
    return out


class SuperstepRuntime:
    """Fused superstep execution for one :class:`repro_torch.engine.Engine`."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.plan = plan_chain(engine)
        self._pending: dict[int, Optional[_DevicePending]] = {}
        self._scan_cache: dict = {}
        self._seen_keys: set = set()
        self._tables_version = -1
        self._tables: list = []
        #: The last K-tick scan run (its static inputs, outputs and, on the
        #: card, its graph): what chip_smoke.py holds the replay against.
        self.last_scan: Optional[_Scan] = None
        self._stream = None  # the capture stream (CUDA only)

    # ------------------------------------------------------------ plumbing
    def _jrt(self):
        return self.engine._jit_runtime()

    def _dev_tables(self) -> list:
        """Per fused operator, its slice of the routing table on the device
        (views of ``Engine._device_table``) — re-read only when
        ``Router.version`` moved (the per-superstep reconfiguration hook)."""
        eng = self.engine
        if eng.router.version != self._tables_version:
            table = eng._device_table()
            self._tables = [
                table[b : b + n] for b, n in zip(self.plan.base, self.plan.nkg)
            ]
            self._tables_version = eng.router.version
        return self._tables

    def flush_to_host(self) -> None:
        """Materialize pending device columns into their shadow segments.

        Run metadata (bounds, costs, queue order) is already exact; only the
        ``None`` array slots are filled — in one declared read — so a
        subsequent classic tick drains precisely what the fused tick would
        have.  Idempotent and free when nothing is pending.
        """
        if not self._pending:
            return
        eng = self.engine
        live = [(op, p) for op, p in self._pending.items() if p is not None]
        reads = []
        for op, p in live:
            reads += [p.keys, p.ts, *_columns(p.values, eng._op_schema[op].value.names)]
        host = iter(self._jrt()._fetch(reads)) if reads else iter(())
        mats = {}
        for op, p in live:
            dt = eng._op_schema[op].value
            keys_np, ts_np = next(host), next(host)
            cols = [next(host) for _ in (dt.names or (None,))]
            mats[op] = (keys_np, _records(cols, dt), ts_np)
        for q in eng._queues:
            for seg in q._segs:
                if seg[0] is None and seg[3] in mats:
                    k, v, t = mats[seg[3]]
                    seg[0], seg[1], seg[2] = k, v, t
        self._pending = {}

    # ----------------------------------------------------- dynamic gating
    def _collect(self):
        """Validate this tick for fusion: ``(non-empty queues, per fused
        operator "real"/"shadow"/None)``, or ``None``.

        Read-only: replicates every branch decision of the classic SoA drain
        (whole-budget eligibility, contiguity, FIFO order) without mutating
        anything, so a ``None`` return falls back to the classic tick with
        the queues untouched.  (The reference also lists the segments; the
        fused tick walks the queues itself.)
        """
        eng = self.engine
        plan = self.plan
        if plan is None:
            return None
        if eng.router.has_in_flight() or eng._backlog or not bool(eng.alive.all()):
            return None
        src, fset = plan.source, plan.fset
        mode: dict[int, Optional[str]] = {op: None for op in plan.fops}
        nonempty = 0
        for node, q in enumerate(eng._queues):
            if not q:
                continue
            nonempty += 1
            budget = eng.service_rate * eng._capacity_list[node]
            segs = q._segs
            last = segs[-1]
            for seg in segs:
                if seg[8] != 0 or not seg[9]:  # partially drained / non-contig
                    return None
                op = seg[3]
                if op == src:
                    if seg[0] is None:
                        return None
                elif op in fset:
                    m = "shadow" if seg[0] is None else "real"
                    if m == "shadow" and self._pending.get(op) is None:
                        return None
                    if mode[op] is None:
                        mode[op] = m
                    elif mode[op] != m:
                        return None  # mixed real+shadow (post-migration)
                else:
                    return None
                costs = seg[7]
                rem = 0.0
                for c in costs:
                    rem += c
                if budget < rem:
                    return None  # classic would partial-drain this segment
                for c in costs:
                    budget -= c
                if budget <= 0 and seg is not last:
                    return None  # classic would stop draining this node
        for op, p in self._pending.items():
            if p is not None and mode.get(op) != "shadow":
                return None  # pending exists but its segments are gone
        return nonempty, mode

    # ------------------------------------------------------- fused device
    def _fused(self, active, nbs, states, runs, inputs, tables):
        """One tick's device work: every active operator's body, then each
        non-terminal output routed on the device.  Returns the new states,
        the routed (pending) columns, the per-edge pair matrices and the
        terminal output (when collected)."""
        plan = self.plan
        eng = self.engine
        nkgs = plan.nkg
        last = len(plan.fops) - 1
        new_states, pend, pairs, term = {}, {}, {}, None
        for i in active:
            kg_pad, s_pad, e_pad = runs[i]
            keys, values, ts = inputs[i]
            st, out, oc = plan.specs[i].fn_jit(states[i], kg_pad, s_pad, e_pad, keys, values, ts)
            if oc is not None:
                raise ValueError(
                    f"operator {plan.specs[i].name!r} is jit_fusible but "
                    "returned out_counts — fused operators must be 1:1"
                )
            new_states[i] = st
            if i == last:
                if eng.collect_sinks and out is not None:
                    term = out
                continue
            if out is None:
                raise ValueError(
                    f"non-terminal fused operator {plan.specs[i].name!r} emitted None"
                )
            ok, ov, ot = out
            nb = nbs[i]
            nkg_n = nkgs[i + 1]
            valid = jx.tuple_valid(s_pad, e_pad, nb)
            dst = local_keygroups(ok, nkg_n)
            sent = eng.num_nodes * nkg_n
            comp = torch.where(valid, tables[i + 1][dst] * nkg_n + dst, sent)
            order = _sorted_order(comp, sent + 1)
            pv = {nm: col[order] for nm, col in ov.items()} if isinstance(ov, dict) else ov[order]
            pend[i] = (ok[order], pv, ot[order])
            src_l = kg_pad[jx.run_of_tuples(e_pad, nb)]
            pairs[i] = _pair_matrix(src_l, dst, valid, nkgs[i], nkg_n)
        return new_states, pend, pairs, term

    # ---------------------------------------------------------- fused tick
    def try_fused_tick(self) -> bool:
        """Attempt one fully fused superstep; ``False`` → caller must flush
        pendings and run the classic tick instead."""
        colln = self._collect()
        if colln is None:
            return False
        eng = self.engine
        plan = self.plan
        metrics = eng.metrics
        nonempty, mode = colln
        eng.metrics.ticks += 1
        eng._ticks_this_period += 1
        if nonempty == 0:
            return True  # empty tick: counters only, no device call
        jrt = self._jrt()
        put = jrt._put

        # -- drain replay: accounting + input collection (node-asc, FIFO) --
        drained_kgs: list = []
        drained_costs: list = []
        src_items: list = []
        processed = src_emitted = 0
        # per fused op, in drain order: (node, kgs, starts, ends, k, v, t)
        drains: dict[int, list] = {op: [] for op in plan.fops}
        for node, q in enumerate(eng._queues):
            if not q:
                continue
            qcost = q.cost
            segs = q._segs
            while segs:
                seg = segs[0]
                keys, values, ts, op, kgs, starts, ends, costs, _, _ = seg
                drained_kgs.extend(kgs)
                drained_costs.extend(costs)
                for c in costs:
                    qcost -= c
                a0, zn = starts[0], ends[-1]
                processed += zn - a0
                if op == plan.source:
                    # Source pass-through forwards its whole slice (and the
                    # classic drain counts that as an emission).
                    src_emitted += zn - a0
                    lens = np.subtract(ends, starts)
                    kg_arr = np.repeat(np.asarray(kgs, dtype=np.int64), lens)
                    src_items.append(((keys[a0:zn], values[a0:zn], ts[a0:zn]), kg_arr, node))
                else:
                    drains[op].append((node, kgs, starts, ends, keys, values, ts))
                segs.popleft()
            q.cost = qcost
        metrics.processed_tuples += processed
        metrics.emitted_tuples += src_emitted

        # -- assemble the device call ----------------------------------------
        fops = plan.fops
        active = [i for i, op in enumerate(fops) if drains[op]]
        runs_args: dict[int, tuple] = {}
        in_args: dict[int, tuple] = {}
        lkgs_by_i: dict[int, np.ndarray] = {}
        n_by_i: dict[int, int] = {}
        nbs: dict[int, int] = {}
        src_node_of: dict[int, np.ndarray] = {}
        for i in active:
            op = fops[i]
            ost = jrt._by_op[op]
            ents = drains[op]
            rk: list = []
            node_map = np.full(plan.nkg[i], -1, dtype=np.int64)
            if mode[op] == "shadow":
                p = self._pending[op]
                n = p.n
                rs: list = []
                re_: list = []
                for node, kgs, starts, ends, _, _, _ in ents:
                    rk.extend(kgs)
                    rs.extend(starts)
                    re_.extend(ends)
                    for kg in kgs:
                        node_map[kg - plan.base[i]] = node
                k_in, v_in, t_in = p.keys, p.values, p.ts
                nb = len(p.keys)
            else:
                # Real segments (e.g. first tick, or after a migration
                # flush): concatenate exactly like _flush_jit_batch and
                # upload padded columns.
                cat_k, cat_v, cat_t = [], [], []
                rs, re_ = [], []
                off = 0
                for node, kgs, starts, ends, keys, values, ts in ents:
                    a0, zn = starts[0], ends[-1]
                    rk.extend(kgs)
                    rs.extend(a - a0 + off for a in starts)
                    re_.extend(z - a0 + off for z in ends)
                    cat_k.append(keys[a0:zn])
                    cat_v.append(values[a0:zn])
                    cat_t.append(ts[a0:zn])
                    off += zn - a0
                    for kg in kgs:
                        node_map[kg - plan.base[i]] = node
                keys_c = cat_k[0] if len(cat_k) == 1 else np.concatenate(cat_k)
                vals_c = cat_v[0] if len(cat_v) == 1 else np.concatenate(cat_v)
                ts_c = cat_t[0] if len(cat_t) == 1 else np.concatenate(cat_t)
                n = off
                nb = jx._bucket(n, jx._MIN_TUPLE_BUCKET)
                k_in = put(keys_c, nb)
                t_in = put(np.asarray(ts_c, dtype=np.float64), nb)
                if ost.value_names is None:
                    v_in = put(vals_c, nb)
                else:
                    v_in = {nm: put(vals_c[nm], nb) for nm in ost.value_names}
            r = len(rk)
            rb = jx._bucket(r, jx._MIN_RUN_BUCKET)
            lkgs = np.asarray(rk, dtype=np.int64) - plan.base[i]
            if ost.fields:
                jrt._prepare_state(ost, lkgs, n)
            runs_args[i] = (
                put(lkgs, rb, ost.nkg),
                put(np.asarray(rs, dtype=np.int64), rb, n),
                put(np.asarray(re_, dtype=np.int64), rb, n),
            )
            in_args[i] = (k_in, v_in, t_in)
            lkgs_by_i[i] = lkgs
            n_by_i[i] = n
            nbs[i] = nb
            src_node_of[i] = node_map

        key = (
            tuple(active),
            tuple(nbs[i] for i in active),
            tuple(runs_args[i][0].shape[0] for i in active),
            eng.num_nodes,
            eng.collect_sinks,
        )
        states = {i: jrt._by_op[fops[i]].cols for i in active}
        tables = self._dev_tables()
        first = key not in self._seen_keys
        if first:
            self._seen_keys.add(key)
            metrics.jit_compiles += 1
            t0 = time.perf_counter()
        new_states, pend_dev, pairs_dev, term = self._fused(
            active, nbs, states, runs_args, in_args, tables
        )
        if first:
            if jrt.device.type == "cuda":
                with declared_sync(jrt.device):
                    torch.cuda.synchronize(jrt.device)
            jrt.compile_seconds += time.perf_counter() - t0
        last = len(fops) - 1
        for i in active:
            ost = jrt._by_op[fops[i]]
            ost.cols = new_states[i]
            ost.col_auth[lkgs_by_i[i]] = True
            metrics.jit_calls += 1
            metrics.jit_tuples += n_by_i[i]
        for i in pairs_dev:
            _count_routes(metrics, fops[i + 1])
        # The tick's one host crossing: every pair matrix and the sink
        # output, read together.
        metrics.jit_host_syncs += 1
        edges = sorted(pairs_dev)
        reads = [pairs_dev[i] for i in edges]
        term_ost = jrt._by_op[fops[last]]
        if term is not None and n_by_i.get(last, 0) > 0:
            ok, ov, ot = term
            reads += [ok, ot, *_columns(ov, term_ost.out_names)]
        host = jrt._fetch(reads) if reads else []
        pairs_host = dict(zip(edges, host))

        # -- emission accounting + sink output (mirrors _flush_jit_batch) ----
        for i in active:
            n = n_by_i[i]
            if n == 0:
                continue
            if i == last:
                if term is None and not eng.collect_sinks:
                    # Terminal output exists but was not fetched.  Emission
                    # counts still mirror the classic path: a 1:1 terminal
                    # operator emits its input count (None-output sinks like
                    # pure counters emit nothing).
                    if _emits(plan.specs[i]):
                        metrics.emitted_tuples += n
                        metrics.sink_tuples += n
                elif term is not None:
                    metrics.emitted_tuples += n
                    metrics.sink_tuples += n
                    ok_np, ot_np, *cols = host[len(edges):]
                    ov_np = _records([c[:n] for c in cols], term_ost.out_dtype or cols[0].dtype)
                    metrics.sink_outputs.extend(
                        zip(ok_np[:n].tolist(), ov_np.tolist(), ot_np[:n].tolist())
                    )
            else:
                metrics.emitted_tuples += n

        if drained_kgs:
            np.add.at(eng._cpu_usage, drained_kgs, drained_costs)

        # -- routing replay, in sorted destination-operator order ------------
        producers: dict[int, tuple] = {}
        if src_items:
            producers[fops[0]] = ("source", None)
        for i in active:
            if i != last:
                producers[fops[i + 1]] = ("pairs", i)
        for i in range(last):
            # Downstream of an inactive/empty producer gets no new pending.
            if i not in pairs_dev and fops[i + 1] not in producers:
                self._pending[fops[i + 1]] = None
        for dop in sorted(producers):
            kind, i = producers[dop]
            if kind == "source":
                self._route_source_items(dop, src_items)
            else:
                self._replay_route(i, dop, pairs_host[i], pend_dev.get(i), src_node_of[i])
        return True

    def _route_source_items(self, dop: int, items: list) -> None:
        """Deliver the source's pass-through batches through the real
        router — identical to ``Engine._flush_outputs`` for one operator."""
        eng = self.engine
        schema = eng._op_schema[dop]
        if len(items) == 1:
            batch, src_kg, src_node = items[0]
            batch = eng._conform_batch(batch, schema)
            n = len(batch[0])
            src_kgs = src_kg
            src_nodes = np.full(n, src_node, dtype=np.int64)
        else:
            batches, kg_t, nd_t = zip(*items)
            batch = concat_batches([eng._conform_batch(b, schema) for b in batches])
            m = len(items)
            lens = np.fromiter((len(b[0]) for b in batches), np.int64, count=m)
            src_kgs = np.concatenate(list(kg_t))
            src_nodes = np.repeat(np.fromiter(nd_t, np.int64, count=m), lens)
        eng._route_batch(dop, batch, src_kgs=src_kgs, src_nodes=src_nodes)

    def _replay_route(self, i, dop, pairs, pend, src_node_of) -> None:
        """Host replay of ``_route_batch`` for a device-routed edge.

        ``pairs[src_lkg, dst_lkg]`` counts this tick's tuples on the edge;
        together with the router table and the producer's drain-node map it
        reproduces every statistic the classic route records — send pairs,
        cross/intra splits, serialization charges, arrivals, admissions —
        and pushes shadow segments whose costs walk the queues' float
        trajectories bit-exactly.
        """
        eng = self.engine
        plan = self.plan
        metrics = eng.metrics
        window = eng.window
        total = int(pairs.sum())
        if total == 0:
            self._pending[dop] = None
            return
        metrics.typed_batches += 1
        base_s, base_d = plan.base[i], plan.base[i + 1]
        nkg_d = plan.nkg[i + 1]
        sl, dl = np.nonzero(pairs)
        cnt = pairs[sl, dl]
        dense = window.record_send_counts(sl + base_s, dl + base_d, cnt)
        metrics.pair_dense_entries += dense
        metrics.pair_sparse_entries += len(sl) - dense
        dst_nodes_l = eng.router.table[base_d : base_d + nkg_d]
        cross = src_node_of[sl] != dst_nodes_l[dl]
        n_cross = int(cnt[cross].sum())
        if n_cross:
            g = len(eng._arrivals)
            both = np.zeros(g, dtype=np.int64)
            np.add.at(both, sl[cross] + base_s, cnt[cross])
            np.add.at(both, dl[cross] + base_d, cnt[cross])
            eng._cpu_usage += both * eng.ser_cost
            window.kg_usage["network"] += both
        metrics.cross_node_tuples += n_cross
        metrics.intra_node_tuples += total - n_cross
        counts_l = pairs.sum(axis=0)
        nzl = np.flatnonzero(counts_l)
        comp_l = dst_nodes_l[nzl] * nkg_d + nzl
        ordr = np.argsort(comp_l)  # distinct comps: plain argsort is exact
        nzl = nzl[ordr]
        counts = counts_l[nzl]
        ends = np.cumsum(counts)
        starts = ends - counts
        run_nodes = dst_nodes_l[nzl]
        uniq = nzl + base_d
        np.add.at(eng._arrivals, uniq, counts)
        costs = counts * eng._cost_per_tuple[dop]
        self._pending[dop] = _DevicePending(pend[0], pend[1], pend[2], total)
        queues = eng._queues
        if len(uniq) == 1:
            node = int(run_nodes[0])
            queues[node].push_runs(
                dop, None, None, None,
                uniq.tolist(), starts.tolist(), ends.tolist(), costs.tolist(),
                contig=True,
            )
            eng._record_admission(node, int(counts[0]))
            return
        gstarts = np.flatnonzero(np.concatenate(([True], run_nodes[1:] != run_nodes[:-1])))
        unodes = run_nodes[gstarts].tolist()
        gends = np.append(gstarts[1:], len(run_nodes))
        kg_l, st_l = uniq.tolist(), starts.tolist()
        en_l, co_l = ends.tolist(), costs.tolist()
        node_counts = np.add.reduceat(counts, gstarts).tolist()
        service_rate = eng.service_rate
        caps = eng._capacity_list
        lat_append = eng.latency.samples.append
        gsl, gel = gstarts.tolist(), gends.tolist()
        for j in range(len(unodes)):
            a, z = gsl[j], gel[j]
            node = unodes[j]
            q = queues[node]
            q.push_runs(
                dop, None, None, None,
                kg_l[a:z], st_l[a:z], en_l[a:z], co_l[a:z],
                contig=True,
            )
            admitted = node_counts[j]
            lat_append(
                (
                    q.cost / max(service_rate * caps[node], 1e-9),
                    admitted if admitted < 16 else 16,
                )
            )

    # ------------------------------------------------------- K-tick scan
    def run_supersteps(self, batches) -> int:
        """Steady-state mode: K source batches through one K-step loop.

        Batch ``t`` is ingested at the source (typed conversion on the host;
        upload, hash and the pass-through hop's sort on the device), reaches
        the first fused operator at step ``t`` and flows one chain hop per
        step; the host boundary is crossed once for all K ticks
        (``metrics.jit_host_syncs += 1``).  Aggregate statistics (metrics,
        arrivals, usage, send pairs, queue costs, states, sink outputs) are
        folded in exactly; per-admission latency samples and per-tick credit
        checks are not recorded.

        Requires empty queues (run ``tick()`` until drained first); leaves
        the final in-flight pendings materialized as real segments so
        subsequent classic ticks drain them.  Returns K.
        """
        eng = self.engine
        plan = self.plan
        if plan is None:
            raise RuntimeError("topology is not superstep-fusible")
        if self._pending:
            self.flush_to_host()
        if any(bool(q) for q in eng._queues):
            raise RuntimeError("run_supersteps requires empty queues — tick() until drained")
        if eng.router.has_in_flight() or not bool(eng.alive.all()):
            raise RuntimeError(
                "run_supersteps cannot run during a migration or with dead nodes — use tick()"
            )
        K = len(batches)
        if K == 0:
            return 0
        metrics = eng.metrics
        jrt = self._jrt()
        src, fops = plan.source, plan.fops
        # Backpressure guard: the scan performs no per-tick credit checks,
        # so refuse workloads a single node's budget could not absorb.
        nmax = max(len(b[0]) for b in batches)
        worst = nmax * (eng._cost_per_tuple[src] + sum(eng._cost_per_tuple[o] for o in fops))
        min_budget = eng.service_rate * min(eng._capacity_list)
        if worst >= min_budget:
            raise RuntimeError(
                "run_supersteps: a superstep's worst-case cost "
                f"({worst:.3g}) reaches the smallest node budget "
                f"({min_budget:.3g}); backpressure would bind — use tick()"
            )
        nb1 = jx._bucket(nmax, jx._MIN_TUPLE_BUCKET)
        # -- prepare state columns: any kg can receive tuples mid-scan ------
        for op in fops:
            ost = jrt._by_op[op]
            if ost.fields:
                jrt._prepare_state(ost, np.arange(ost.nkg, dtype=np.int64), 0)
        key = (K, nb1, eng.collect_sinks, eng.router.version)
        scan = self._scan_cache.get(key)
        if scan is None:
            # The router's version only moves forward: a scan captured for
            # an older table is never replayed again.
            self._scan_cache = {
                k: s for k, s in self._scan_cache.items() if k[3] == eng.router.version
            }
            scan = self._scan_cache[key] = _Scan(self, K, nb1)
        self.last_scan = scan
        staged = self._stage(scan, batches)
        first = key not in self._seen_keys
        if first:
            self._seen_keys.add(key)
            metrics.jit_compiles += 1
            t0 = time.perf_counter()
        out = scan.run([jrt._by_op[op].cols for op in fops])
        if first:
            if jrt.device.type == "cuda":
                with declared_sync(jrt.device):
                    torch.cuda.synchronize(jrt.device)
            jrt.compile_seconds += time.perf_counter() - t0
        for op, st in zip(fops, out["states"]):
            jrt._by_op[op].cols = st
        self._fold(scan, staged, out)
        return K

    def _stage(self, scan: "_Scan", batches) -> dict:
        """Write the K batches into the scan's static inputs, on the device.

        Each batch is uploaded once; its source key groups, its first
        operator's key groups (and histogram: the run counts) come from
        ``keygroup_partition``, the pass-through hop's ``(node, key group)``
        order from ``radix_sort``.  Under ``static_route`` each batch then
        walks the chain — ``jit_key_map`` on the key tensors, the same two
        kernels per hop — giving every hop's stable permutation and count
        matrices, rows shifted by the hop (batch t crosses hop i at step
        t+i; identity orders and zero counts during pipeline fill).  Nothing
        is read back here: the statistics stay on the device for the one
        read after the loop.
        """
        eng = self.engine
        plan = self.plan
        topo = eng.topology
        jrt = self._jrt()
        put = jrt._put
        metrics = eng.metrics
        dev = jrt.device
        K = scan.K
        src, fops = plan.source, plan.fops
        schema = topo.operators[src].schema
        nkg_s, base_s = topo.operators[src].num_keygroups, topo.kg_base(src)
        nkg1, base1 = plan.nkg[0], plan.base[0]
        g = len(eng._arrivals)
        nhops = len(fops) - 1
        table_dev = eng._device_table()
        tables = self._dev_tables()
        scan.reset()
        ns = np.zeros(K, dtype=np.int64)
        src_hist = torch.zeros((K, nkg_s), dtype=torch.int64, device=dev)
        both = torch.zeros((K, g + 1), dtype=torch.int64, device=dev)
        pr_src = torch.zeros(nkg_s * nkg1, dtype=torch.int64, device=dev)
        static = plan.static_route
        if static:
            pr_sum = [
                torch.zeros(plan.nkg[i] * plan.nkg[i + 1], dtype=torch.int64, device=dev)
                for i in range(nhops)
            ]
            pr_last = [torch.zeros_like(p) for p in pr_sum]
            pend_cnt = [
                torch.zeros(plan.nkg[i + 1], dtype=torch.int64, device=dev) for i in range(nhops)
            ]
        for t, (bk, bv, bt) in enumerate(batches):
            n = len(bk)
            ns[t] = n
            keys = np.asarray(bk, dtype=schema.key)
            values = schema.typed_values(bv)
            k_dev = put(keys, n)
            ts_dev = put(np.asarray(bt, dtype=np.float64), n)
            v_dev = _upload_values(put, values)
            part = eng._partition_keys(src, keys, values)
            if part is None:
                src_l = put(topo.keygroups_of(src, keys, values) - base_s, n)
                src_hist[t].index_add_(0, src_l, torch.ones_like(src_l))
            else:
                p_dev = k_dev if part is keys else put(part, n)
                src_l, src_hist[t] = keygroup_partition(_hashable(p_dev), nkg_s)
            l1, scan.xs_c[t] = keygroup_partition(_hashable(k_dev), nkg1)
            tab1 = tables[0]
            pr_src.index_add_(0, src_l * nkg1 + l1, torch.ones_like(l1))
            cross = table_dev[src_l + base_s] != tab1[l1]
            trash = torch.full_like(l1, g)
            for idx in (src_l + base_s, l1 + base1):
                both[t].index_add_(0, torch.where(cross, idx, trash), torch.ones_like(l1))
            order = _sorted_order(tab1[l1] * nkg1 + l1, eng.num_nodes * nkg1)
            _count_routes(metrics, fops[0])
            scan.xs_k[t, :n] = k_dev[order]
            scan.xs_t[t, :n] = ts_dev[order]
            for nm, col in zip(scan.v_names, v_dev):
                scan.xs_v[nm][t, :n] = col[order]
            if not static:
                continue
            # Walk batch t down the chain: op i's input keys (in its run
            # layout) determine its emitted keys via jit_key_map, hence the
            # hop-i routing permutation and counts.  Hops beyond K-1-t never
            # execute inside this scan (the batch is still in flight when it
            # ends), so stop there.
            kcur = scan.xs_k[t, :n]
            ccur = scan.xs_c[t]
            for i in range(min(nhops - 1, K - 1 - t) + 1):
                kout = plan.key_maps[i](kcur)
                nkg_n = plan.nkg[i + 1]
                dst, cnext = keygroup_partition(_hashable(kout), nkg_n)
                sent = eng.num_nodes * nkg_n
                oh = _sorted_order(tables[i + 1][dst] * nkg_n + dst, sent + 1)
                _count_routes(metrics, fops[i + 1])
                perm = scan.perms[i]
                src_lk = perm[jx.run_of_tuples(torch.cumsum(ccur[perm], 0), n)]
                flat = src_lk * nkg_n + dst
                pr_sum[i].index_add_(0, flat, torch.ones_like(flat))
                scan.ord_x[i][t + i, :n] = oh
                if t + i + 1 <= K - 1:
                    scan.cnt_x[i][t + i + 1] = cnext
                else:
                    # Routed at the final step: stays pending, becomes the
                    # materialized segment counts after the scan.
                    pr_last[i].index_add_(0, flat, torch.ones_like(flat))
                    pend_cnt[i] = cnext
                kcur = kout[oh]
                ccur = cnext
        staged = dict(ns=ns, src_hist=src_hist, both=both[:, :g],
                      pr_src=pr_src.view(nkg_s, nkg1))
        if static:
            shape = [(plan.nkg[i], plan.nkg[i + 1]) for i in range(nhops)]
            staged.update(pr_sum=[p.view(s) for p, s in zip(pr_sum, shape)],
                          pr_last=[p.view(s) for p, s in zip(pr_last, shape)],
                          pend_cnt=pend_cnt)
        return staged

    def _fold(self, scan: "_Scan", staged: dict, out: dict) -> None:
        """The scan's one read, folded into the engine: the reference's
        aggregate fold (superstep.py:1015-1178) over host copies."""
        eng = self.engine
        plan = self.plan
        topo = eng.topology
        metrics = eng.metrics
        jrt = self._jrt()
        K = scan.K
        src, fops = plan.source, plan.fops
        static = plan.static_route
        nhops = len(fops) - 1
        last = nhops
        g = len(eng._arrivals)
        table = eng.router.table
        nkg_s, base_s = topo.operators[src].num_keygroups, topo.kg_base(src)
        base1 = plan.base[0]
        ns = staged["ns"]
        # -- the one read: statistics, scan outputs, final pendings ---------
        reads = [scan.xs_c, staged["src_hist"], staged["both"], staged["pr_src"]]
        if static:
            reads += staged["pr_sum"] + staged["pr_last"] + staged["pend_cnt"]
        else:
            reads += out["pr_sum"] + out["pr_last"] + [out["term_cnt"]]
        pend_names = []
        for i, p in enumerate(out["pends"]):
            names = eng._op_schema[fops[i + 1]].value.names
            pend_names.append(names)
            reads += [p[0], p[2], *_columns(p[1], names)]
        term = out["term"]
        out_names = jrt._by_op[fops[last]].out_names
        if term is not None:
            reads += [term[0], term[2], *_columns(term[1], out_names)]
        metrics.jit_host_syncs += 1
        host = iter(jrt._fetch(reads))
        xs_c, src_hist, both, pr_src = (next(host) for _ in range(4))
        if static:
            pr_sum = [next(host) for _ in range(nhops)]
            pr_last = [next(host) for _ in range(nhops)]
            pend_cnt = [next(host) for _ in range(nhops)]
        else:
            pr_sum = [next(host) for _ in range(nhops)]
            pr_last = [next(host) for _ in range(nhops)]
            term_counts = next(host)
            pend_cnt = [None] * nhops
        pends = []
        for i, names in enumerate(pend_names):
            dt = eng._op_schema[fops[i + 1]].value
            keys_np, ts_np = next(host), next(host)
            pends.append((keys_np, _records([next(host) for _ in (names or (None,))], dt), ts_np))
            if not static:
                pend_cnt[i] = pr_last[i].sum(axis=0)
        if term is not None:
            ost = jrt._by_op[fops[last]]
            ok_all, ot_all = next(host), next(host)
            cols = [next(host) for _ in (out_names or (None,))]
            ov_all = _records(cols, ost.out_dtype) if out_names else cols[0]

        # -- the source hop, batch by batch (the reference's staging order) --
        arrivals_agg = np.zeros(g, dtype=np.int64)
        usage_agg = np.zeros(g, dtype=np.float64)
        src_kgs = base_s + np.arange(nkg_s)
        c_src = eng._cost_per_tuple[src]
        processed = emitted = 0
        cross_total = intra_total = 0
        for t in range(K):
            n = int(ns[t])
            _add_repeated(usage_agg, src_kgs, src_hist[t], c_src)
            processed += n
            emitted += n  # source pass-through forwards every tuple
            ncr = int(both[t].sum()) // 2
            cross_total += ncr
            intra_total += n - ncr
            if ncr:
                usage_agg += both[t] * eng.ser_cost
                eng.window.kg_usage["network"] += both[t]
            metrics.typed_batches += 1
        arrivals_agg[src_kgs] += src_hist.sum(axis=0)
        arrivals_agg[base1 : base1 + plan.nkg[0]] += xs_c.sum(axis=0)
        sl, dl = np.nonzero(pr_src)
        pair_src_l = [sl + base_s]
        pair_dst_l = [dl + base1]
        pair_cnt_l = [pr_src[sl, dl]]
        # K routed batches reach the first fused operator (typed edge).
        metrics.typed_batches += K

        # -- fold the scan outputs into the engine ---------------------------
        metrics.ticks += K
        eng._ticks_this_period += K
        metrics.jit_calls += K * len(fops)
        for i, op in enumerate(fops):
            ost = jrt._by_op[op]
            in_agg = xs_c.sum(axis=0) if i == 0 else pr_sum[i - 1].sum(axis=0)
            ost.col_auth[np.flatnonzero(in_agg)] = True
            drained = int(in_agg.sum())
            if i > 0:
                # The last tick's routed tuples stay queued, undrained.
                lastp = pr_last[i - 1].sum(axis=0)
                drained -= int(lastp.sum())
                dr = in_agg - lastp
            else:
                dr = in_agg
            idx = np.flatnonzero(dr)
            np.add.at(usage_agg, idx + plan.base[i], dr[idx] * eng._cost_per_tuple[op])
            processed += drained
            metrics.jit_tuples += drained
            if i == last:
                # A None-output sink (pure counter) emits nothing at all.
                if _emits(plan.specs[i]):
                    if static:
                        sunk = int(ns[: max(K - last, 0)].sum())
                    else:
                        sunk = int(term_counts.sum())
                    metrics.sink_tuples += sunk
                    emitted += sunk
            else:
                emitted += int(pr_sum[i].sum())
        metrics.processed_tuples += processed
        metrics.emitted_tuples += emitted
        # edge statistics (aggregate, exact integer sums)
        for i in range(last):
            pr = pr_sum[i]
            sl, dl = np.nonzero(pr)
            if len(sl):
                pair_src_l.append(sl + plan.base[i])
                pair_dst_l.append(dl + plan.base[i + 1])
                pair_cnt_l.append(pr[sl, dl])
                tl_s = table[plan.base[i] : plan.base[i] + plan.nkg[i]]
                tl_d = table[plan.base[i + 1] : plan.base[i + 1] + plan.nkg[i + 1]]
                cr = tl_s[sl] != tl_d[dl]
                cnt = pr[sl, dl]
                ncr = int(cnt[cr].sum())
                cross_total += ncr
                intra_total += int(cnt.sum()) - ncr
                if ncr:
                    both_e = np.zeros(g, dtype=np.int64)
                    np.add.at(both_e, sl[cr] + plan.base[i], cnt[cr])
                    np.add.at(both_e, dl[cr] + plan.base[i + 1], cnt[cr])
                    usage_agg += both_e * eng.ser_cost
                    eng.window.kg_usage["network"] += both_e
                np.add.at(arrivals_agg, dl + plan.base[i + 1], pr[sl, dl])
                metrics.typed_batches += K
        metrics.cross_node_tuples += cross_total
        metrics.intra_node_tuples += intra_total
        eng._arrivals += arrivals_agg
        eng._cpu_usage += usage_agg
        pair_src = np.concatenate(pair_src_l)
        dense = eng.window.record_send_counts(
            pair_src, np.concatenate(pair_dst_l), np.concatenate(pair_cnt_l)
        )
        metrics.pair_dense_entries += dense
        metrics.pair_sparse_entries += len(pair_src) - dense
        # sink outputs, tick order
        if eng.collect_sinks and term is not None:
            if static:
                # The sink at step t processes batch t-last (zero during
                # the pipeline-fill steps).
                cnts = np.zeros(K, dtype=np.int64)
                if K > last:
                    cnts[last:] = ns[: K - last]
            else:
                cnts = term_counts
            for t in range(K):
                c = int(cnts[t])
                if c:
                    metrics.sink_outputs.extend(
                        zip(ok_all[t, :c].tolist(), ov_all[t, :c].tolist(),
                            ot_all[t, :c].tolist())
                    )
        # -- materialize the final pendings as real segments ----------------
        for i in range(last):
            dop = fops[i + 1]
            counts_l = pend_cnt[i]
            if int(counts_l.sum()) == 0:
                continue
            keys_np, vals_np, ts_np = pends[i]
            perm = scan.perms_host[i + 1]
            cp = counts_l[perm]
            ends_all = np.cumsum(cp)
            starts_all = ends_all - cp
            nz = cp > 0
            kgs = perm[nz] + plan.base[i + 1]
            starts = starts_all[nz]
            ends = ends_all[nz]
            counts = cp[nz]
            tl_d = table[plan.base[i + 1] : plan.base[i + 1] + plan.nkg[i + 1]]
            run_nodes = tl_d[perm[nz]]
            costs = counts * eng._cost_per_tuple[dop]
            for node in np.unique(run_nodes):
                m = run_nodes == node
                eng._queues[int(node)].push_runs(
                    dop, keys_np, vals_np, ts_np,
                    kgs[m].tolist(), starts[m].tolist(), ends[m].tolist(),
                    costs[m].tolist(), contig=True,
                )


def _upload_values(put, values: np.ndarray) -> list:
    """A batch's values on the device, one upload: a plain column as is, a
    record array as its raw bytes, split into field columns there (in
    ``dtype.names`` order)."""
    n = len(values)
    dt = values.dtype
    if dt.names is None:
        return [put(values, n)]
    raw = put(np.ascontiguousarray(values).view(np.uint8), n * dt.itemsize).view(n, dt.itemsize)
    cols = []
    for nm in dt.names:
        fdt, off = dt.fields[nm][:2]
        cols.append(raw[:, off : off + fdt.itemsize].contiguous().view(jx.torch_dtype(fdt)).view(n))
    return cols


class _Scan:
    """One K-tick scan shape (K steps of ``nb``-row columns under one router
    table): its static inputs, the K-step loop over them, and on the card
    the loop captured into a CUDA graph.

    Static inputs, written by staging before every run: the first operator's
    staged columns and per-step run counts (``xs_*``), under
    ``static_route`` every hop's per-step counts and orders (``cnt_x``,
    ``ord_x``), and the state columns at the scan's start (``state_in``).
    The run layouts (every local key group, comp-sorted) and the table
    slices are fixed for the router version the scan was built for.
    """

    def __init__(self, rt: SuperstepRuntime, K: int, nb: int) -> None:
        eng = rt.engine
        plan = rt.plan
        jrt = rt._jrt()
        dev = jrt.device
        self.rt = rt
        self.K, self.nb = K, nb
        self.static = plan.static_route
        table = eng.router.table
        self.perms_host = [
            np.argsort(table[b : b + nk] * nk + np.arange(nk)) for b, nk in zip(plan.base, plan.nkg)
        ]
        self.perms = [jrt._put(p, len(p)) for p in self.perms_host]
        self.tables = rt._dev_tables()
        schema = eng.topology.operators[plan.source].schema

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=jx.torch_dtype(dtype), device=dev)

        self.v_names = schema.value.names or (None,)
        self.xs_k = zeros((K, nb), schema.key)
        self.xs_t = zeros((K, nb), np.float64)
        self.xs_v = {nm: zeros((K, nb), schema.value if nm is None else schema.value[nm])
                     for nm in self.v_names}
        self.xs_c = zeros((K, plan.nkg[0]), np.int64)
        nhops = len(plan.fops) - 1
        self.cnt_x = [zeros((K, plan.nkg[i + 1]), np.int64) for i in range(nhops)]
        self.ord_x = [zeros((K, nb), np.int64) for _ in range(nhops)] if self.static else []
        # Empty pendings before the first step (never written).
        self.pend0 = []
        for i in range(nhops):
            nxt = plan.specs[i].out_schema
            vcols = {nm: zeros(nb, nxt.value[nm]) for nm in nxt.value.names} \
                if nxt.value.names else zeros(nb, nxt.value)
            pend = (zeros(nb, nxt.key), vcols, zeros(nb, np.float64))
            self.pend0.append(pend if self.static else pend + (zeros(plan.nkg[i + 1], np.int64),))
        self.state_in = [
            {name: torch.empty_like(col) for name, col in jrt._by_op[op].cols.items()}
            for op in plan.fops
        ]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: The last run's outputs (on the card, the graph's static outputs).
        self.outs: Optional[dict] = None
        #: Seconds of the first run's eager warm-up and of its capture; the
        #: kernel launches the capture recorded (each replay makes them
        #: again, past the wrappers' counts), and the replays.
        self.warmup_seconds = self.capture_seconds = 0.0
        self.graph_launches: dict[str, int] = {}
        self.replays = 0

    def reset(self) -> None:
        """Clear what staging fills only in part: padding rows of the
        staged columns, identity orders and zero counts for pipeline fill."""
        for buf in (self.xs_k, self.xs_t, *self.xs_v.values(), *self.cnt_x):
            buf.zero_()
        for o in self.ord_x:
            o.copy_(torch.arange(self.nb, device=o.device).expand_as(o))

    def body(self) -> dict:
        """The K-step loop over the static inputs (no host sync inside):
        each step runs every fused operator over the previous step's
        pendings (the first over its staged columns), then routes each
        non-terminal output — by the staged orders under ``static_route``,
        else by ``keygroup_partition`` and ``radix_sort`` on the device,
        accumulating the per-edge pair matrices.  Returns the final states
        and pendings, the pair matrices' sum over the steps and the last
        step's (routing in the body), the sink's per-step counts and
        stacked outputs, and the last step's routing (``taps``: per hop the
        emitted keys, the routing codes, the local key groups and the
        order)."""
        rt = self.rt
        eng = rt.engine
        plan = rt.plan
        K, nb = self.K, self.nb
        nkgs = plan.nkg
        last = len(plan.fops) - 1
        static = self.static
        states = [dict(s) for s in self.state_in]
        pends = list(self.pend0)
        pr_sum = [] if static else [
            torch.zeros((nkgs[i], nkgs[i + 1]), dtype=torch.int64, device=self.xs_k.device)
            for i in range(last)
        ]
        pr_last = list(pr_sum)
        term_cnt, term_out, taps = [], [], []
        for t in range(K):
            new_pends = []
            for i, spec in enumerate(plan.specs):
                if i == 0:
                    keys, ts, counts = self.xs_k[t], self.xs_t[t], self.xs_c[t]
                    values = self.xs_v[None][t] if None in self.xs_v else \
                        {nm: col[t] for nm, col in self.xs_v.items()}
                elif static:
                    (keys, values, ts), counts = pends[i - 1], self.cnt_x[i - 1][t]
                else:
                    keys, values, ts, counts = pends[i - 1]
                perm = self.perms[i]
                cp = counts[perm]
                e_run = torch.cumsum(cp, 0)
                st, out, oc = spec.fn_jit(states[i], perm, e_run - cp, e_run, keys, values, ts)
                if oc is not None:
                    raise ValueError("superstep scan requires 1:1 fused operators")
                states[i] = st
                total = e_run[-1]
                if i == last:
                    term_cnt.append(total)
                    if eng.collect_sinks and out is not None:
                        term_out.append(out)
                    continue
                ok, ov, ot = out
                if static:
                    order = self.ord_x[i][t]
                else:
                    nkg_n = nkgs[i + 1]
                    valid = torch.arange(nb, device=total.device) < total
                    dst = local_keygroups(ok, nkg_n)
                    sent = eng.num_nodes * nkg_n
                    comp = torch.where(valid, self.tables[i + 1][dst] * nkg_n + dst, sent)
                    order = _sorted_order(comp, sent + 1)
                pv = {nm: col[order] for nm, col in ov.items()} if isinstance(ov, dict) \
                    else ov[order]
                pend = (ok[order], pv, ot[order])
                if static:
                    new_pends.append(pend)
                    continue
                src_l = perm[jx.run_of_tuples(e_run, nb)]
                pr = _pair_matrix(src_l, dst, valid, nkgs[i], nkg_n)
                pr_sum[i] = pr_sum[i] + pr
                if t == K - 1:
                    pr_last[i] = pr
                    taps.append((ok, comp, dst, order))
                new_pends.append(pend + (pr.sum(0),))
            pends = new_pends
        term = None
        if term_out:
            ok, ov, ot = zip(*term_out)
            tv = {nm: torch.stack([v[nm] for v in ov]) for nm in ov[0]} \
                if isinstance(ov[0], dict) else torch.stack(ov)
            term = (torch.stack(ok), tv, torch.stack(ot))
        return dict(
            states=states,
            pends=[p[:3] for p in pends],
            pr_sum=pr_sum,
            pr_last=pr_last,
            term_cnt=torch.stack(term_cnt),
            term=term,
            taps=taps,
        )

    def run(self, cols: list) -> dict:
        """The loop from state columns ``cols`` (one dict per fused
        operator) over the staged inputs.  On the card: captured at the
        first run (after an eager warm-up on the capture stream, which also
        builds every per-stream scratch the kernels keep) and replayed; a
        capture that fails raises.  On the CPU: eager."""
        for buf, col in zip(self.state_in, cols):
            for name, t in col.items():
                buf[name].copy_(t)
        if self.xs_k.device.type != "cuda":
            self.outs = self.body()
            return self.outs
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        out = dict(self.outs)
        # The graph's outputs are overwritten by its next replay.
        out["states"] = [{k: v.clone() for k, v in s.items()} for s in self.outs["states"]]
        return out

    def _capture(self) -> None:
        rt = self.rt
        if rt._stream is None:
            rt._stream = torch.cuda.Stream(self.xs_k.device)
        self.graph, self.outs, info = capture_graph(self.body, rt._stream)
        self.warmup_seconds = info["warmup_seconds"]
        self.capture_seconds = info["capture_seconds"]
        self.graph_launches = info["launches"]


def _emits(spec) -> bool:
    """Whether a fused terminal operator's ``fn_jit`` emits outputs.

    The convention in this codebase is that counting sinks return
    ``(state, None, None)``; anything with an out_schema or an emitting body
    returns tensors.  Probed once per spec by calling the body on one-row
    CPU tensors (the reference uses ``jax.eval_shape``).
    """
    cached = getattr(spec, "_superstep_emits", None)
    if cached is not None:
        return cached

    def probe():
        nkg = spec.num_keygroups
        kg = torch.zeros(1, dtype=torch.int64)
        s = torch.zeros(1, dtype=torch.int64)
        e = torch.ones(1, dtype=torch.int64)
        keys = torch.zeros(1, dtype=jx.torch_dtype(spec.schema.key))
        ts = torch.zeros(1, dtype=torch.float64)
        value = spec.schema.value
        if value.names is None:
            values = torch.zeros(1, dtype=jx.torch_dtype(value))
        else:
            values = {nm: torch.zeros(1, dtype=jx.torch_dtype(value[nm])) for nm in value.names}
        fields = spec.state_schema.fields if spec.state_schema else ()
        state = {
            f.name: torch.full((nkg + 1,), f.init, dtype=jx.torch_dtype(f.dtype)) for f in fields
        }
        _, out, _ = spec.fn_jit(state, kg, s, e, keys, values, ts)
        return out is not None

    try:
        emits = probe()
    except Exception:
        emits = True
    try:
        spec._superstep_emits = emits
    except Exception:
        pass
    return emits
