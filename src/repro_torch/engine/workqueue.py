"""Per-node work queues: the structure-of-arrays data plane (and its oracle).

A node's queue holds *runs* — contiguous (operator, key group) slices of a
routed batch — in FIFO order.  Two implementations share one interface:

:class:`SoAWorkQueue`
    The production layout.  A push appends one *segment*: a reference to the
    routed batch's key/value/ts arrays (shared, never copied — every node's
    runs are views into the same argsort-permuted arrays) plus parallel
    plain-Python run-index lists ``(kgs, starts, ends, costs)``.  Draining
    walks the run lists with a cursor instead of popping per-(op, key group)
    Python queue entries, so per-run overhead is a couple of list indexings
    and three array slices.

:class:`DequeWorkQueue`
    A straightforward deque of per-run ``[op, kg, batch, cost]`` entries in
    push order, kept as the equivalence oracle — it drains exactly the runs
    the SoA queue drains, one pop at a time.  The routing-equivalence tests
    run both implementations on identical inputs and require bit-identical
    tuple flow and SPL statistics under any service budget.

Both support ``extract_keygroup`` — masked slicing of one key group's queued
tuples out of the queue in FIFO order — which the engine uses during direct
state migration so in-flight work follows σ_k to its new node (packed into
the serialize envelope as raw buffer slices on schema-typed edges).

Queues are representation-agnostic: a segment's key/value arrays are
whatever the routed batch carried — native structured records on
schema-typed edges (slicing stays a fixed-width view, no per-element
refcounting) or object arrays on undeclared ones.

The fused superstep runtime (:mod:`repro_torch.engine.superstep`) additionally
pushes *shadow segments*: run metadata (kgs/starts/ends/costs, with bounds
absolute into the routed arrays) whose key/value/ts slots are ``None``
because the routed tuples stayed resident on the device.  Shadow segments
carry exact cost accounting — backpressure, budgets and queue-cost
trajectories are bit-identical to real segments — but cannot be sliced;
every engine path that touches segment arrays (``extract_keygroup``,
``clear`` on migration/failure, any classic drain) runs only after
``SuperstepRuntime.flush_to_host()`` fills the ``None`` slots in place.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.engine.topology import Batch

# Segment layout (plain list for speed): shared tuple arrays + run indices.
# `contig` is True when the runs are adjacent slices (starts[i+1] == ends[i])
# — the engine's segment-vectorized paths require it.
(
    _S_KEYS,
    _S_VALUES,
    _S_TS,
    _S_OP,
    _S_KGS,
    _S_STARTS,
    _S_ENDS,
    _S_COSTS,
    _S_CUR,
    _S_CONTIG,
) = range(10)


class SoAWorkQueue:
    """Structure-of-arrays FIFO of (op, key group) runs for one node."""

    __slots__ = ("_segs", "cost")

    def __init__(self) -> None:
        self._segs: deque[list] = deque()
        self.cost = 0.0  # queued work in cost-units (backpressure input)

    def __bool__(self) -> bool:
        return bool(self._segs)

    def __len__(self) -> int:  # pending runs (diagnostics/tests)
        return sum(len(s[_S_KGS]) - s[_S_CUR] for s in self._segs)

    def push_runs(
        self,
        op: int,
        keys: np.ndarray,
        values: np.ndarray,
        ts: np.ndarray,
        kgs: list[int],
        starts: list[int],
        ends: list[int],
        costs: list[float],
        contig: bool = False,
    ) -> float:
        """Append one segment of runs; arrays are shared, not copied.

        Returns the total cost admitted (also added to ``self.cost``) —
        summed left to right so both queue implementations account
        bit-identically.  ``contig`` asserts the runs are adjacent slices.
        """
        total = 0.0
        for c in costs:
            total += c
        self._segs.append([keys, values, ts, op, kgs, starts, ends, costs, 0, contig])
        self.cost += total
        return total

    def push_batch(self, op: int, kg: int, batch: Batch, cost: float) -> None:
        """Append a single-run segment (migration replay path)."""
        k, v, t = batch
        self._segs.append([k, v, t, op, [kg], [0], [len(k)], [cost], 0, True])
        self.cost += cost

    def drain(
        self, budget: float, process, node: int, out_kgs: list, out_costs: list
    ) -> None:
        """Consume runs in FIFO order until the budget is exhausted.

        ``process(node, op, kg, keys, values, ts)`` is called per run; the
        consumed (kg, cost) pairs are appended to ``out_kgs``/``out_costs``
        so the caller can charge CPU statistics in one vectorized scatter.
        Matches the deque semantics: the run that exhausts the budget is
        still processed (one-entry overshoot).
        """
        segs = self._segs
        while segs and budget > 0:
            seg = segs[0]
            keys, values, ts, op = seg[_S_KEYS], seg[_S_VALUES], seg[_S_TS], seg[_S_OP]
            kgs, starts, ends, costs = (
                seg[_S_KGS],
                seg[_S_STARTS],
                seg[_S_ENDS],
                seg[_S_COSTS],
            )
            cur, nruns = seg[_S_CUR], len(kgs)
            while cur < nruns:
                c = costs[cur]
                kg = kgs[cur]
                a, z = starts[cur], ends[cur]
                cur += 1
                budget -= c
                self.cost -= c
                out_kgs.append(kg)
                out_costs.append(c)
                process(node, op, kg, keys[a:z], values[a:z], ts[a:z])
                if budget <= 0:
                    break
            if cur < nruns:
                seg[_S_CUR] = cur
                return
            segs.popleft()

    def extract_keygroup(self, kg: int) -> tuple[list[Batch], float]:
        """Masked slicing: remove and return one key group's queued batches.

        FIFO order is preserved; the removed cost is subtracted from
        ``self.cost`` and returned alongside the batches.
        """
        out: list[Batch] = []
        removed = 0.0
        kept_segs: deque[list] = deque()
        for seg in self._segs:
            kgs = seg[_S_KGS]
            cur = seg[_S_CUR]
            if kg not in kgs[cur:]:
                kept_segs.append(seg)
                continue
            keys, values, ts = seg[_S_KEYS], seg[_S_VALUES], seg[_S_TS]
            starts, ends, costs = seg[_S_STARTS], seg[_S_ENDS], seg[_S_COSTS]
            nk, ns, ne, nc = [], [], [], []
            for j in range(cur, len(kgs)):
                a, z = starts[j], ends[j]
                if kgs[j] == kg:
                    out.append((keys[a:z], values[a:z], ts[a:z]))
                    removed += costs[j]
                else:
                    nk.append(kgs[j])
                    ns.append(a)
                    ne.append(z)
                    nc.append(costs[j])
            if nk:
                # Removal may break run adjacency: conservatively mark the
                # rebuilt segment non-contiguous (per-run drain handles it).
                kept_segs.append(
                    [keys, values, ts, seg[_S_OP], nk, ns, ne, nc, 0, False]
                )
        self._segs = kept_segs
        self.cost -= removed
        return out, removed

    def clear(self) -> None:
        self._segs.clear()
        self.cost = 0.0


# Deque entry layout: [op, kg, Batch, cost] — one entry per pushed run, in
# push order, exactly the granularity the SoA queue drains at (same-tick
# same-(op, kg) pushes stay separate entries on both implementations, so the
# two drain identical runs under any service budget).
_QE_OP, _QE_KG, _QE_BATCH, _QE_COST = range(4)


class DequeWorkQueue:
    """Per-run deque queue — the equivalence oracle for SoAWorkQueue."""

    __slots__ = ("_q", "cost")

    def __init__(self) -> None:
        self._q: deque[list] = deque()
        self.cost = 0.0

    def __bool__(self) -> bool:
        return bool(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def push_runs(
        self, op, keys, values, ts, kgs, starts, ends, costs, contig=False
    ) -> float:
        total = 0.0
        for j in range(len(kgs)):
            a, z = starts[j], ends[j]
            self._q.append([op, kgs[j], (keys[a:z], values[a:z], ts[a:z]), costs[j]])
            total += costs[j]
        self.cost += total
        return total

    def push_batch(self, op, kg, batch, cost) -> None:
        self._q.append([op, kg, batch, cost])
        self.cost += cost

    def drain(self, budget, process, node, out_kgs, out_costs) -> None:
        q = self._q
        while q and budget > 0:
            op, kg, batch, cost = q.popleft()
            self.cost -= cost
            budget -= cost
            out_kgs.append(kg)
            out_costs.append(cost)
            process(node, op, kg, batch[0], batch[1], batch[2])

    def extract_keygroup(self, kg: int) -> tuple[list[Batch], float]:
        out: list[Batch] = []
        removed = 0.0
        kept: deque[list] = deque()
        for entry in self._q:
            if entry[_QE_KG] == kg:
                out.append(entry[_QE_BATCH])
                removed += entry[_QE_COST]
            else:
                kept.append(entry)
        self._q = kept
        self.cost -= removed
        return out, removed

    def clear(self) -> None:
        self._q.clear()
        self.cost = 0.0


QUEUE_IMPLS = {"soa": SoAWorkQueue, "deque": DequeWorkQueue}
