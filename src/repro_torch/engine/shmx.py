"""Shared-memory exchange lanes: SPSC byte rings of typed segments.

The multi-worker runtime's steady-state cost on small hosts is the exchange
step — the queue transport ships every cross-worker tick contribution as a pickled
``mp.Queue`` message (pipe write + pickle + pipe read + unpickle + copy).
This module replaces that hot path with one ``multiprocessing.shared_memory``
ring buffer per ``(sender → receiver)`` lane:

* **Single-writer, single-reader.**  Each ring has exactly one producer (the
  sending worker) and one consumer (the receiving worker), continuing the
  transport discipline that makes SIGKILL safe: two monotonically increasing
  64-bit sequence counters live in the segment header — ``write_seq``
  (written only by the producer) and ``read_seq`` (written only by the
  consumer) — and a record becomes visible *only* when the producer advances
  ``write_seq`` past it.  A worker SIGKILLed mid-write leaves an unpublished
  partial record that no reader will ever observe, and no lock any survivor
  needs.  (CPython stores each counter with a single aligned 8-byte write;
  on x86's total-store-order this publishes the record bytes before the
  sequence bump.  The engine targets the same POSIX/x86 class of host the
  ``fork`` requirement already pins.)

* **Coordinator-allocated, fork-inherited, coordinator-unlinked.**  The
  coordinator creates every segment before forking the pool, workers inherit
  the mappings, and only the coordinator ever calls ``unlink`` — on
  shutdown and on worker death — so a killed worker cannot leak a segment.
  Unlinking removes the *name* only; survivors' inherited mappings stay
  valid, which is what lets a peer drain a dead sender's ring during the
  final sweep.

* **Typed segments, not pickles.**  Records carry ``serde.encode_batch``'s
  raw column layout (see :class:`LaneSender`): the producer splices each
  column's buffer straight into the ring (one memcpy per column — the
  transfer itself, no intermediate ``bytes``), the consumer copies the
  record out once and decodes with ``frombuffer`` over its own writable
  buffer (``serde.batch_from_views`` — no defensive copy).  Dtype headers
  are interned per lane: the first batch of a schema ships a define record,
  every later batch ships a 4-byte id.

Ring-full overflow, object-dtype batches, and migration envelopes keep the
pickled-queue path — :meth:`LaneSender.try_send` returns ``False`` and the
caller falls back, at whole-message granularity so a (sender, tick)
contribution travels on exactly one transport and per-tick merge order is
unaffected.  The protocol and its determinism contract are documented in
``docs/execution_tiers.md``.

A copy of ``repro.engine.shmx``; only :data:`SEGMENT_PREFIX` differs.
"""

from __future__ import annotations

import pickle
import struct
from multiprocessing import shared_memory as _shared_memory

import numpy as np

from repro_torch.engine import serde

_pack_preamble = struct.Struct("<QI").pack  # tick, nitems
_pack_item = struct.Struct("<IBI").pack  # dop, flags, hdr_id
_unpack_preamble = struct.Struct("<QI").unpack_from
_unpack_item = struct.Struct("<IBI").unpack_from
_pack_u32 = struct.Struct("<I").pack
_unpack_u32 = struct.Struct("<I").unpack_from

#: Segment header: write_seq (u64, producer-owned), read_seq (u64,
#: consumer-owned), capacity (u64, fixed at creation — ``SharedMemory``
#: rounds sizes up to a page, so the logical capacity travels in-band).
_HEADER_BYTES = 24

#: Prefix of every exchange-lane segment name.  The port's own: the
#: reference's fault suites scan ``/dev/shm`` for theirs (``repro_xchg``)
#: to prove their coordinator leaked nothing, and must never see a port
#: pool's lanes when both suites run side by side.
SEGMENT_PREFIX = "repro_torch_xchg"

#: ``hdr_id`` flag bit: a define record (pickled dtype triple) follows.
_DEFINE = 0x80000000

#: Per-item flag: src_kgs / src_nodes arrays present.
_HAS_SRC = 0x01


class ShmRing:
    """One SPSC byte ring over one shared-memory segment.

    Records are ``[u32 length][payload]``, written wrap-around; sequence
    counters count bytes monotonically (position = seq % capacity), so
    ``write_seq - read_seq`` is the bytes in flight and full/empty are
    unambiguous without a spare slot.
    """

    def __init__(self, shm: _shared_memory.SharedMemory):
        self.shm = shm
        self._seq = np.frombuffer(shm.buf, dtype=np.uint64, count=3)
        self.capacity = int(self._seq[2])
        # Raw 'B'-format view of the data region: record bytes move through
        # plain memoryview slice assignment (one memcpy per part, no numpy
        # per-part overhead on the hot path).
        self._data = memoryview(shm.buf)[
            _HEADER_BYTES : _HEADER_BYTES + self.capacity
        ]

    @classmethod
    def create(cls, name: str, capacity: int) -> "ShmRing":
        shm = _shared_memory.SharedMemory(
            name=name, create=True, size=_HEADER_BYTES + capacity
        )
        ctrl = np.frombuffer(shm.buf, dtype=np.uint64, count=3)
        ctrl[:] = (0, 0, capacity)
        del ctrl
        return cls(shm)

    @classmethod
    def open(cls, name: str) -> "ShmRing":
        """Attach to an existing segment by name (respawn path).

        Fork inheritance covers the initial pool, but a worker that outlives
        a peer's respawn must map the *replacement* lanes, which were
        created after its own fork.  Ownership is unchanged: the coordinator
        created the segment and remains the only unlinker.  The attach-time
        resource-tracker registration (Python < 3.13 has no ``track``
        parameter) is harmless here: fork-children share the coordinator's
        tracker, whose cache is a set — the duplicate register is a no-op
        and the coordinator's eventual unlink clears the single entry.
        Explicitly unregistering instead would strip the creator's entry
        and make that unlink double-unregister.
        """
        return cls(_shared_memory.SharedMemory(name=name, create=False))

    # ------------------------------------------------------------- producer
    def try_send(self, parts: list) -> int | None:
        """Publish one record made of buffer parts → payload bytes written,
        or ``None`` when the ring lacks space.

        ``parts`` are bytes-like (``bytes`` or C-contiguous memoryviews);
        each is memcpy'd straight into the mapping — the only write-side
        copy is the transfer itself.
        """
        total = sum(map(len, parts))
        wseq = int(self._seq[0])
        used = wseq - int(self._seq[1])
        if 4 + total > self.capacity - used:
            return None
        # Inline wrap-aware copy loop: a record averages dozens of parts,
        # so per-part function-call overhead is measurable on the hot path.
        data = self._data
        cap = self.capacity
        off = wseq % cap
        for buf in (_pack_u32(total), *parts):
            mv = buf if type(buf) is memoryview else memoryview(buf)
            n = mv.nbytes
            end = off + n
            if end <= cap:
                data[off:end] = mv
                off = 0 if end == cap else end
            else:
                first = cap - off
                data[off:] = mv[:first]
                off = n - first
                data[:off] = mv[first:]
        self._seq[0] = np.uint64(wseq + 4 + total)  # publish
        return total

    # ------------------------------------------------------------- consumer
    def recv(self) -> memoryview | None:
        """Pop one record, or ``None`` when the ring is empty.

        Returns a memoryview over a *fresh writable* buffer (one memcpy out
        of the mapping), so zero-copy decodes of it yield ordinary writable
        arrays with an independent lifetime.
        """
        rseq = int(self._seq[1])
        if int(self._seq[0]) == rseq:
            return None
        off = rseq % self.capacity
        if off + 4 <= self.capacity:  # allocation-free length read
            (n,) = _unpack_u32(self._data, off)
        else:
            (n,) = _unpack_u32(self._read(rseq, 4), 0)
        payload = self._read(rseq + 4, n)
        self._seq[1] = np.uint64(rseq + 4 + n)  # release the bytes
        return payload

    def _read(self, seq: int, n: int) -> memoryview:
        out = np.empty(n, dtype=np.uint8).data
        off = seq % self.capacity
        first = min(n, self.capacity - off)
        out[:first] = self._data[off : off + first]
        if first < n:
            out[first:] = self._data[: n - first]
        return out

    # -------------------------------------------------------------- cleanup
    def close(self) -> None:
        """Drop this process's mapping (views first — mmap refuses while
        buffer exports exist).  Idempotent."""
        self._seq = None
        self._data = None
        try:
            self.shm.close()
        except BufferError:  # pragma: no cover - exported view still alive
            pass

    def unlink(self) -> None:
        """Remove the segment name (coordinator-only).  Idempotent — death
        cleanup and shutdown may both reach the same segment."""
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


class LaneSender:
    """Producer-side codec for one exchange lane.

    One record per ``(tick, receiver)``: a meta block, then the buffers.
    The meta block is ``[tick u64][nitems u32]`` followed per item by
    ``[dop u32][flags u8][hdr_id u32]`` (+ ``[len u32][pickled dtype
    triple]`` when the ``_DEFINE`` bit is set — the first batch of a schema
    on this lane) and ``[n u32]``.  After the last meta come each item's
    raw key/value/ts column buffers in item order (``serde.column_views`` —
    byte-identical to ``encode_batch``'s column section) and, when flagged,
    the int64 ``src_kgs``/``src_nodes`` buffers.  Grouping the metas into
    one block keeps the splice count at one small write plus the column
    buffers themselves.

    Define records ride the ring only, so the receiver's intern table stays
    in sync by FIFO order alone; the queue fallback ships self-describing
    pickles and never consumes an id.
    """

    def __init__(self, ring: ShmRing):
        self.ring = ring
        self._hdr_ids: dict[tuple, int] = {}
        self.sent_msgs = 0
        self.bytes_copied = 0

    def try_send(self, tick: int, items: list) -> bool:
        """Encode and publish one tick's items, or refuse (fallback).

        Refuses when any batch has object-dtype columns (raw buffers would
        ship pointers) or the ring lacks space for the whole record —
        whole-message granularity, so one (tick, lane) contribution never
        splits across transports.
        """
        metas: list = [_pack_preamble(tick, len(items))]
        parts: list = [b""]  # placeholder: joined meta block goes first
        fresh: dict[tuple, int] = {}
        for dop, batch, sk, sn in items:
            if not serde.is_typed_batch(batch):
                return False
            keys, values, ts = batch
            triple = (keys.dtype, values.dtype, ts.dtype)
            hid = self._hdr_ids.get(triple, fresh.get(triple))
            define = b""
            if hid is None:
                hid = len(self._hdr_ids) + len(fresh)
                fresh[triple] = hid
                blob = pickle.dumps(triple, protocol=pickle.HIGHEST_PROTOCOL)
                define = _pack_u32(len(blob)) + blob
                hid |= _DEFINE
            flags = _HAS_SRC if sk is not None else 0
            metas.append(_pack_item(dop, flags, hid) + define + _pack_u32(len(keys)))
            parts.extend(serde.column_views(batch))
            if flags & _HAS_SRC:
                parts.append(
                    memoryview(np.ascontiguousarray(sk, dtype=np.int64)).cast("B")
                )
                parts.append(
                    memoryview(np.ascontiguousarray(sn, dtype=np.int64)).cast("B")
                )
        parts[0] = metas[0] if len(metas) == 1 else b"".join(metas)
        sent = self.ring.try_send(parts)
        if sent is None:
            return False  # defines not committed: retried next ring message
        self._hdr_ids.update(fresh)
        self.sent_msgs += 1
        self.bytes_copied += sent
        return True


class LaneReceiver:
    """Consumer-side codec for one exchange lane (see :class:`LaneSender`)."""

    def __init__(self, ring: ShmRing):
        self.ring = ring
        self._hdrs: dict[int, tuple] = {}
        self.recv_msgs = 0
        self.bytes_copied = 0

    def poll(self) -> tuple[int, list] | None:
        """Pop and decode one record → ``(tick, items)``, or ``None``."""
        view = self.ring.recv()
        if view is None:
            return None
        self.recv_msgs += 1
        self.bytes_copied += len(view)
        tick, nitems = _unpack_preamble(view, 0)
        off = 12
        metas = []
        for _ in range(nitems):
            dop, flags, hid = _unpack_item(view, off)
            off += 9
            if hid & _DEFINE:
                (plen,) = _unpack_u32(view, off)
                off += 4
                self._hdrs[hid & ~_DEFINE] = pickle.loads(view[off : off + plen])
                off += plen
                hid &= ~_DEFINE
            (n,) = _unpack_u32(view, off)
            off += 4
            metas.append((dop, flags, self._hdrs[hid], n))
        items = []
        for dop, flags, (kdt, vdt, tdt), n in metas:
            nbytes = n * (kdt.itemsize + vdt.itemsize + tdt.itemsize)
            batch = serde.batch_from_views(
                view[off : off + nbytes], kdt, vdt, tdt, n
            )
            off += nbytes
            sk = sn = None
            if flags & _HAS_SRC:
                sk = np.frombuffer(view[off : off + 8 * n], dtype=np.int64)
                off += 8 * n
                sn = np.frombuffer(view[off : off + 8 * n], dtype=np.int64)
                off += 8 * n
            items.append((dop, batch, sk, sn))
        return tick, items
