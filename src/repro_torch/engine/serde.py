"""Migration codecs: σ_k blobs that carry queued segments as raw buffers.

Direct state migration ships one blob per key group (paper §3, steps 3–4).
The blob is a versioned envelope of

* the pickled operator state (``KeyedStore`` owns that codec — its byte
  length is the ``kg_state_bytes`` the migration cost model consumes), and
* the key group's queued backlog — the runs ``redirect`` masked out of the
  source node's work queue — encoded per batch.

Schema-typed batches (native key/value/ts dtypes) encode as raw buffer
slices: a tiny pickled dtype header — *interned*, so every batch of the
same schema shares the exact header bytes and the pickling cost is paid
once per schema — plus ``tobytes`` of each column, decoded with
``frombuffer`` — no per-tuple python, no pickling of boxed tuples.
Object batches fall back to pickle so undeclared operators migrate through
the very same envelope.  ``decode_batch(encode_batch(b))`` is value- and
dtype-exact for both, which is what keeps the conformance harness able to
pin typed and untyped execution bit-identical across migrations.

The envelope is *versioned*: byte 4 of the header carries the layout
version as an ASCII digit (``b"RSE" + b"1"`` — so a v1 envelope is
byte-identical to the historical ``b"RSE1"`` magic and every blob ever
produced by ``serialize()`` still installs).  :func:`envelope_version`
reads the version without decoding; :func:`decode_migration` rejects
versions this build does not understand instead of misparsing them.  The
version rules are documented in ``docs/execution_tiers.md``; the public
migration API wrapping these blobs is ``Engine.export_keygroup(kg) ->
Envelope`` / ``Engine.import_keygroup(env)``, and the multi-worker runtime
(:mod:`repro_torch.engine.cluster`) ships exactly these envelopes between worker
processes.

Blobs that do not start with the ``b"RSE"`` magic prefix are treated as
bare state pickles with an empty backlog — the pre-envelope format the
failure-recovery path still emits when restoring from a checkpoint.

Port note: this is a copy of the reference's ``repro.engine.serde``, and
its envelopes are byte-identical to the reference's, in both directions.
Every unpickling goes through :func:`loads`, which resolves a class that a
reference-written blob pickled under ``repro.<module>`` to the port's copy
under ``repro_torch.<module>`` — so blobs the reference engine exported
install here unchanged (``Engine.load_reference_state``).
"""

from __future__ import annotations

import dataclasses
import io
import pickle

import numpy as np

from repro_torch.engine.topology import Batch

_MAGIC_PREFIX = b"RSE"  # repro stream envelope
ENVELOPE_VERSION = 1  # current layout version (v1 = the original layout)
MAGIC = b"RSE1"  # full v1 magic, kept for external readers

_TYPED, _PICKLED = 0, 1


class _PortUnpickler(pickle.Unpickler):
    """Maps classes pickled by the reference package onto the port's copies."""

    def find_class(self, module: str, name: str):
        if module == "repro" or module.startswith("repro."):
            module = "repro_torch" + module[len("repro") :]
        return super().find_class(module, name)


def loads(data: bytes | memoryview):
    """``pickle.loads`` that resolves ``repro.*`` classes to ``repro_torch.*``."""
    return _PortUnpickler(io.BytesIO(data)).load()


def envelope_version(blob: bytes) -> int | None:
    """Layout version of a migration blob, or None for bare state pickles."""
    if len(blob) < 4 or blob[:3] != _MAGIC_PREFIX:
        return None
    v = blob[3] - ord("0")
    if not 0 <= v <= 9:
        raise ValueError(f"malformed envelope version byte {blob[3:4]!r}")
    return v


@dataclasses.dataclass(frozen=True)
class Envelope:
    """One key group's migration payload: σ_k state + queued backlog.

    The documented unit of state transfer: ``Engine.export_keygroup`` emits
    one, ``Engine.import_keygroup`` installs one, and worker-to-worker
    migration in :mod:`repro_torch.engine.cluster` ships the ``blob`` bytes
    verbatim — so a cross-worker round trip is byte-identical to the
    single-process envelope (pinned by the conformance harness).
    """

    keygroup: int
    blob: bytes

    @property
    def version(self) -> int | None:
        return envelope_version(self.blob)

    @property
    def nbytes(self) -> int:
        return len(self.blob)


def _contig(a: np.ndarray) -> np.ndarray:
    return a if a.flags.c_contiguous else np.ascontiguousarray(a)


#: Interned typed headers: one pickled header per (key, value, ts) dtype
#: triple.  Batches sharing a schema therefore share the exact header bytes
#: (the "same schema ⇒ same bytes" contract the shm exchange lanes and the
#: conformance envelope pinning rely on), and the pickling cost is paid once
#: per schema instead of once per batch.  The batch length lives *outside*
#: the header as a fixed-width field so the header can be interned at all.
_HEADER_CACHE: dict[tuple, bytes] = {}


def typed_header(kdt: np.dtype, vdt: np.dtype, tdt: np.dtype) -> bytes:
    """The interned typed-batch header for one dtype triple."""
    key = (kdt, vdt, tdt)
    head = _HEADER_CACHE.get(key)
    if head is None:
        head = pickle.dumps((_TYPED, kdt, vdt, tdt), protocol=pickle.HIGHEST_PROTOCOL)
        _HEADER_CACHE[key] = head
    return head


def is_typed_batch(batch: Batch) -> bool:
    """True when every column is native (no object fields anywhere).

    ``dtype.hasobject`` rather than ``dtype.kind != "O"``: a *structured*
    dtype containing an object field has kind ``"V"`` but still cannot be
    encoded as raw buffers — ``tobytes``/``frombuffer`` would ship raw
    pointers.  Such batches take the pickle path.
    """
    keys, values, ts = batch
    return not (
        keys.dtype.hasobject or values.dtype.hasobject or ts.dtype.hasobject
    )


def column_views(batch: Batch) -> list[memoryview]:
    """Write-side zero-copy views of a typed batch's raw column buffers.

    The byte concatenation of these views equals the column section of
    ``encode_batch`` exactly; writers with their own framing (the shm
    exchange lanes) splice them straight into the destination buffer
    without materialising intermediate ``bytes``.
    """
    return [memoryview(_contig(col)).cast("B") for col in batch]


def batch_from_views(
    body: memoryview, kdt: np.dtype, vdt: np.dtype, tdt: np.dtype, n: int
) -> Batch:
    """Read-side zero-copy decode of the typed column layout.

    The caller owns ``body``'s lifetime and writability (the shm lanes hand
    over a freshly copied-out, writable buffer); the returned arrays alias
    it, so no defensive copy is taken.
    """
    ko, vo = n * kdt.itemsize, n * (kdt.itemsize + vdt.itemsize)
    to = vo + n * tdt.itemsize
    keys = np.frombuffer(body[:ko], dtype=kdt, count=n)
    values = np.frombuffer(body[ko:vo], dtype=vdt, count=n)
    ts = np.frombuffer(body[vo:to], dtype=tdt, count=n)
    return keys, values, ts


def encode_batch(batch: Batch) -> bytes:
    """One queued batch → bytes (raw buffers when fully native, else pickle)."""
    keys, values, ts = batch
    if is_typed_batch(batch):
        head = typed_header(keys.dtype, values.dtype, ts.dtype)
        return b"".join(
            (
                len(head).to_bytes(4, "little"),
                head,
                len(keys).to_bytes(4, "little"),
                _contig(keys).tobytes(),
                _contig(values).tobytes(),
                _contig(ts).tobytes(),
            )
        )
    head = pickle.dumps((_PICKLED, None, None, None, len(keys)))
    body = pickle.dumps((keys, values, ts), protocol=pickle.HIGHEST_PROTOCOL)
    return len(head).to_bytes(4, "little") + head + body


def decode_batch(blob: bytes | memoryview, *, copy: bool = True) -> Batch:
    """Bytes → batch.  ``copy=False`` skips the defensive copy and returns
    arrays aliasing ``blob`` — only for callers that own a writable buffer
    whose lifetime outlives the batch (the shm exchange lanes)."""
    view = memoryview(blob)
    hlen = int.from_bytes(view[:4], "little")
    header = loads(view[4 : 4 + hlen])
    if len(header) == 5:  # legacy layout: batch length inside the header
        tag, kdt, vdt, tdt, n = header
        body = view[4 + hlen :]
    else:
        tag, kdt, vdt, tdt = header
        n = int.from_bytes(view[4 + hlen : 8 + hlen], "little")
        body = view[8 + hlen :]
    if tag == _PICKLED:
        return loads(body)
    if copy:
        # One raw byte copy: frombuffer over the immutable blob would yield
        # read-only arrays, and per-column ndarray.copy() leaves structured
        # padding bytes uninitialized — a raw copy keeps the round trip
        # byte-exact and the arrays ordinarily writable.
        body = memoryview(bytearray(body))
    return batch_from_views(body, kdt, vdt, tdt, n)


def encode_migration(
    state_blob: bytes, backlog: list[Batch], *, version: int = ENVELOPE_VERSION
) -> bytes:
    """σ_k state + queued backlog → one versioned migration envelope."""
    if version != ENVELOPE_VERSION:
        raise ValueError(
            f"cannot encode envelope version {version}; this build writes "
            f"v{ENVELOPE_VERSION}"
        )
    parts = [
        _MAGIC_PREFIX + b"%d" % version,
        len(state_blob).to_bytes(8, "little"),
        state_blob,
        len(backlog).to_bytes(4, "little"),
    ]
    for b in backlog:
        eb = encode_batch(b)
        parts.append(len(eb).to_bytes(8, "little"))
        parts.append(eb)
    return b"".join(parts)


def decode_migration(blob: bytes) -> tuple[bytes, list[Batch]]:
    """Envelope → (state blob, backlog batches); bare pickles pass through.

    Raises on envelope versions this build does not understand — an
    unknown layout must fail loudly, not deserialize garbage.
    """
    version = envelope_version(blob)
    if version is None:
        return blob, []
    if version != ENVELOPE_VERSION:
        raise ValueError(
            f"unsupported migration envelope version {version} "
            f"(this build reads v{ENVELOPE_VERSION})"
        )
    view = memoryview(blob)
    off = len(MAGIC)
    slen = int.from_bytes(view[off : off + 8], "little")
    off += 8
    state_blob = bytes(view[off : off + slen])
    off += slen
    count = int.from_bytes(view[off : off + 4], "little")
    off += 4
    backlog: list[Batch] = []
    for _ in range(count):
        blen = int.from_bytes(view[off : off + 8], "little")
        off += 8
        backlog.append(decode_batch(view[off : off + blen]))
        off += blen
    return state_blob, backlog
