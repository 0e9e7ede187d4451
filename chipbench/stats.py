"""The benchmark's frozen arithmetic: the device's busy time and idle gaps,
and the routing kernels' byte counts and roofline."""

from __future__ import annotations

import numpy as np

#: HBM bandwidth of one H100 SXM (NVIDIA's data sheet), bytes a second.
HBM_BYTES_PER_S = 3.35e12

#: Byte sizes of the routing contract: keys and key-group ids int64, the
#: arrival histogram int64 a key group, the order int64; composite codes
#: int16 where nodes x key groups fit 32,767, else int32.
KEY_BYTES = ID_BYTES = HIST_BYTES = ORDER_BYTES = 8
INT16_MAX_BUCKETS = 32767


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted ``(start, end)`` intervals."""
    out: list[list[float]] = []
    for s, e in sorted((float(s), float(e)) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, t = [], lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def partition_bytes(tuples: int, batches: int, nkg: int) -> int:
    """keygroup_partition: each key read once, each id written once, one
    histogram of ``nkg`` counts written a batch."""
    return tuples * (KEY_BYTES + ID_BYTES) + batches * nkg * HIST_BYTES


def sort_bytes(tuples: int, buckets: int) -> int:
    """radix_sort: each composite code read once, each order entry written
    once."""
    code = 2 if buckets <= INT16_MAX_BUCKETS else 4
    return tuples * (code + ORDER_BYTES)


def roofline_percent(nbytes: int, device_seconds: float) -> float | None:
    """The least time ``nbytes`` take at HBM bandwidth, as a share of the
    measured device time; None where nothing was measured."""
    if nbytes <= 0 or device_seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_seconds

