"""Routing kernels: radix_sort's share of its roofline, in %.

The least time the composite codes it sorted need at HBM bandwidth (each
code read once, each order entry written once: ``stats.sort_bytes``,
counted from the tuples routed to each operator whose batches took the
kernel) over the device time of its histogram and pass kernels."""

from chipbench import stats


def read(record):
    if not record["device"]:
        return None
    seconds = sum(e - s for n, s, e in record["device"] if "radix_" in n)
    nbytes = 0
    for op, batches in record["sort_kernel_batches"].items():
        routed = record["routed_batches"][op]
        if batches and routed:
            tuples = record["op_tuples"][op] * batches // routed
            nbytes += stats.sort_bytes(tuples, record["nodes"] * record["nkg"][op])
    return stats.roofline_percent(nbytes, seconds)
