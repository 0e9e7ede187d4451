"""Routing kernels: keygroup_partition's share of its roofline, in %.

The least time the batches it partitioned need at HBM bandwidth (each key
read once, each id written once, a histogram a batch: ``stats.
partition_bytes``, counted from the tuples routed to each operator whose
batches took the kernel) over the kernel's device time in the trace."""

from chipbench import stats


def read(record):
    if not record["device"]:
        return None
    seconds = sum(e - s for n, s, e in record["device"] if "keygroup_partition" in n)
    nbytes = 0
    for op, batches in record["partition_kernel_batches"].items():
        routed = record["routed_batches"][op]
        if batches and routed:
            tuples = record["op_tuples"][op] * batches // routed
            nbytes += stats.partition_bytes(tuples, batches, record["nkg"][op])
    return stats.roofline_percent(nbytes, seconds)
