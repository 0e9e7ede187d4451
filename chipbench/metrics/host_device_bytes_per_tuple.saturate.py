"""Routing: bytes routing copied between host and device per admitted
source tuple (``EngineMetrics.host_device_bytes``), a count."""


def read(record):
    nbytes = record["delta"]["host_device_bytes"]
    if not record["admitted"] or not nbytes:
        return None
    return nbytes / record["admitted"]
