"""Routing: milliseconds a tick of routing's device round trips (upload,
kernels, download), ``EngineMetrics.device_route_seconds`` over ticks."""


def read(record):
    d = record["delta"]
    if not d["ticks"] or not d["device_route_seconds"]:
        return None
    return 1e3 * d["device_route_seconds"] / d["ticks"]
