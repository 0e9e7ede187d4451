"""Routing: milliseconds a tick of routing on the host, the program's
``EngineMetrics.route_seconds`` summed over destination operators, less
its device round trips (``device_route_seconds``)."""


def read(record):
    d = record["delta"]
    per_op = record.get("route_seconds")
    if not d["ticks"] or not per_op or not sum(per_op.values()):
        return None
    return 1e3 * (sum(per_op.values()) - d["device_route_seconds"]) / d["ticks"]
