"""Engine tick (host): milliseconds a tick of the host's own work, the
harness's spans around ``push_source`` and ``tick`` less the device round
trips routing timed (``EngineMetrics.device_route_seconds``)."""


def read(record):
    ticks = record["delta"]["ticks"]
    spans = sum(e - s for n, s, e in record["spans"] if n in ("push_source", "tick"))
    if not ticks or not spans:
        return None
    return 1e3 * (spans - record["delta"]["device_route_seconds"]) / ticks
