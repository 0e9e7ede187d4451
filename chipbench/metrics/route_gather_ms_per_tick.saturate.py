"""Routing: milliseconds a tick of the gather after the composite sort, the
program's ``EngineMetrics.gather_seconds`` (the ``route.gather`` spans'
self time) over ticks."""


def read(record):
    d = record["delta"]
    seconds = d.get("gather_seconds")
    if not d["ticks"] or not seconds:
        return None
    return 1e3 * seconds / d["ticks"]
