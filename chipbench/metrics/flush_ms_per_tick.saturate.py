"""Engine tick (host): milliseconds a tick of the output flush outside the
routing it dispatches (placeholder cells expanded, batches conformed and
concatenated, sources attributed), ``EngineMetrics.flush_seconds`` over
ticks."""


def read(record):
    d = record["delta"]
    seconds = d.get("flush_seconds")
    if not d["ticks"] or not seconds:
        return None
    return 1e3 * seconds / d["ticks"]
