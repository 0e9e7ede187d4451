"""Routing: milliseconds a tick of routing's send statistics, the program's
``EngineMetrics.stats_seconds`` (the ``route.stats`` spans: the send pairs
counted, their compaction included, and the cross-node charges) over
ticks."""


def read(record):
    d = record["delta"]
    seconds = d.get("stats_seconds")
    if not d["ticks"] or not seconds:
        return None
    return 1e3 * seconds / d["ticks"]
