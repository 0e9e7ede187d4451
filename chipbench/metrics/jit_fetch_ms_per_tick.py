"""Compiled tier: milliseconds a tick in the one synchronization a call and its reads,
``EngineMetrics.jit_fetch_seconds`` over ticks."""


def read(record):
    d = record["delta"]
    seconds = d.get("jit_fetch_seconds")
    if not d["ticks"] or not seconds:
        return None
    return 1e3 * seconds / d["ticks"]
