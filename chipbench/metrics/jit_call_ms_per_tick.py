"""Compiled tier: milliseconds a tick in the fn_jit bodies' calls,
``EngineMetrics.jit_call_seconds`` over ticks."""


def read(record):
    d = record["delta"]
    seconds = d.get("jit_call_seconds")
    if not d["ticks"] or not seconds:
        return None
    return 1e3 * seconds / d["ticks"]
