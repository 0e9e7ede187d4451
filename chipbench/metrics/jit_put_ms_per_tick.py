"""Compiled tier: milliseconds a tick in padding into pinned buffers and issuing the uploads, with the pushes of dict-held state,
``EngineMetrics.jit_put_seconds`` over ticks."""


def read(record):
    d = record["delta"]
    seconds = d.get("jit_put_seconds")
    if not d["ticks"] or not seconds:
        return None
    return 1e3 * seconds / d["ticks"]
