"""Compiled tier: milliseconds a tick of the tier's flush outside its puts,
calls and fetches (segments grouped and concatenated, outputs split back
into their cells, emission counted): ``EngineMetrics.jit_seconds`` less
``jit_put_seconds``, ``jit_call_seconds`` and ``jit_fetch_seconds``, over
ticks."""


def read(record):
    d = record["delta"]
    seconds = d.get("jit_seconds")
    if not d["ticks"] or not seconds:
        return None
    parts = d["jit_put_seconds"] + d["jit_call_seconds"] + d["jit_fetch_seconds"]
    return 1e3 * (seconds - parts) / d["ticks"]
