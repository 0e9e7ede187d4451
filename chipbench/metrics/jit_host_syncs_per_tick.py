"""Compiled tier: host synchronizations a tick (``EngineMetrics.
jit_host_syncs``, one per batched call), a count."""


def read(record):
    d = record["delta"]
    if not d["ticks"] or not d["jit_calls"]:
        return None
    return d["jit_host_syncs"] / d["ticks"]
