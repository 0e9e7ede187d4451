"""Admission: milliseconds a tick of ``push_source`` outside its routing
(the credit gate, the schema conversion and the copies), the program's
``EngineMetrics.admit_seconds`` over ticks."""


def read(record):
    d = record["delta"]
    seconds = d.get("admit_seconds")
    if not d["ticks"] or not seconds:
        return None
    return 1e3 * seconds / d["ticks"]
