"""Operator bodies (host): milliseconds a tick in the operators' host
bodies (``fn_seg`` calls and per-run ``fn`` loops), the program's
``EngineMetrics.op_seconds`` summed over operators, over ticks."""


def read(record):
    d = record["delta"]
    per_op = record.get("op_seconds")
    if not d["ticks"] or not per_op or not sum(per_op.values()):
        return None
    return 1e3 * sum(per_op.values()) / d["ticks"]
