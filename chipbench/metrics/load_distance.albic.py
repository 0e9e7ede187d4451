"""Allocators: the load distance ALBIC left, in % of a node: the largest gap
of a live node's load from the mean under the adapted allocation
(``PeriodMetrics.load_distance``), the mean over the window's adapted
periods.  A controller that got faster by balancing worse shows here."""


def read(record):
    history = record.get("history")
    if not history:
        return None
    return sum(p["load_distance"] for p in history) / len(history)
