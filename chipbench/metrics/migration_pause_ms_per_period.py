"""Controller: milliseconds a controller period that migrated key groups
were paused, serialize to install (``PeriodMetrics.migration_pause_s``), the
mean over the window's adapted periods."""


def read(record):
    history = record.get("history")
    if not history:
        return None
    return 1e3 * sum(p["migration_pause_s"] for p in history) / len(history)
