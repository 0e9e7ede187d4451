"""Allocators: milliseconds a controller period spent building MILPs before
HiGHS starts, every solve's (ALBIC's back-offs among them) rows and the
solver's sparse matrix (``PeriodMetrics.milp_build_seconds``), the mean
over the window's adapted periods.  A program without the counter, or a
window without a solve, gives nothing."""


def read(record):
    history = record.get("history")
    if not history or "milp_build_seconds" not in history[0]:
        return None
    if not sum(p["milp_solves"] for p in history):
        return None
    return 1e3 * sum(p["milp_build_seconds"] for p in history) / len(history)
