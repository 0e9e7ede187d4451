"""Allocators: the assignment binaries of a MILP solve, over every solve of
the window's adapted periods, ALBIC's back-offs among them
(``PeriodMetrics.milp_binaries`` over ``milp_solves``): the dense count
(units x live nodes) below the program's scale threshold, the movable
units' above it.  A program without the counter, or a window without a
solve, gives nothing."""


def read(record):
    history = record.get("history")
    if not history or "milp_binaries" not in history[0]:
        return None
    solves = sum(p["milp_solves"] for p in history)
    if not solves:
        return None
    return sum(p["milp_binaries"] for p in history) / solves
