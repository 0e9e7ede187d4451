"""Allocators: milliseconds a controller period in MILP solves, every
call of the program's ``solve_allocation`` (ALBIC's back-offs among them),
the harness's ``solve`` spans over the window's adapted periods."""


def read(record):
    periods = len(record.get("history") or ())
    spans = sum(e - s for n, s, e in record["spans"] if n == "solve")
    if not periods or not spans:
        return None
    return 1e3 * spans / periods
