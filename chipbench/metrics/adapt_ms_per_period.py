"""Allocators: milliseconds a controller period in ``AdaptationFramework.
adapt`` (Algorithm 1: the scaling decision and ALBIC's scoring, partitions
and time-limited MILP solves with their back-offs), the harness's ``adapt``
spans over the window's adapted periods."""


def read(record):
    periods = len(record.get("history") or ())
    spans = sum(e - s for n, s, e in record["spans"] if n == "adapt")
    if not periods or not spans:
        return None
    return 1e3 * spans / periods
