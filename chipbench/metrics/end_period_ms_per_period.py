"""Controller: milliseconds a controller period in ``Engine.end_period``
(the statistics' fold, the compiled tier's columns written back and every
key group's state sized), the harness's ``end_period`` spans over the
window's adapted periods."""


def read(record):
    periods = len(record.get("history") or ())
    spans = sum(e - s for n, s, e in record["spans"] if n == "end_period")
    if not periods or not spans:
        return None
    return 1e3 * spans / periods
