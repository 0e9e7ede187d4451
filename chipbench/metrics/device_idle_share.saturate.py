"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card, in %: 100 x (1 - the union of their intervals over
the window)."""

from chipbench import stats


def read(record):
    if not record["device"]:
        return None
    lo, hi = record["window"]
    busy = stats.busy_seconds([(s, e) for _, s, e in record["device"]], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
