"""read_p95_ms: the 95th percentile of the latency of all reads in the
window, host clock, in ms (``statistics.quantiles``, inclusive method)."""

import statistics


def read(run):
    if run.side != "decompress" or len(run.requests) < 2:
        return None
    lat = [r.seconds * 1e3 for r in run.requests]
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
