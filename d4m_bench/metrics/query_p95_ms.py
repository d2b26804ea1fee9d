"""query_p95_ms (ms): the 95th percentile of every query of the window,
each timed on the host from its issue to its answer on the host, taken from
the raw samples (the nearest-rank percentile)."""
import math


def p95(samples):
    if not samples:
        return None
    xs = sorted(samples)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def read(rec):
    v = p95(rec.latencies_s)
    return None if v is None else v * 1e3
