"""route_ms (ms): device time a group of the operations launched inside
``D4MStream.route`` (hash routing to the instances)."""
from d4m_bench.readers import range_ms


def read(rec):
    return range_ms(rec, "route")
