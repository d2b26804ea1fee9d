"""publish_ms (ms): device time a query of the operations launched inside
``D4MStream.view`` (the snapshot)."""
from d4m_bench.readers import range_ms


def read(rec):
    return range_ms(rec, "view")
