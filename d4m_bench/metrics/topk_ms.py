"""topk_ms (ms): device time a query of the operations launched inside
``StreamView.top_k`` (the degrees and their sort) and the answer's copy to
the host."""
from d4m_bench.readers import range_ms


def read(rec):
    return range_ms(rec, "top_k")
