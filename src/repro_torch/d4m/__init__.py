"""``repro_torch.d4m``: the D4M session API of the port.

Quick start::

    from repro_torch import d4m

    cfg = d4m.StreamConfig(cuts=(1024, 8192), top_capacity=200_000,
                           batch_size=512, instances_per_device=8)
    sess = d4m.D4MStream(cfg)              # on the card; device="cpu" for tests
    for rows, cols, vals in edge_groups:
        sess.ingest(rows, cols, vals)
    A = sess.snapshot(cap=...)
    neighbours = A[some_vertex, :]
    ids, counts = sess.query.top_k(5)
"""
from repro_torch.core.assoc import PAD, Assoc, empty, from_triples  # noqa: F401
from repro_torch.core.semiring import (  # noqa: F401  (re-exported registry)
    COUNT,
    FIRST,
    MAX_MIN,
    MAX_PLUS,
    MAX_TIMES,
    MIN_MAX,
    MIN_PLUS,
    MIN_TIMES,
    PLUS_TIMES,
    REGISTRY,
    Semiring,
)

from .algebra import OpPolicy, cap_policy, current_policy
from .config import CapacityPlan, ServeConfig, StreamConfig
from .session import (
    D4MStream,
    QueryNamespace,
    StreamView,
    build_update_step,
    scan_ingest,
    scan_ingest_and_snapshot,
)

__all__ = [
    "Assoc",
    "CapacityPlan",
    "PAD",
    "empty",
    "from_triples",
    "D4MStream",
    "OpPolicy",
    "QueryNamespace",
    "Semiring",
    "ServeConfig",
    "StreamConfig",
    "StreamView",
    "build_update_step",
    "cap_policy",
    "current_policy",
    "scan_ingest",
    "scan_ingest_and_snapshot",
    "PLUS_TIMES",
    "MAX_PLUS",
    "MIN_PLUS",
    "MAX_TIMES",
    "MIN_TIMES",
    "MAX_MIN",
    "MIN_MAX",
    "FIRST",
    "COUNT",
    "REGISTRY",
]
