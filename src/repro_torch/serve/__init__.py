"""``repro_torch.serve`` — the streaming ingress subsystem (port of
``repro.serve``).

Turns a :class:`repro_torch.d4m.D4MStream` from a pull-style library into a
served system: pluggable record sources (TCP loopback sockets, tailed
newline-delimited files, synthetic R-MAT traffic), a backpressured
microbatch router onto the K x D instance grid, and a double-buffered feed
loop with live telemetry and graceful drain -> snapshot -> checkpoint.

Quick start (the paper Section V shape: one feeder per instance group)::

    from repro_torch import d4m, serve

    cfg = d4m.StreamConfig(cuts=(1024, 8192), top_capacity=200_000,
                           batch_size=512, instances_per_device=8,
                           serve=d4m.ServeConfig(max_latency_ms=20))
    sess = d4m.D4MStream(cfg)                 # on the card; device="cpu" for tests

    src = serve.TCPSource(port=9100)          # or FileTailSource / RMATSource
    report = sess.serve(src)                  # blocks until the stream drains
    print(report.ingest_rate, report.telemetry["session"]["nnz_total"])

For manual control (live telemetry, mid-stream stop) drive the
:class:`D4MServer` directly::

    server = serve.D4MServer(sess, src).start()
    ...; print(server.telemetry())
    server.stop(drain=True)
"""
from repro_torch.d4m.config import ServeConfig  # noqa: F401  (re-export)

from .query import DegreeTracker, QueryClient, QueryExecutor
from .router import DRAIN, MicrobatchRouter, instance_of_numpy, route_numpy
from .server import D4MServer, ServeReport
from .sources import ArraySource, FileTailSource, RMATSource, Source, TCPSource
from .wire import (
    PROTOCOL_VERSION,
    QueryReply,
    QueryRequest,
    decode_binary,
    decode_messages,
    decode_text,
    encode,
    encode_binary,
    encode_metrics_request,
    encode_reply,
    encode_request,
    encode_text,
    send_triples,
)

__all__ = [
    "ArraySource",
    "D4MServer",
    "DRAIN",
    "DegreeTracker",
    "FileTailSource",
    "MicrobatchRouter",
    "PROTOCOL_VERSION",
    "QueryClient",
    "QueryExecutor",
    "QueryReply",
    "QueryRequest",
    "RMATSource",
    "ServeConfig",
    "ServeReport",
    "Source",
    "TCPSource",
    "decode_binary",
    "decode_messages",
    "decode_text",
    "encode",
    "encode_binary",
    "encode_metrics_request",
    "encode_reply",
    "encode_request",
    "encode_text",
    "instance_of_numpy",
    "route_numpy",
    "send_triples",
]
