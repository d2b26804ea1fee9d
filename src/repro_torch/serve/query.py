"""The online query plane: executor, incremental degree tracker, client.

Port of ``repro.serve.query``, over :mod:`repro_torch.core.analytics`;
replies carry host copies of the view's tensors (bfloat16 as float32).

Three pieces sit behind ``ServeConfig.publish_every``:

* :class:`DegreeTracker` — host-side incremental maintenance of the out/in
  degree vectors, folded per fed microbatch on the feed thread (off the
  device path).  Published views are seeded with the lifted vectors, so
  ``degrees``/``top_k`` answer without re-reducing the snapshot — the fix
  for the old per-call full reduction.
* :class:`QueryExecutor` — maps typed :class:`~repro_torch.serve.wire.QueryRequest`
  messages onto the latest published
  :class:`~repro_torch.d4m.session.StreamView` and builds typed
  :class:`~repro_torch.serve.wire.QueryReply` responses (columnar live-entry
  arrays + scalars + the view's isolation metadata).  It runs on the
  source's reader thread, on the card on a CUDA stream of its own, and
  touches ONLY published views — never the engine state the feed thread
  is updating.
* :class:`QueryClient` — a small blocking client speaking the op-coded
  protocol over one socket; it can interleave inserts and queries on the
  same connection, which is the whole point of the unified protocol.
"""
from __future__ import annotations

import socket
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import analytics
from repro_torch.core.assoc import PAD
from repro_torch.obs import hist as obs_hist

from . import wire

#: Query ops the executor understands.  All but ``metrics`` map over
#: StreamView methods; ``metrics`` scrapes the server's live
#: :class:`~repro_torch.obs.MetricsRegistry` and needs no published view.
QUERY_OPS = ("degrees", "top_k", "row", "get", "triangles", "stats", "metrics")


# ---------------------------------------------------------------------------
# incremental degree maintenance
# ---------------------------------------------------------------------------

class DegreeTracker:
    """Fold each fed microbatch's values into per-vertex out/in degrees.

    The fold is the semiring's add lifted to numpy
    (:func:`repro_torch.core.analytics.host_degree_fold`); semirings without a
    host fold (e.g. ``first``) leave :attr:`supported` False and the serve
    loop skips tracking — views then compute degrees on first use instead.

    Exactness contract: the incremental fold equals the snapshot reduction
    whenever the arithmetic itself is order-independent — max/min always,
    sums for integer-valued weights (the paper's unit-weight traffic).
    Arbitrary float sums may differ in last-bit rounding from the device
    reduction order; the interleave tests and the bench pin unit weights.
    """

    def __init__(self, sr, dtype=np.float32):
        self._fold = analytics.host_degree_fold(sr)
        self.dtype = host_dtype(dtype)
        # numpy has no bfloat16 of its own: a bfloat16 session's folds would
        # round as the reference's ml_dtypes folds do only by luck, so its
        # views reduce their snapshot instead (ROADMAP C16)
        self.supported = self._fold is not None and dtype != torch.bfloat16
        self._out: Dict[int, float] = {}
        self._in: Dict[int, float] = {}
        self.records = 0  # live records folded in so far

    def seed(self, out_deg, in_deg) -> None:
        """Bootstrap the accumulators from already-reduced degree vectors —
        how a warm start (serving a session with pre-existing state, e.g. a
        restored checkpoint) keeps published views answering over ALL
        folded records, not just the ones fed since the restart."""
        for acc, a in ((self._out, out_deg), (self._in, in_deg)):
            n = int(a.nnz)
            if n:
                self._accumulate(acc, host(a.rows[:n]), host(a.vals[:n]))

    def feed(self, rows, cols, vals) -> None:
        """Fold one routed microbatch (any shape; PAD slots are dead)."""
        rows = np.asarray(rows).ravel()
        cols = np.asarray(cols).ravel()
        vals = np.asarray(vals).ravel()
        live = rows != PAD
        if not live.any():
            return
        r, c, v = rows[live], cols[live], vals[live]
        self._accumulate(self._out, r, v)
        self._accumulate(self._in, c, v)
        self.records += int(r.shape[0])

    def _accumulate(self, acc: Dict[int, float], ids, weights) -> None:
        order = np.argsort(ids, kind="stable")
        ids_s, w_s = ids[order], weights[order]
        uniq, start = np.unique(ids_s, return_index=True)
        folded = self._fold.reduceat(w_s, start)
        fold = self._fold
        for k, v in zip(uniq.tolist(), folded.tolist()):
            prev = acc.get(k)
            acc[k] = v if prev is None else float(fold(prev, v))

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Owned sorted copies: ``(out_ids, out_vals, in_ids, in_vals)``
        with unique int32 ids — the shape
        :func:`repro_torch.core.analytics.degrees_from_vectors` lifts."""

        def dump(acc: Dict[int, float]):
            ids = np.fromiter(acc.keys(), np.int64, count=len(acc))
            vals = np.fromiter(acc.values(), np.float64, count=len(acc))
            order = np.argsort(ids)
            return ids[order].astype(np.int32), vals[order].astype(self.dtype)

        return dump(self._out) + dump(self._in)


# ---------------------------------------------------------------------------
# server-side execution
# ---------------------------------------------------------------------------

def host_dtype(dtype) -> np.dtype:
    """The numpy type that carries values of ``dtype`` on the host: its own,
    or float32 for bfloat16 (numpy has none; float32 holds every bfloat16
    value exactly)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return np.dtype(np.float32)
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def host(x) -> np.ndarray:
    """An owned numpy copy of a tensor (bfloat16 as float32) or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x, copy=True)


def _live_columns(a) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """An Assoc's live entries as owned columnar host arrays (live entries
    are compacted into the first ``nnz`` slots by construction)."""
    n = int(a.nnz)
    return (
        host(a.rows[:n]).astype(np.int32),
        host(a.cols[:n]).astype(np.int32),
        host(a.vals[:n]),
    )


class QueryExecutor:
    """Answer :class:`~repro_torch.serve.wire.QueryRequest` messages over the
    session's latest published view.  See :data:`QUERY_OPS`."""

    def __init__(self, session, server=None):
        self.session = session
        self.server = server  # for head-position staleness, when serving
        self.queries_served = 0  # answered ok (errors are not "served")
        self._stream = None  # this executor's CUDA stream, made at first use
        # per-op latency histograms, pre-resolved once (None when the serve
        # loop runs without observability — execute() then skips straight
        # to the untimed path, one `is None` check)
        reg = getattr(server, "metrics", None)
        if reg is None:
            self._op_hists = None
        else:
            self._op_hists = {
                op: reg.histogram(f"query.{op}.latency_ns") for op in QUERY_OPS
            }

    def execute(self, request: "wire.QueryRequest") -> "wire.QueryReply":
        if self._op_hists is None:
            return self._on_stream(request)
        t0 = time.perf_counter_ns()
        try:
            return self._on_stream(request)
        finally:
            h = self._op_hists.get(request.op)
            if h is not None:
                h.record(time.perf_counter_ns() - t0)

    def _on_stream(self, request: "wire.QueryRequest") -> "wire.QueryReply":
        """On the card, queries run on this executor's own CUDA stream: the
        kernels' scratch is kept per stream, so they never share it with
        the feed loop's updates on another thread, and each view makes
        this stream wait for its publication event before it is read."""
        dev = self.session.device
        if dev.type != "cuda":
            return self._execute(request)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._stream):
            return self._execute(request)

    def _execute(self, request: "wire.QueryRequest") -> "wire.QueryReply":
        if request.op == "metrics":
            # the scrape must answer even before any view is published —
            # it reads the registry, not the stream
            return self._metrics_reply(request)
        view = self.session.latest_view()
        if view is None:
            return wire.QueryReply(
                id=request.id,
                ok=False,
                error="no published view yet (is ServeConfig.publish_every set?)",
            )
        staleness = None
        if self.server is not None and view.records is not None:
            staleness = max(0, int(self.server.records_fed) - int(view.records))
        try:
            scalars, arrays = self._run(view, request.op, dict(request.args))
        except Exception as e:
            return wire.QueryReply(
                id=request.id,
                ok=False,
                error=f"{type(e).__name__}: {e}",
                view_seq=int(view.seq),
                view_records=view.records,
                staleness=staleness,
            )
        self.queries_served += 1
        if request.op == "stats":
            # freshness + live latency percentiles ride along on stats, so
            # a wire client sees both without a separate metrics scrape
            if staleness is not None:
                scalars["view_staleness_records"] = int(staleness)
            if self._op_hists is not None:
                scalars["query_latency"] = {
                    op: h.summary()
                    for op, h in self._op_hists.items()
                    if h.count
                }
        return wire.QueryReply(
            id=request.id,
            ok=True,
            view_seq=int(view.seq),
            view_records=view.records,
            staleness=staleness,
            scalars=scalars,
            arrays=arrays,
        )

    def _metrics_reply(self, request: "wire.QueryRequest") -> "wire.QueryReply":
        reg = getattr(self.server, "metrics", None)
        if reg is None:
            return wire.QueryReply(
                id=request.id,
                ok=False,
                error="metrics disabled (enable with ServeConfig(metrics="
                      "True) or REPRO_OBS=1)",
            )
        fmt = str(request.args.get("format", "json"))
        if fmt == "prometheus":
            self.queries_served += 1
            return wire.QueryReply(
                id=request.id, ok=True, scalars={"text": reg.to_prometheus()}
            )
        if fmt != "json":
            return wire.QueryReply(
                id=request.id,
                ok=False,
                error=f"unknown metrics format {fmt!r} "
                      f"(known: 'json', 'prometheus')",
            )
        # one dump() read feeds BOTH the raw bucket arrays and the summary
        # percentiles, so the reply is internally consistent and the
        # integer summaries match what any holder of the same state would
        # compute (the scrape bit-exactness contract)
        dump = reg.dump()
        arrays = {
            f"hist.{name}.counts": np.asarray(st["counts"], np.int64)
            for name, st in dump["histograms"].items()
        }
        scalars = {
            "counters": dump["counters"],
            "gauges": dump["gauges"],
            "hist_max_ns": {
                name: int(st["max_ns"])
                for name, st in dump["histograms"].items()
            },
            "summaries": {
                name: obs_hist.summarize_state(st)
                for name, st in dump["histograms"].items()
                if obs_hist.state_count(st)
            },
        }
        self.queries_served += 1
        return wire.QueryReply(id=request.id, ok=True, scalars=scalars,
                               arrays=arrays)

    def _run(
        self, view, op: str, args: Dict[str, Any]
    ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        if op == "degrees":
            out_deg, in_deg = view.degrees(args.get("cap"))
            oi, _, ov = _live_columns(out_deg)
            ii, _, iv = _live_columns(in_deg)
            return {}, {
                "out_ids": oi, "out_vals": ov, "in_ids": ii, "in_vals": iv
            }
        if op == "top_k":
            ids, vals = view.top_k(
                int(args.get("k", 10)), str(args.get("by", "out"))
            )
            return {}, {"ids": host(ids).astype(np.int32), "vals": host(vals)}
        if op == "row":
            r = view.row(int(args["r"]), args.get("cap"))
            _, cols, vals = _live_columns(r)
            return {"r": int(args["r"])}, {"cols": cols, "vals": vals}
        if op == "get":
            value = view.get(int(args["r"]), int(args["c"]))
            return {"value": float(host(value))}, {}
        if op == "triangles":
            count = view.triangles(args.get("cap_sq"), args.get("max_fanout"))
            return {"triangles": float(host(count))}, {}
        if op == "stats":
            return dict(view.stats()), {}
        raise ValueError(f"unknown query op {op!r}; known ops: {QUERY_OPS}")


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class QueryClient:
    """Blocking client for the op-coded protocol: one socket, both planes.

    ``request(op, **args)`` round-trips one typed query;
    :meth:`insert` streams triple frames on the same connection — the
    server's reader interleaves them with queries in arrival order.  Close
    (or ``with``) when done: an open client counts as a live producer for
    the source's end-of-stream accounting.
    """

    def __init__(
        self,
        host: str,
        port: int,
        encoding: str = "binary",
        timeout_s: float = 30.0,
    ):
        if encoding not in wire.ENCODINGS:
            raise ValueError(
                f"encoding must be one of {wire.ENCODINGS}, got {encoding!r}"
            )
        self.encoding = encoding
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._buf = b""
        self._next_id = 0

    def request(self, op: str, **args) -> "wire.QueryReply":
        """Send one query and block for its reply (raises on transport
        errors and timeouts; an executor-side failure comes back as a
        reply with ``ok=False``, never an exception)."""
        self._next_id += 1
        req = wire.QueryRequest(op=op, args=args, id=self._next_id)
        self._sock.sendall(wire.encode_request(req, self.encoding))
        return self._await_reply(self._next_id)

    def metrics(self, **args) -> "wire.QueryReply":
        """Scrape the server's live metrics registry over this connection
        (the METRICS op).  ``format="json"`` (default) returns raw bucket
        arrays + integer summaries; ``format="prometheus"`` returns the
        text exposition in ``reply.scalars["text"]``."""
        self._next_id += 1
        self._sock.sendall(
            wire.encode_metrics_request(self._next_id, args, self.encoding)
        )
        return self._await_reply(self._next_id)

    def _await_reply(self, want_id: int) -> "wire.QueryReply":
        while True:
            messages, self._buf, _ = wire.decode_messages(
                self._buf, self.encoding
            )
            for kind, payload in messages:
                if kind == "reply" and int(payload.id) == want_id:
                    return payload
            data = self._sock.recv(1 << 16)
            if not data:
                raise ConnectionError(
                    "server closed the connection before replying"
                )
            self._buf += data

    def insert(self, rows, cols, vals) -> int:
        """Stream an insert batch on this same connection; returns the
        record count handed to the kernel."""
        rows = np.asarray(rows).ravel()
        self._sock.sendall(
            wire.encode(rows, cols, vals, self.encoding)
        )
        return int(rows.shape[0])

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "QueryClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
