"""Pluggable record sources for the streaming ingress loop.

Port of ``repro.serve.sources``; :class:`RMATSource` draws from numpy
(see there).

A *source* produces triple records ``(rows, cols, vals)`` as host numpy
chunks; the :class:`~repro_torch.serve.server.D4MServer` runs one reader thread
per source that drains ``chunks()`` into the microbatch router.  Four
implementations:

* :class:`TCPSource` — a loopback/LAN TCP listener (text or binary wire
  format, multiple concurrent producers multiplexed with ``selectors``);
* :class:`FileTailSource` — a newline-delimited triple file, optionally
  tailed (``follow=True``) like the paper's feeder processes reading files
  landed by collectors;
* :class:`RMATSource` — synthetic Graph500 R-MAT traffic (reuses
  :mod:`repro_torch.data.rmat`), the benchmark/load-test generator;
* :class:`ArraySource` — pre-materialized host arrays replayed in chunks
  (deterministic tests, replay-from-checkpoint).

The contract is intentionally tiny::

    source.start()                   # idempotent; bind sockets, open files
    for rows, cols, vals in source.chunks():
        ...                          # numpy int32/int32/float32, same length
    source.stop()                    # idempotent; also ends chunks()

``chunks()`` terminates when the stream is genuinely over (file EOF,
generator exhausted, all TCP producers disconnected) or when ``stop()`` is
called from another thread.  Sources never block forever: every wait is a
short poll against the stop flag.
"""
from __future__ import annotations

import os
import selectors
import socket
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from . import wire

Chunk = Tuple[np.ndarray, np.ndarray, np.ndarray]


class Source:
    """Base class: stop-flag plumbing + counters shared by every source."""

    def __init__(self) -> None:
        self._stop = threading.Event()
        self.records_out = 0  # records yielded so far
        self.malformed = 0  # records/lines that failed to parse (skipped)

    def start(self) -> "Source":
        return self

    def stop(self) -> None:
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def chunks(self) -> Iterator[Chunk]:  # pragma: no cover - interface
        raise NotImplementedError

    def set_metrics(self, registry) -> None:
        """Attach an observability registry (``repro_torch.obs.MetricsRegistry``).

        Only decoding sources pay anything: their ``_decode`` callable is
        wrapped so every decode call lands in the ``wire.decode_ns``
        histogram.  Called by the serve loop when metrics are on; with
        ``registry=None`` (or on a non-decoding source) this is a no-op and
        the bare decoder keeps running — the disabled path stays identical
        to a build without the obs plane.
        """
        if registry is None or not hasattr(self, "_decode"):
            return
        record = registry.histogram("wire.decode_ns").record
        self._decode = wire.timed_decoder(self._decode, record)

    def _count(self, chunk: Chunk) -> Chunk:
        self.records_out += int(chunk[0].shape[0])
        return chunk


# ---------------------------------------------------------------------------
# TCP loopback/LAN listener
# ---------------------------------------------------------------------------

class TCPSource(Source):
    """Listen for triple records on a TCP socket.

    ``port=0`` binds an ephemeral port (read :attr:`port` after
    :meth:`start`).  All accepted connections are multiplexed on one
    ``selectors`` loop inside :meth:`chunks`, each with its own reassembly
    buffer, so records interleave across producers but never tear within
    one.

    End-of-stream: with ``linger=False`` (default) the stream ends once at
    least one producer connected and all of them have disconnected — the
    natural shape for examples, tests, and batch feeds.  ``linger=True``
    keeps listening until :meth:`stop` (a long-lived server).
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        encoding: str = "text",
        linger: bool = False,
        poll_s: float = 0.05,
        recv_bytes: int = 1 << 16,
        faults=None,
    ):
        super().__init__()
        self.host = host
        self.port = int(port)
        self.encoding = encoding
        self._decode = wire.decoder_for(encoding)
        self._decode_messages = wire.decode_messages
        self.linger = linger
        self.poll_s = float(poll_s)
        self.recv_bytes = int(recv_bytes)
        self._listener: Optional[socket.socket] = None
        self.connections_seen = 0
        self.resets_injected = 0
        self.queries_seen = 0
        # the online query plane: when the serve loop installs a handler
        # (``QueryRequest -> QueryReply``), this source speaks the full
        # op-coded protocol — query frames are answered inline on the same
        # connection, insert frames flow to chunks() as before.  With no
        # handler the source stays a v0-compatible insert-only reader
        # (query frames then count malformed/desync, exactly as before).
        self._query_handler = None
        self.reply_timeout_s = 5.0
        # faults: Optional[repro_torch.faults.FaultPlan] — drives the
        # ``source.conn_reset`` site (forcibly drop one live producer
        # connection as if the peer RST it).  The serve loop attaches the
        # session plan via `set_faults`; standalone sources pass it here.
        self._faults = faults

    def set_faults(self, faults) -> None:
        self._faults = faults

    def set_metrics(self, registry) -> None:
        """Both decode paths (insert-only shim AND the message decoder the
        query plane uses) feed the same ``wire.decode_ns`` histogram."""
        if registry is None:
            return
        super().set_metrics(registry)
        record = registry.histogram("wire.decode_ns").record
        self._decode_messages = wire.timed_decoder(
            self._decode_messages, record
        )

    def set_query_handler(self, handler) -> None:
        """Install the query plane: ``handler(QueryRequest) -> QueryReply``.
        Called by :class:`~repro_torch.serve.server.D4MServer` when view
        publication is enabled; runs on this source's reader thread."""
        self._query_handler = handler

    def start(self) -> "TCPSource":
        if self._listener is None:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self.host, self.port))
            sock.listen(16)
            sock.setblocking(False)
            self._listener = sock
            self.port = sock.getsockname()[1]
        return self

    def stop(self) -> None:
        super().stop()

    def chunks(self) -> Iterator[Chunk]:
        self.start()
        sel = selectors.DefaultSelector()
        sel.register(self._listener, selectors.EVENT_READ, data=None)
        buffers: dict[socket.socket, bytes] = {}
        try:
            while not self.stopped:
                if (
                    not self.linger
                    and self.connections_seen > 0
                    and not buffers
                ):
                    break  # every producer came and went: stream over
                for key, _ in sel.select(timeout=self.poll_s):
                    if key.data is None:  # the listener
                        try:
                            conn, _ = self._listener.accept()
                        except OSError:
                            continue
                        conn.setblocking(False)
                        sel.register(conn, selectors.EVENT_READ, data=b"conn")
                        buffers[conn] = b""
                        self.connections_seen += 1
                        continue
                    conn = key.fileobj
                    if self._faults is not None:
                        spec = self._faults.fire(
                            "source.conn_reset", cursor=self.records_out
                        )
                        if spec is not None:
                            # peer-RST shape: already-parsed records
                            # survive, the buffered partial tail is lost
                            # (counted malformed by the final drain), and
                            # bytes still in the kernel buffer vanish
                            self.resets_injected += 1
                            chunk, _ = self._drain(buffers, conn, final=True)
                            sel.unregister(conn)
                            conn.close()
                            del buffers[conn]
                            if chunk is not None:
                                yield chunk
                            continue
                    try:
                        data = conn.recv(self.recv_bytes)
                    except BlockingIOError:
                        continue
                    except OSError:
                        data = b""
                    if data:
                        buffers[conn] += data
                        chunk, alive = self._drain(buffers, conn, final=False)
                        if not alive:  # desynchronized: drop the connection
                            sel.unregister(conn)
                            conn.close()
                            del buffers[conn]
                        if chunk is not None:
                            yield chunk
                    else:  # orderly shutdown from the peer
                        chunk, _ = self._drain(buffers, conn, final=True)
                        sel.unregister(conn)
                        conn.close()
                        del buffers[conn]
                        if chunk is not None:
                            yield chunk
            # stop() during live connections: flush whatever already arrived
            for conn in list(buffers):
                chunk, _ = self._drain(buffers, conn, final=True)
                if chunk is not None:
                    yield chunk
        finally:
            for conn in buffers:
                try:
                    conn.close()
                except OSError:
                    pass
            sel.close()
            self._listener.close()
            self._listener = None

    def _drain(
        self, buffers, conn, final: bool
    ) -> Tuple[Optional[Chunk], bool]:
        """Decode the connection's buffer.  Returns ``(chunk, alive)``;
        ``alive=False`` means the stream desynchronized and the caller must
        drop the connection — it cannot be resynchronized safely (see
        :func:`~repro_torch.serve.wire.decode_binary`), so keeping it would
        re-fail on every recv or, worse, false-sync on stray payload bytes
        that happen to look like a frame header."""
        buf = buffers[conn]
        if final and self.encoding == "text" and buf and not buf.endswith(b"\n"):
            buf += b"\n"  # a last record without its newline is still a record
        if self._query_handler is None:
            # insert-only path: byte-identical to the pre-query-plane source
            try:
                (r, c, v), leftover, bad = self._decode(buf)
            except ValueError:
                self.malformed += 1
                buffers[conn] = b""
                return None, False
            if final and leftover:
                # a producer died mid-frame: the incomplete tail is lost —
                # count it so the shortfall is diagnosable from telemetry
                bad += 1
                leftover = b""
            self.malformed += bad
            buffers[conn] = leftover
            if r.shape[0] == 0:
                return None, True
            return self._count((r, c, v)), True
        try:
            messages, leftover, bad = self._decode_messages(buf, self.encoding)
        except ValueError:
            self.malformed += 1
            buffers[conn] = b""
            return None, False
        if final and leftover:
            bad += 1
            leftover = b""
        self.malformed += bad
        buffers[conn] = leftover
        alive = True
        triples = []
        for kind, payload in messages:
            if kind == "insert":
                triples.append(payload)
            elif kind == "query":
                self.queries_seen += 1
                if not self._send(conn, wire.encode_reply(
                    self._answer(payload), self.encoding
                )):
                    alive = False  # client gone mid-reply: drop it
            else:
                # a REPLY arriving at the server is protocol nonsense —
                # framing-valid, so skip it like a mangled text line
                self.malformed += 1
        if not triples:
            return None, alive
        chunk = (
            np.concatenate([t[0] for t in triples]),
            np.concatenate([t[1] for t in triples]),
            np.concatenate([t[2] for t in triples]),
        )
        return self._count(chunk), alive

    def _answer(self, request) -> "wire.QueryReply":
        try:
            return self._query_handler(request)
        except Exception as e:  # the executor answers errors; this is a belt
            return wire.QueryReply(
                id=request.id, ok=False, error=f"{type(e).__name__}: {e}"
            )

    def _send(self, conn, data: bytes) -> bool:
        """Bounded non-blocking sendall for replies: the reader thread must
        never block forever on one slow query client (that would stall
        every producer multiplexed on this selector loop)."""
        deadline = time.monotonic() + self.reply_timeout_s
        view = memoryview(data)
        while view:
            try:
                sent = conn.send(view)
                view = view[sent:]
            except (BlockingIOError, InterruptedError):
                if time.monotonic() > deadline:
                    return False
                time.sleep(0.001)
            except OSError:
                return False
        return True


# ---------------------------------------------------------------------------
# newline-delimited file, with tailing
# ---------------------------------------------------------------------------

class FileTailSource(Source):
    """Read a triple file; with ``follow=True`` keep tailing for appends.

    ``follow=False`` yields the file once and ends at EOF.  ``follow=True``
    polls for growth every ``poll_s`` (collector processes appending to a
    landing file) until :meth:`stop` is called, with ``tail -F`` rotation
    semantics: an in-place truncation rewinds to the start of the new
    content, and a rename+create rotation reopens the path, so records
    written between the rotation and the next poll are read once, never
    skipped and never re-ingested from the old file.  Like ``tail -F``
    itself, in-place truncation detection is poll-based and best-effort: a
    writer that truncates and regrows the file past the reader's offset
    within one poll (``copytruncate`` under a very hot writer) is
    undetectable — use rename+create rotation for lossless feeds.
    """

    def __init__(
        self,
        path: str,
        encoding: str = "text",
        follow: bool = False,
        poll_s: float = 0.05,
        chunk_bytes: int = 1 << 16,
    ):
        super().__init__()
        self.path = path
        self.encoding = encoding
        self._decode = wire.decoder_for(encoding)
        self.follow = follow
        self.poll_s = float(poll_s)
        self.chunk_bytes = int(chunk_bytes)

    def chunks(self) -> Iterator[Chunk]:
        buf = b""
        f = open(self.path, "rb")
        try:
            while not self.stopped:
                data = f.read(self.chunk_bytes)
                if not data:
                    if not self.follow:
                        break
                    # tail -F semantics at EOF: records written between a
                    # rotation and this poll must be read, never skipped
                    try:
                        st = os.stat(self.path)
                        if st.st_ino != os.fstat(f.fileno()).st_ino:
                            # rotated by rename+create.  Open the NEW file
                            # first: if a second rotation makes this raise,
                            # the old fd stays usable and the next poll
                            # retries.  Then drain records the writer
                            # appended to the old file after our last read
                            # — closing without draining would silently
                            # lose them — and only then switch over.
                            nf = open(self.path, "rb")
                            try:
                                while True:
                                    data = f.read(self.chunk_bytes)
                                    if not data:
                                        break
                                    buf += data
                                    chunk = self._parse(buf, final=False)
                                    buf = self._leftover
                                    if chunk is not None:
                                        yield chunk
                            except BaseException:
                                # drain failed (stale old fd, consumer
                                # gone): nf must not leak once per poll
                                nf.close()
                                raise
                            f.close()
                            f = nf
                            # the old file's residue is at ITS end of
                            # file: parse with final semantics (same as
                            # stop()/EOF), so a last record missing only
                            # its newline is delivered, not dropped
                            chunk = self._parse(buf, final=True)
                            buf = b""
                            if chunk is not None:
                                yield chunk
                        elif st.st_size < f.tell():
                            # truncated in place: rewind to the new start
                            f.seek(0)
                            chunk = self._parse(buf, final=True)
                            buf = b""
                            if chunk is not None:
                                yield chunk
                    except OSError:
                        pass  # mid-rotation; the path will reappear
                    time.sleep(self.poll_s)
                    continue
                buf += data
                chunk = self._parse(buf, final=False)
                buf = self._leftover
                if chunk is not None:
                    yield chunk
        finally:
            f.close()
        chunk = self._parse(buf, final=True)
        if chunk is not None:
            yield chunk

    def _parse(self, buf: bytes, final: bool) -> Optional[Chunk]:
        if final and self.encoding == "text" and buf and not buf.endswith(b"\n"):
            buf += b"\n"
        (r, c, v), self._leftover, bad = self._decode(buf)
        if final and self._leftover:
            bad += 1  # truncated final frame: counted, not silently dropped
            self._leftover = b""
        self.malformed += bad
        if r.shape[0] == 0:
            return None
        return self._count((r, c, v))


# ---------------------------------------------------------------------------
# synthetic R-MAT traffic generator
# ---------------------------------------------------------------------------

class RMATSource(Source):
    """Graph500-style power-law edge traffic (paper Section IV's workload).

    Generates ``total_records`` edges in ``chunk_records`` groups with
    :func:`repro_torch.data.rmat.rmat_edges`, each chunk from a numpy
    generator seeded by ``(seed, chunk index)``: deterministic in ``seed``,
    but not the reference's bits (it draws from ``jax.random``), so parity
    tests feed :class:`ArraySource`.
    ``pregenerate=True`` materializes every chunk on the host up front so a
    serving benchmark measures the feed loop, not the generator;
    ``throttle_s`` sleeps between chunks to emulate a paced producer.

    **Partitioned generation** for fleets: ``(part, num_parts)`` makes this
    source yield only every ``num_parts``-th chunk of the *same* logical
    ``total_records`` stream, starting at chunk ``part`` — so N workers
    constructed with identical ``(total_records, chunk_records, scale,
    seed)`` and ``part = 0..N-1`` draw disjoint deterministic slices whose
    union is exactly the single-source stream, bit for bit: each chunk's
    generator is seeded by its *global* index.
    """

    def __init__(
        self,
        total_records: int,
        chunk_records: int = 4096,
        scale: int = 14,
        seed: int = 0,
        pregenerate: bool = False,
        throttle_s: float = 0.0,
        part: int = 0,
        num_parts: int = 1,
    ):
        super().__init__()
        if total_records < 1 or chunk_records < 1:
            raise ValueError(
                f"need positive sizes, got total={total_records} "
                f"chunk={chunk_records}"
            )
        if num_parts < 1 or not 0 <= part < num_parts:
            raise ValueError(
                f"need 0 <= part < num_parts, got part={part} "
                f"num_parts={num_parts}"
            )
        self.total_records = int(total_records)
        self.chunk_records = int(chunk_records)
        self.scale = int(scale)
        self.seed = int(seed)
        self.throttle_s = float(throttle_s)
        self.part = int(part)
        self.num_parts = int(num_parts)
        self._pre: Optional[list] = None
        if pregenerate:
            self._pre = list(self._generate())

    def _generate(self) -> Iterator[Chunk]:
        from repro_torch.data import rmat

        remaining = self.total_records
        chunk_index = 0
        while remaining > 0:
            n = min(self.chunk_records, remaining)
            if chunk_index % self.num_parts == self.part:
                # one numpy generator per global chunk, seeded by (seed,
                # chunk index): a part draws the same chunk as the whole
                rng = np.random.default_rng([self.seed, chunk_index])
                s, d = rmat.rmat_edges(rng, n, self.scale)
                yield s, d, np.ones((n,), np.float32)
            remaining -= n
            chunk_index += 1

    def chunks(self) -> Iterator[Chunk]:
        it = iter(self._pre) if self._pre is not None else self._generate()
        for chunk in it:
            if self.stopped:
                break
            if self.throttle_s:
                time.sleep(self.throttle_s)
            yield self._count(chunk)


# ---------------------------------------------------------------------------
# pre-materialized arrays (tests, replay)
# ---------------------------------------------------------------------------

class ArraySource(Source):
    """Replay host arrays in fixed-size chunks (deterministic feeds)."""

    def __init__(
        self,
        rows,
        cols,
        vals,
        chunk_records: int = 4096,
        throttle_s: float = 0.0,
    ):
        super().__init__()
        self.rows = np.asarray(rows, np.int32).ravel()
        self.cols = np.asarray(cols, np.int32).ravel()
        self.vals = np.asarray(vals, np.float32).ravel()
        if not (self.rows.shape == self.cols.shape == self.vals.shape):
            raise ValueError("triple columns disagree")
        if chunk_records < 1:
            raise ValueError(f"chunk_records must be >= 1, got {chunk_records}")
        self.chunk_records = int(chunk_records)
        self.throttle_s = float(throttle_s)

    def chunks(self) -> Iterator[Chunk]:
        for lo in range(0, self.rows.shape[0], self.chunk_records):
            if self.stopped:
                break
            if self.throttle_s:
                time.sleep(self.throttle_s)
            hi = lo + self.chunk_records
            yield self._count(
                (self.rows[lo:hi], self.cols[lo:hi], self.vals[lo:hi])
            )
