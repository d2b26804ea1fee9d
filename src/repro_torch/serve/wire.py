"""Versioned, op-coded wire protocol for the serve plane + a loopback client.

Port of ``repro.serve.wire``, copied: numpy only, so frames made by one
package decode in the other.

One protocol, two encodings, four ops.  Every byte on a serve socket is a
*message* with an **op** — ``insert`` (triple records flowing in), ``query``
(a typed analytics request), ``reply`` (its typed response) or ``metrics``
(a runtime-observability scrape of the server's live
:class:`~repro_torch.obs.MetricsRegistry`) — so a single TCP listener speaks the
ingest path, the online query plane, and the metrics scrape.

* ``"text"`` — D4M's native triple-store form: one ASCII line per message.
  Insert lines are ``row<TAB>col<TAB>val\\n`` (any whitespace separator is
  accepted on the read side; human-greppable, what the tailing file source
  reads).  Query lines start with ``?`` and reply lines with ``!``, each
  carrying one JSON object.
* ``"binary"`` — framed columnar batches for high-rate feeds.  Two frame
  generations share one decoder:

  - **v0** (legacy, insert-only): an 8-byte header (magic ``D4MB`` +
    little-endian uint32 record count) followed by ``count`` int32 rows,
    ``count`` int32 cols, ``count`` float32 vals.  v0 frames decode
    bit-identically to the pre-protocol decoder — they *are* the INSERT op
    at version 0.
  - **v1** (op-coded): a 12-byte header ``magic D4MF + version u8 + op u8 +
    reserved u16 + body_len u32``.  INSERT bodies are ``count u32`` + the
    same columnar triple layout as v0; QUERY bodies are one JSON object;
    REPLY bodies are ``json_len u32 + JSON + raw columnar arrays`` (the
    JSON's ``arrays`` table names each section's dtype and count, so float
    results round-trip bit-exactly without a text format).

Both encodings share the same containment bounds: ids pass through
:func:`_ids_i32` (float ids truncate, out-of-int32-range ids raise),
insert frames are bounded by :data:`MAX_FRAME_RECORDS` and control frames
by :data:`MAX_CONTROL_BYTES` / the reply array budget — a corrupted length
field behind a valid magic can never buffer a connection toward OOM.

Decoders are incremental: each returns ``(..., leftover, malformed)`` where
``leftover`` is the tail of the buffer that is not yet a complete
line/frame — callers keep it and prepend the next socket read.  The
triple-only entry points (:func:`decode_text` / :func:`decode_binary`)
remain as compatibility shims over the message decoder for consumers that
only ingest (file tails, v0 producers).
"""
from __future__ import annotations

import dataclasses
import json
import socket
import struct
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

ENCODINGS = ("text", "binary")

#: Current op-coded protocol version (the ``version`` byte in v1+ frames).
#: Version 0 is the implicit version of legacy ``D4MB`` insert frames.
PROTOCOL_VERSION = 1

BINARY_MAGIC = b"D4MB"  # v0: insert-only columnar frame
FRAME_MAGIC = b"D4MF"  # v1+: op-coded frame
_HEADER = struct.Struct("<4sI")  # v0: magic, record count
_V1_HEADER = struct.Struct("<4sBBHI")  # magic, version, op, reserved, body len

#: Message op codes carried in the v1 frame header (and implied by line
#: shape in the text encoding: triples / ``?`` / ``!``).
OP_INSERT = 0x01
OP_QUERY = 0x02
OP_REPLY = 0x03
OP_METRICS = 0x04
OP_NAMES = {
    OP_INSERT: "insert",
    OP_QUERY: "query",
    OP_REPLY: "reply",
    OP_METRICS: "metrics",
}

# Sanity ceiling on one frame's record count (16M records = 192 MiB body,
# far above any sane batch).  Without it, a corrupted count field behind a
# valid magic makes the receiver buffer the connection unboundedly toward
# OOM "waiting for the frame to complete" instead of dropping it.  Shared
# by v0 frames, v1 INSERT bodies, and the per-array budget of REPLY bodies.
MAX_FRAME_RECORDS = 1 << 24

#: Ceiling on a QUERY body / a REPLY's JSON section (1 MiB — queries are
#: small typed requests, not bulk data).  Same OOM containment as
#: :data:`MAX_FRAME_RECORDS`, applied to the control plane.
MAX_CONTROL_BYTES = 1 << 20

#: Ceiling on a full REPLY body: the JSON budget plus three result columns
#: at the insert bound (replies carry at most snapshot-shaped columnar
#: results, never more than an insert frame may).
MAX_REPLY_BYTES = MAX_CONTROL_BYTES + 12 * MAX_FRAME_RECORDS

Records = Tuple[np.ndarray, np.ndarray, np.ndarray]  # rows i32, cols i32, vals f32

#: A decoded message: ``("insert", (rows, cols, vals))``,
#: ``("query", QueryRequest)`` or ``("reply", QueryReply)``.
Message = Tuple[str, Any]

_I32_MIN = np.iinfo(np.int32).min
_I32_MAX = np.iinfo(np.int32).max


def _empty() -> Records:
    return (
        np.zeros((0,), np.int32),
        np.zeros((0,), np.int32),
        np.zeros((0,), np.float32),
    )


def _ids_i32(x, name: str) -> np.ndarray:
    """Shared id coercion for BOTH encoders: float ids truncate (records
    out of a jnp computation), but out-of-int32-range ids raise instead of
    silently wrapping into fabricated ids the decoders' range checks could
    never catch."""
    a = np.asarray(x).ravel()
    if a.size and not (
        np.min(a) >= _I32_MIN and np.max(a) <= _I32_MAX
    ):
        raise ValueError(f"{name} ids out of int32 range")
    return np.ascontiguousarray(a, np.int32)


# ---------------------------------------------------------------------------
# typed request/response messages
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One typed analytics request (the QUERY op's payload).

    ``op`` names a query operation the server's executor understands
    (``degrees`` / ``top_k`` / ``row`` / ``get`` / ``triangles`` /
    ``stats``); ``args`` carries its keyword arguments; ``id`` is an opaque
    client correlation id echoed on the reply.
    """

    op: str
    args: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    id: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {"id": int(self.id), "op": str(self.op), "args": dict(self.args)}

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "QueryRequest":
        if not isinstance(obj, Mapping) or not isinstance(obj.get("op"), str):
            raise ValueError(f"malformed query payload: {obj!r}")
        args = obj.get("args", {})
        if not isinstance(args, Mapping):
            raise ValueError(f"query args must be an object, got {args!r}")
        return cls(op=obj["op"], args=dict(args), id=int(obj.get("id", 0)))


@dataclasses.dataclass(frozen=True)
class QueryReply:
    """One typed analytics response (the REPLY op's payload).

    Every reply names the :class:`~repro_torch.d4m.session.StreamView` it was
    answered against — ``view_seq`` (publication sequence number),
    ``view_records`` (source records folded into that view) and
    ``staleness`` (records the live head had ingested beyond the view when
    the reply was built) — so a client can reason about read isolation
    without a second round trip.  Results come back as ``scalars`` (plain
    JSON values) and ``arrays`` (named columnar numpy arrays, bit-exact in
    both encodings).
    """

    id: int = 0
    ok: bool = True
    error: Optional[str] = None
    view_seq: Optional[int] = None
    view_records: Optional[int] = None
    staleness: Optional[int] = None
    scalars: Dict[str, Any] = dataclasses.field(default_factory=dict)
    arrays: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def _meta(self) -> Dict[str, Any]:
        return {
            "id": int(self.id),
            "ok": bool(self.ok),
            "error": self.error,
            "view_seq": self.view_seq,
            "view_records": self.view_records,
            "staleness": self.staleness,
            "scalars": {str(k): v for k, v in self.scalars.items()},
        }

    @classmethod
    def _from_meta(
        cls, obj: Mapping[str, Any], arrays: Dict[str, np.ndarray]
    ) -> "QueryReply":
        if not isinstance(obj, Mapping) or "ok" not in obj:
            raise ValueError(f"malformed reply payload: {obj!r}")
        return cls(
            id=int(obj.get("id", 0)),
            ok=bool(obj["ok"]),
            error=obj.get("error"),
            view_seq=obj.get("view_seq"),
            view_records=obj.get("view_records"),
            staleness=obj.get("staleness"),
            scalars=dict(obj.get("scalars", {})),
            arrays=arrays,
        )


# ---------------------------------------------------------------------------
# text encoding
# ---------------------------------------------------------------------------

def encode_text(rows, cols, vals) -> bytes:
    """Serialize insert triples as newline-delimited ``row\\tcol\\tval`` lines.

    Values are written with 9 significant digits, which round-trips any
    float32 exactly — ``decode_text(encode_text(...))`` is value-preserving
    on the wire's float32 payloads, so a text feed replays bit-identically.
    """
    rows = _ids_i32(rows, "row")  # shared with the binary encoder: float
    cols = _ids_i32(cols, "col")  # ids must not emit '1.0' lines our own
    vals = np.asarray(vals, np.float32).ravel()  # decoder then rejects
    if not (rows.shape == cols.shape == vals.shape):
        raise ValueError(
            f"triple columns disagree: {rows.shape} {cols.shape} {vals.shape}"
        )
    out = []
    for r, c, v in zip(rows.tolist(), cols.tolist(), vals.tolist()):
        out.append(f"{r}\t{c}\t{v:.9g}\n")
    return "".join(out).encode("ascii")


def _parse_text_triples(parts: List[List[bytes]]) -> Tuple[Records, int]:
    """Parse pre-split triple lines (each a list of whitespace fields).

    Returns ``(records, malformed)`` — ``malformed`` counts lines that did
    not parse as three numeric fields with int32-range ids (skipped, never
    fatal: one bad record must not poison a long-lived feed).
    """
    good = [p for p in parts if len(p) == 3]
    malformed = len(parts) - len(good)
    if not good:
        return _empty(), malformed
    try:
        flat = np.array([t for p in good for t in p])
        # ids parse through int64 with an EXPLICIT range check: numpy 1.x
        # silently wraps out-of-int32-range strings on a direct int32
        # astype (only numpy >= 2 raises), which would fabricate ids
        r64 = flat[0::3].astype(np.int64)
        c64 = flat[1::3].astype(np.int64)
        lo, hi = np.int64(_I32_MIN), np.int64(_I32_MAX)
        if (
            r64.min() < lo or r64.max() > hi
            or c64.min() < lo or c64.max() > hi
        ):
            raise ValueError("id out of int32 range")
        return (
            (
                r64.astype(np.int32),
                c64.astype(np.int32),
                flat[2::3].astype(np.float32),
            ),
            malformed,
        )
    except (ValueError, OverflowError):
        # non-numeric garbage or an out-of-int32-range id in a 3-field
        # line; re-parse per line so one bad record skips, not the block
        pass
    rows, cols, vals = [], [], []
    for p in good:
        try:
            r, c, v = int(p[0]), int(p[1]), float(p[2])
            if not (_I32_MIN <= r <= _I32_MAX and _I32_MIN <= c <= _I32_MAX):
                raise ValueError(p)
        except (ValueError, OverflowError):
            malformed += 1
            continue
        rows.append(r)
        cols.append(c)
        vals.append(v)
    return (
        (
            np.asarray(rows, np.int32),
            np.asarray(cols, np.int32),
            np.asarray(vals, np.float32),
        ),
        malformed,
    )


def decode_text(buf: bytes) -> Tuple[Records, bytes, int]:
    """Parse every complete insert line in ``buf`` (triple-only shim).

    Returns ``((rows, cols, vals), leftover, malformed)`` — ``leftover`` is
    the trailing partial line.  Control lines (``?``/``!``) count as
    malformed here, exactly like any other non-triple line: this is the
    v0-compatible read path for sources that only ingest.
    """
    cut = buf.rfind(b"\n")
    if cut < 0:
        return _empty(), buf, 0
    block, leftover = buf[: cut + 1], buf[cut + 1 :]
    # framing is validated PER LINE, always: a flat block.split() could
    # re-frame a short line's fields into the next record (e.g.
    # "1\t2\n3\t4\t5\t6\n" is two malformed lines, not two records).
    # Only the numeric conversion is vectorized.
    parts = [p for p in (ln.split() for ln in block.splitlines()) if p]
    records, malformed = _parse_text_triples(parts)
    return records, leftover, malformed


def _decode_text_messages(buf: bytes) -> Tuple[List[Message], bytes, int]:
    cut = buf.rfind(b"\n")
    if cut < 0:
        return [], buf, 0
    block, leftover = buf[: cut + 1], buf[cut + 1 :]
    messages: List[Message] = []
    malformed = 0
    pending: List[List[bytes]] = []  # contiguous triple lines, batched

    def flush_triples() -> None:
        nonlocal malformed
        if not pending:
            return
        records, bad = _parse_text_triples(pending)
        malformed += bad
        pending.clear()
        if records[0].shape[0]:
            messages.append(("insert", records))

    for ln in block.splitlines():
        stripped = ln.strip()
        if not stripped:
            continue
        kind = stripped[:1]
        if kind not in (b"?", b"!"):
            pending.append(ln.split())
            continue
        flush_triples()
        if len(stripped) > MAX_CONTROL_BYTES:
            malformed += 1
            continue
        try:
            obj = json.loads(stripped[1:].decode("utf-8"))
            if kind == b"?":
                messages.append(("query", QueryRequest.from_json(obj)))
            else:
                arrays = _arrays_from_json(obj.pop("arrays", {}))
                messages.append(("reply", QueryReply._from_meta(obj, arrays)))
        except (ValueError, UnicodeDecodeError):
            malformed += 1
    flush_triples()
    return messages, leftover, malformed


def _arrays_to_json(arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        out[str(name)] = {"dtype": str(a.dtype), "data": a.ravel().tolist()}
    return out


def _arrays_from_json(obj: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    if not isinstance(obj, Mapping):
        raise ValueError(f"reply arrays must be an object, got {obj!r}")
    out = {}
    for name, spec in obj.items():
        # float32 survives the JSON round trip bit-exactly: float32->double
        # is exact, json repr round-trips the double, and the astype back
        # to float32 is exact again
        out[str(name)] = np.asarray(spec["data"], np.dtype(spec["dtype"]))
    return out


# ---------------------------------------------------------------------------
# binary encoding
# ---------------------------------------------------------------------------

def _insert_body(rows, cols, vals) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rows = _ids_i32(rows, "row")
    cols = _ids_i32(cols, "col")
    vals = np.ascontiguousarray(np.asarray(vals).ravel(), np.float32)
    if not (rows.shape == cols.shape == vals.shape):
        raise ValueError(
            f"triple columns disagree: {rows.shape} {cols.shape} {vals.shape}"
        )
    return rows, cols, vals


def encode_binary(rows, cols, vals, version: int = 0) -> bytes:
    """Framed columnar insert batch(es) — the INSERT op.

    ``version=0`` (default) emits legacy ``D4MB`` frames — what
    :func:`send_triples` puts on the wire, so any v0 receiver keeps
    working; ``version=1`` emits op-coded ``D4MF`` INSERT frames.  Both
    decode identically.  Batches beyond :data:`MAX_FRAME_RECORDS` are
    split into multiple frames, so the encoder can never emit a frame its
    own decoder rejects as desynchronized.
    """
    if version not in (0, PROTOCOL_VERSION):
        raise ValueError(f"unknown insert frame version {version}")
    rows, cols, vals = _insert_body(rows, cols, vals)
    if rows.shape[0] > MAX_FRAME_RECORDS:
        return b"".join(
            encode_binary(
                rows[i : i + MAX_FRAME_RECORDS],
                cols[i : i + MAX_FRAME_RECORDS],
                vals[i : i + MAX_FRAME_RECORDS],
                version=version,
            )
            for i in range(0, rows.shape[0], MAX_FRAME_RECORDS)
        )
    n = rows.shape[0]
    payload = rows.tobytes() + cols.tobytes() + vals.tobytes()
    if version == 0:
        return _HEADER.pack(BINARY_MAGIC, n) + payload
    body = struct.pack("<I", n) + payload
    return (
        _V1_HEADER.pack(FRAME_MAGIC, PROTOCOL_VERSION, OP_INSERT, 0, len(body))
        + body
    )


def _frame(op: int, body: bytes) -> bytes:
    return _V1_HEADER.pack(FRAME_MAGIC, PROTOCOL_VERSION, op, 0, len(body)) + body


def encode_request(req: QueryRequest, encoding: str = "binary") -> bytes:
    """Serialize a :class:`QueryRequest` (the QUERY op)."""
    payload = json.dumps(req.to_json(), separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_CONTROL_BYTES:
        raise ValueError(
            f"query payload ({len(payload)} B) exceeds MAX_CONTROL_BYTES"
        )
    if encoding == "text":
        return b"?" + payload + b"\n"
    if encoding == "binary":
        return _frame(OP_QUERY, payload)
    raise ValueError(f"encoding must be one of {ENCODINGS}, got {encoding!r}")


def encode_metrics_request(
    id: int = 0,
    args: Optional[Mapping[str, Any]] = None,
    encoding: str = "binary",
) -> bytes:
    """Serialize a METRICS scrape request.

    Binary emits a dedicated ``OP_METRICS`` frame; text reuses the query
    line form (``?{"op":"metrics",...}``) since text ops are implied by
    line shape.  Either way the server sees a ``QueryRequest`` with
    ``op="metrics"`` and answers with a normal REPLY.
    """
    req = QueryRequest(op="metrics", args=dict(args or {}), id=int(id))
    if encoding == "text":
        return encode_request(req, "text")
    if encoding != "binary":
        raise ValueError(f"encoding must be one of {ENCODINGS}, got {encoding!r}")
    payload = json.dumps(
        {"id": int(req.id), "args": dict(req.args)}, separators=(",", ":")
    ).encode("utf-8")
    if len(payload) > MAX_CONTROL_BYTES:
        raise ValueError(
            f"metrics payload ({len(payload)} B) exceeds MAX_CONTROL_BYTES"
        )
    return _frame(OP_METRICS, payload)


def encode_reply(rep: QueryReply, encoding: str = "binary") -> bytes:
    """Serialize a :class:`QueryReply` (the REPLY op).

    Binary replies carry result arrays as raw columnar sections after the
    JSON header (bit-exact, no per-element loop); text replies inline them
    as JSON lists (still bit-exact for int32/float32 — see
    :func:`_arrays_from_json`).
    """
    if encoding == "text":
        obj = rep._meta()
        obj["arrays"] = _arrays_to_json(rep.arrays)
        return b"!" + json.dumps(obj, separators=(",", ":")).encode("utf-8") + b"\n"
    if encoding != "binary":
        raise ValueError(f"encoding must be one of {ENCODINGS}, got {encoding!r}")
    meta = rep._meta()
    sections = []
    table = []
    for name, a in rep.arrays.items():
        a = np.ascontiguousarray(np.asarray(a).ravel())
        if a.shape[0] > MAX_FRAME_RECORDS:
            raise ValueError(
                f"reply array {name!r} ({a.shape[0]} elements) exceeds "
                f"MAX_FRAME_RECORDS"
            )
        table.append([str(name), str(a.dtype), int(a.shape[0])])
        sections.append(a.tobytes())
    meta["arrays"] = table
    head = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    if len(head) > MAX_CONTROL_BYTES:
        raise ValueError(
            f"reply metadata ({len(head)} B) exceeds MAX_CONTROL_BYTES"
        )
    body = struct.pack("<I", len(head)) + head + b"".join(sections)
    return _frame(OP_REPLY, body)


def _parse_v1_body(op: int, body: bytes) -> Tuple[Optional[Message], int]:
    """Parse one complete v1 frame body.  Returns ``(message, malformed)``;
    a framing-valid but semantically bad body is skipped (counted), never
    fatal — the stream itself is still synchronized."""
    if op == OP_INSERT:
        if len(body) < 4:
            return None, 1
        (count,) = struct.unpack_from("<I", body, 0)
        if count > MAX_FRAME_RECORDS or len(body) != 4 + 12 * count:
            raise ValueError(
                f"insert body disagrees with its count field (count={count}, "
                f"body={len(body)} B); binary feed desynchronized"
            )
        r = np.frombuffer(body, np.int32, count, 4)
        c = np.frombuffer(body, np.int32, count, 4 + 4 * count)
        v = np.frombuffer(body, np.float32, count, 4 + 8 * count)
        return ("insert", (r, c, v)), 0
    if op in (OP_QUERY, OP_METRICS):
        # A METRICS frame is a QUERY whose op is forced to "metrics": it
        # reuses the whole query dispatch path (source -> handler ->
        # executor -> REPLY) while staying distinguishable on the wire.
        try:
            obj = json.loads(body) if body else {}
            if op == OP_METRICS:
                if not isinstance(obj, Mapping):
                    return None, 1
                obj = dict(obj)
                obj["op"] = "metrics"
            return ("query", QueryRequest.from_json(obj)), 0
        except (ValueError, UnicodeDecodeError):
            return None, 1
    # OP_REPLY
    try:
        if len(body) < 4:
            raise ValueError("short reply body")
        (jlen,) = struct.unpack_from("<I", body, 0)
        if jlen > MAX_CONTROL_BYTES or 4 + jlen > len(body):
            raise ValueError("reply metadata length out of bounds")
        meta = json.loads(body[4 : 4 + jlen])
        off = 4 + jlen
        arrays: Dict[str, np.ndarray] = {}
        for name, dtype, count in meta.pop("arrays", []):
            dt = np.dtype(dtype)
            nbytes = dt.itemsize * int(count)
            if int(count) > MAX_FRAME_RECORDS or off + nbytes > len(body):
                raise ValueError("reply array section out of bounds")
            arrays[str(name)] = np.frombuffer(body, dt, int(count), off)
            off += nbytes
        return ("reply", QueryReply._from_meta(meta, arrays)), 0
    except (ValueError, UnicodeDecodeError, TypeError, KeyError):
        return None, 1


def _v1_body_bound(op: int) -> int:
    if op == OP_INSERT:
        return 4 + 12 * MAX_FRAME_RECORDS
    if op in (OP_QUERY, OP_METRICS):
        return MAX_CONTROL_BYTES
    return MAX_REPLY_BYTES


def _decode_binary_messages(
    buf: bytes, insert_only: bool = False
) -> Tuple[List[Message], bytes, int]:
    """Walk every complete frame in ``buf`` — v0 ``D4MB`` and v1 ``D4MF``
    interleave freely on one connection.

    A bad magic, an unknown version/op, or an implausible length field
    raises ``ValueError`` — unlike one mangled text line, a desynchronized
    binary stream cannot be resynchronized safely.  Frames fully parsed
    *before* the bad one are not lost to TCP coalescing: they are returned
    with the bad frame as ``leftover``, and the next call (which sees the
    bad header first) raises.  ``insert_only`` makes control frames a
    desync error too (the triple-only shim cannot answer a query).
    """
    messages: List[Message] = []
    malformed = 0
    off = 0
    n = len(buf)

    def fail(reason: str) -> bool:
        # salvage the good frames; the next call sees this header first
        if messages:
            return True
        raise ValueError(f"{reason} at offset {off}; binary feed desynchronized")

    while n - off >= _HEADER.size:
        magic = buf[off : off + 4]
        if magic == BINARY_MAGIC:
            # v0: the INSERT op at version 0, parsed bit-identically to the
            # pre-protocol decoder
            _, count = _HEADER.unpack_from(buf, off)
            if count > MAX_FRAME_RECORDS:
                if fail(f"bad frame header (magic={magic!r}, count={count})"):
                    break
            body = 12 * count  # 4B row + 4B col + 4B val per record
            if n - off - _HEADER.size < body:
                break
            start = off + _HEADER.size
            messages.append(
                (
                    "insert",
                    (
                        np.frombuffer(buf, np.int32, count, start),
                        np.frombuffer(buf, np.int32, count, start + 4 * count),
                        np.frombuffer(buf, np.float32, count, start + 8 * count),
                    ),
                )
            )
            off = start + body
            continue
        if magic != FRAME_MAGIC:
            if fail(f"bad frame header (magic={magic!r})"):
                break
        if n - off < _V1_HEADER.size:
            break
        _, version, op, _, body_len = _V1_HEADER.unpack_from(buf, off)
        if (
            version != PROTOCOL_VERSION
            or op not in OP_NAMES
            or body_len > _v1_body_bound(op)
        ):
            if fail(
                f"bad frame header (version={version}, op={op}, "
                f"body_len={body_len})"
            ):
                break
        if insert_only and op != OP_INSERT:
            if fail(f"control frame (op={OP_NAMES[op]}) on an insert-only decoder"):
                break
        if n - off - _V1_HEADER.size < body_len:
            break
        body = buf[off + _V1_HEADER.size : off + _V1_HEADER.size + body_len]
        try:
            msg, bad = _parse_v1_body(op, body)
        except ValueError as e:
            if fail(str(e)):
                break
            raise AssertionError  # fail() always raises or breaks
        malformed += bad
        if msg is not None:
            messages.append(msg)
        off += _V1_HEADER.size + body_len
    return messages, buf[off:], malformed


def decode_binary(buf: bytes) -> Tuple[Records, bytes, int]:
    """Parse every complete insert frame in ``buf`` (triple-only shim over
    the op-coded decoder); returns like :func:`decode_text`.

    Accepts both v0 ``D4MB`` and v1 ``D4MF`` INSERT frames; a control
    frame (query/reply) is a desync error here — an insert-only consumer
    has no way to answer it.
    """
    messages, leftover, malformed = _decode_binary_messages(
        buf, insert_only=True
    )
    if not messages:
        return _empty(), leftover, malformed
    triples = [m[1] for m in messages]
    return (
        (
            np.concatenate([t[0] for t in triples]),
            np.concatenate([t[1] for t in triples]),
            np.concatenate([t[2] for t in triples]),
        ),
        leftover,
        malformed,
    )


def decode_messages(
    buf: bytes, encoding: str = "binary"
) -> Tuple[List[Message], bytes, int]:
    """Parse every complete message in ``buf`` under the op-coded protocol.

    Returns ``(messages, leftover, malformed)``; each message is
    ``("insert", (rows, cols, vals))``, ``("query", QueryRequest)`` or
    ``("reply", QueryReply)``, in arrival order.
    """
    if encoding == "text":
        return _decode_text_messages(buf)
    if encoding == "binary":
        return _decode_binary_messages(buf)
    raise ValueError(f"encoding must be one of {ENCODINGS}, got {encoding!r}")


def encode(rows, cols, vals, encoding: str = "text") -> bytes:
    if encoding == "text":
        return encode_text(rows, cols, vals)
    if encoding == "binary":
        return encode_binary(rows, cols, vals)
    raise ValueError(f"encoding must be one of {ENCODINGS}, got {encoding!r}")


def decoder_for(encoding: str):
    if encoding == "text":
        return decode_text
    if encoding == "binary":
        return decode_binary
    raise ValueError(f"encoding must be one of {ENCODINGS}, got {encoding!r}")


def timed_decoder(decode, record_ns):
    """Wrap any decode callable so each call's wall time (perf_counter_ns
    delta) is fed to ``record_ns`` — how a source instruments its decode
    path without the decoder itself knowing about metrics.  Only installed
    when observability is on; the disabled path keeps the bare decoder."""
    import time

    def timed(*a, **kw):
        t0 = time.perf_counter_ns()
        try:
            return decode(*a, **kw)
        finally:
            record_ns(time.perf_counter_ns() - t0)

    return timed


# ---------------------------------------------------------------------------
# loopback client
# ---------------------------------------------------------------------------

def send_triples(
    host: str,
    port: int,
    rows,
    cols,
    vals,
    encoding: str = "text",
    chunk_records: int = 4096,
    timeout_s: float = 30.0,
    retry=None,
    faults=None,
) -> int:
    """Stream a triple batch to a :class:`~repro_torch.serve.sources.TCPSource`.

    Splits into ``chunk_records``-sized sends so the receiver interleaves
    parsing with the transfer; returns the number of records *fully sent*.
    The write path inherits TCP flow control, which is how the server's
    ``"block"`` backpressure policy ultimately reaches the producer.

    The connect is retried under ``retry`` (a
    :class:`repro_torch.faults.RetryPolicy`; the default survives a worker that
    bound its ephemeral port but is not listening yet — previously every
    caller hand-rolled a sleep loop around the first ``ECONNREFUSED``).
    Pass ``retry=False`` to fail on the first error.

    ``faults`` (a :class:`repro_torch.faults.FaultPlan`) drives the
    ``wire.truncate_frame`` site: when it fires, half of one chunk's
    encoded bytes are written and the connection is closed — the shape of
    a producer dying mid-frame.  The return value counts only records
    whose bytes were fully handed to the kernel, so the caller's ledger
    stays exact.
    """
    from repro_torch.faults import FaultPlan, RetryPolicy

    if retry is None:
        retry = RetryPolicy(deadline_s=timeout_s)
    if faults is None:
        faults = FaultPlan.from_env()
    rows = np.asarray(rows).ravel()
    cols = np.asarray(cols).ravel()
    vals = np.asarray(vals).ravel()
    n = rows.shape[0]

    def _connect() -> socket.socket:
        return socket.create_connection((host, port), timeout=timeout_s)

    sock = _connect() if retry is False else retry.call(
        _connect, retry_on=(ConnectionError, socket.timeout, OSError)
    )
    sent = 0
    with sock:
        for lo in range(0, n, chunk_records):
            hi = min(lo + chunk_records, n)
            payload = encode(rows[lo:hi], cols[lo:hi], vals[lo:hi], encoding)
            if faults is not None:
                spec = faults.fire("wire.truncate_frame", cursor=sent)
                if spec is not None:
                    cut = int(spec.args.get("keep_bytes", len(payload) // 2))
                    sock.sendall(payload[:max(0, cut)])
                    return sent  # these records were NOT fully sent
            sock.sendall(payload)
            sent = hi
    return int(sent)
