"""Backpressured microbatch router: record chunks -> per-instance batches.

Port of ``repro.serve.router``: :func:`route_numpy` mirrors the port's
:func:`repro_torch.core.multistream.route_to_instances`, and the reference's
:func:`route_numpy` too, bit for bit.

Two layers:

* :func:`route_numpy` — a host-side, bit-exact mirror of the device router
  :func:`repro_torch.core.multistream.route_to_instances` (same murmur-style key
  hash, same stable sort-scatter, same PAD layout).  Routing on the host
  keeps the device free for ``update`` dispatches and lets the batching
  thread overlap with device compute; the mirror property is what makes a
  served stream bit-identical to the offline pre-routed path (proven in
  ``tests/serve/test_router.py``).
* :class:`MicrobatchRouter` — accumulates pushed record chunks into *global*
  microbatches of exactly ``max_batch`` records (arrival order), routes each
  to the K x D instance grid, and hands them to the feed loop through a
  bounded queue.  Flush policy: a batch flushes when full, when its oldest
  record has waited ``max_latency_ms`` (partial, PAD-padded), or at drain.
  Backpressure when the queue is full: ``"block"`` stalls the producer
  (lossless), ``"drop"`` discards the newest batch and counts every lost
  record — drops are surfaced, never silent.

Threading contract: one producer thread calls :meth:`MicrobatchRouter.push`
/ :meth:`close`; one consumer thread calls :meth:`pop` and (only when a pop
timed out) :meth:`flush_if_stale`.  The producer may block on the queue
while holding the router lock, so the consumer is wait-free by
construction: :meth:`pop` never touches the lock, and
:meth:`flush_if_stale` only try-acquires it (giving up if the producer
holds it) and only flushes when the queue has room — it never blocks on
either the lock or the queue.  Whenever the producer blocks, the queue is
full, so the consumer's next pop succeeds and unwinds it.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.assoc import PAD

# the device router's own hash constants: a retune of multistream.instance_of
# reaches the host mirror mechanically, not via a parity-test failure
from repro_torch.core.multistream import _H1, _H2, _M1, _M2

_H1, _H2, _M1, _M2 = (np.uint32(h) for h in (_H1, _H2, _M1, _M2))

DRAIN = object()  # end-of-stream sentinel yielded by pop() exactly once


def key_hash32_numpy(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Host mirror of :func:`repro_torch.core.multistream.key_hash32` — the one
    finalized uint32 hash both routing tiers consume: the instance tier
    takes it modulo K (:func:`instance_of_numpy`), the fleet host tier
    takes its top bits (:func:`repro_torch.fleet.routing.route_host`)."""
    with np.errstate(over="ignore"):
        x = rows.astype(np.uint32) * _H1 + cols.astype(np.uint32) * _H2
        x = x ^ (x >> np.uint32(16))
        x = x * _M1
        x = x ^ (x >> np.uint32(15))
        x = x * _M2
        x = x ^ (x >> np.uint32(16))
        return x


def instance_of_numpy(rows: np.ndarray, cols: np.ndarray, n_instances: int) -> np.ndarray:
    """Host mirror of :func:`repro_torch.core.multistream.instance_of`."""
    with np.errstate(over="ignore"):
        x = key_hash32_numpy(rows, cols)
        return (x % np.uint32(n_instances)).astype(np.int32)


def route_numpy(
    rows: np.ndarray,  # [B] int32, PAD = dead slot
    cols: np.ndarray,
    vals: np.ndarray,
    n_instances: int,
    slot_cap: int,
    zero: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host mirror of :func:`repro_torch.core.multistream.route_to_instances`.

    Returns ``(rows, cols, vals, dropped)`` with ``[n_instances, slot_cap]``
    shapes, bit-identical to the device router on the same batch.
    """
    live = rows != PAD
    owner = np.where(live, instance_of_numpy(rows, cols, n_instances), n_instances)
    order = np.argsort(owner, kind="stable")
    owner_s = owner[order]
    start = np.searchsorted(owner_s, owner_s, side="left")
    rank = np.arange(rows.shape[0], dtype=np.int64) - start
    live_s = live[order]
    dropped = int(np.sum((rank >= slot_cap) & live_s))
    keep = (rank < slot_cap) & live_s
    out_r = np.full((n_instances * slot_cap,), PAD, np.int32)
    out_c = np.full((n_instances * slot_cap,), PAD, np.int32)
    out_v = np.full((n_instances * slot_cap,), zero, vals.dtype)
    slot = (owner_s * slot_cap + rank)[keep]
    out_r[slot] = rows[order][keep]
    out_c[slot] = cols[order][keep]
    out_v[slot] = vals[order][keep]
    shape = (n_instances, slot_cap)
    return (
        out_r.reshape(shape),
        out_c.reshape(shape),
        out_v.reshape(shape),
        dropped,
    )


class MicrobatchRouter:
    """See the module docstring for the design and threading contract.

    ``n_instances=None`` is the single-engine mode: global microbatches are
    emitted flat (``[max_batch]``, PAD-padded) without hash routing —
    exactly the shape ``D4MStream.update`` takes at K=1.
    """

    def __init__(
        self,
        n_instances: Optional[int],
        slot_cap: int,
        max_batch: Optional[int] = None,
        max_latency_ms: float = 50.0,
        queue_depth: int = 8,
        backpressure: str = "block",
        zero: float = 0.0,
        val_dtype=np.float32,
        metrics=None,
    ):
        if n_instances is not None and n_instances < 1:
            raise ValueError(f"n_instances must be >= 1, got {n_instances}")
        if slot_cap < 1:
            raise ValueError(f"slot_cap must be >= 1, got {slot_cap}")
        self.n_instances = n_instances
        self.slot_cap = int(slot_cap)
        self.max_batch = int(max_batch) if max_batch is not None else self.slot_cap
        if not 1 <= self.max_batch <= self.slot_cap:
            raise ValueError(
                f"max_batch must be in [1, slot_cap={self.slot_cap}], "
                f"got {self.max_batch}"
            )
        if backpressure not in ("block", "drop"):
            raise ValueError(f"unknown backpressure policy {backpressure!r}")
        self.max_latency_ms = float(max_latency_ms)
        self.backpressure = backpressure
        self.zero = zero
        self.val_dtype = np.dtype(val_dtype)
        self._q: "queue.Queue" = queue.Queue(maxsize=int(queue_depth))
        self._lock = threading.Lock()
        self._pend: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._pend_count = 0
        self._oldest_ts: Optional[float] = None
        self._closed = False
        # counters (GIL-atomic int updates under the lock; read lock-free)
        self.records_in = 0
        self.batches_out = 0
        self.records_out = 0  # live records in flushed batches
        self.dropped_records = 0  # lost to the "drop" policy or an abort
        self.dropped_batches = 0
        self.routing_dropped = 0  # slot-overflow drops (0 by construction
        #                           while max_batch <= slot_cap)
        self.blocked_events = 0  # producer stalls under the "block" policy
        # observability (repro_torch.obs): handles are resolved ONCE here, so
        # every hot-path site below is a single `is not None` check when
        # metrics are off — the faults-plane zero-overhead contract
        if metrics is None:
            self._h_flush = self._h_wait = self._g_depth = None
        else:
            self._h_flush = metrics.histogram("router.flush_ns")
            self._h_wait = metrics.histogram("router.enqueue_wait_ns")
            self._g_depth = metrics.gauge("router.queue_depth")

    # -- producer side -------------------------------------------------------
    def push(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> None:
        rows = np.asarray(rows, np.int32).ravel()
        cols = np.asarray(cols, np.int32).ravel()
        vals = np.asarray(vals, self.val_dtype).ravel()
        if rows.shape[0] == 0:
            return
        with self._lock:
            if self._closed:
                raise RuntimeError("push() after close()")
            self.records_in += int(rows.shape[0])
            if self._pend_count == 0:
                self._oldest_ts = time.monotonic()
            self._pend.append((rows, cols, vals))
            self._pend_count += int(rows.shape[0])
            while self._pend_count >= self.max_batch:
                self._flush_locked(partial=False)

    def close(self, drain: bool = True) -> None:
        """No more pushes.  ``drain=True`` flushes the pending residue
        (PAD-padded partial batch); ``drain=False`` discards it.  Always
        enqueues the DRAIN sentinel so the consumer terminates."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if drain:
                while self._pend_count > 0:
                    self._flush_locked(partial=True)
            else:
                # abort: the unbatched residue is discarded — counted,
                # never silent, so abort-path accounting stays exact
                self.dropped_records += self._pend_count
                self._pend.clear()
                self._pend_count = 0
            self._q.put(DRAIN)  # never dropped, whatever the policy

    # -- consumer side -------------------------------------------------------
    def pop(self, timeout: float):
        """Next routed batch, :data:`DRAIN`, or ``None`` on timeout.

        Batches are ``(rows, cols, vals, n_live)`` — ``[K, slot_cap]``
        instance-major (or ``[max_batch]`` flat in single mode)."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def flush_if_stale(self) -> bool:
        """Latency flush: emit the pending partial batch if its oldest
        record has waited longer than ``max_latency_ms``.  Call only from
        the consumer thread after a timed-out pop (see threading contract).

        Never blocks.  A blocking lock acquire here can deadlock: the
        producer does its blocking enqueue while holding the lock, and one
        large push can fill the queue and stall on put between the
        consumer's pop timeout and its lock acquire — producer waiting for
        a pop the lock-blocked consumer can never perform.  So this only
        try-acquires, and bails if the queue is full (a blocking put from
        the consumer with the lock held would strand the producer on the
        lock with nobody popping).  Both bail-outs are safe to skip: they
        mean batches are in flight, so the next pop succeeds and the stale
        residue is retried on the next timeout.
        """
        if not self._lock.acquire(blocking=False):
            return False  # producer mid-push; it is making progress
        try:
            if self._closed or self._pend_count == 0 or self._oldest_ts is None:
                return False
            if (time.monotonic() - self._oldest_ts) * 1e3 < self.max_latency_ms:
                return False
            if self._q.full():
                return False  # batches queued; flush on a later timeout
            self._flush_locked(partial=True)
            return True
        finally:
            self._lock.release()

    @property
    def pending(self) -> int:
        return self._pend_count

    @property
    def depth(self) -> int:
        return self._q.qsize()

    def counters(self) -> dict:
        return {
            "records_in": self.records_in,
            "records_out": self.records_out,
            "batches_out": self.batches_out,
            "dropped_records": self.dropped_records,
            "dropped_batches": self.dropped_batches,
            "routing_dropped": self.routing_dropped,
            "blocked_events": self.blocked_events,
            "queue_depth": self.depth,
            "pending": self.pending,
        }

    # -- internals -----------------------------------------------------------
    def _flush_locked(self, partial: bool) -> None:
        if self._h_flush is None:
            self._flush_impl(partial)
            return
        t0 = time.perf_counter_ns()
        try:
            self._flush_impl(partial)
        finally:
            self._h_flush.record(time.perf_counter_ns() - t0)

    def _flush_impl(self, partial: bool) -> None:
        take = self.max_batch if not partial else min(self._pend_count, self.max_batch)
        rows = np.full((self.max_batch,), PAD, np.int32)
        cols = np.full((self.max_batch,), PAD, np.int32)
        vals = np.full((self.max_batch,), self.zero, self.val_dtype)
        filled = 0
        while filled < take:
            r, c, v = self._pend[0]
            n = min(r.shape[0], take - filled)
            rows[filled : filled + n] = r[:n]
            cols[filled : filled + n] = c[:n]
            vals[filled : filled + n] = v[:n]
            filled += n
            if n == r.shape[0]:
                self._pend.pop(0)
            else:
                self._pend[0] = (r[n:], c[n:], v[n:])
        self._pend_count -= take
        self._oldest_ts = time.monotonic() if self._pend_count else None
        if self.n_instances is None:
            item = (rows, cols, vals, take)
        else:
            br, bc, bv, rdrop = route_numpy(
                rows, cols, vals, self.n_instances, self.slot_cap, self.zero
            )
            self.routing_dropped += rdrop
            item = (br, bc, bv, take - rdrop)
        self._enqueue(item)

    def _enqueue(self, item) -> None:
        try:
            self._q.put_nowait(item)
        except queue.Full:
            if self.backpressure == "drop":
                self.dropped_batches += 1
                self.dropped_records += int(item[3])
                return
            self.blocked_events += 1
            if self._h_wait is None:
                self._q.put(item)  # lossless: stall the producer
            else:
                t0 = time.perf_counter_ns()
                self._q.put(item)
                self._h_wait.record(time.perf_counter_ns() - t0)
        self.batches_out += 1
        self.records_out += int(item[3])
        if self._g_depth is not None:
            self._g_depth.set(self._q.qsize())
