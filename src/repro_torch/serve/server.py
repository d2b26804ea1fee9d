"""The serve loop: sources -> router -> engine updates, with graceful drain.

Port of ``repro.serve.server``.

:class:`D4MServer` turns a :class:`repro_torch.d4m.D4MStream` from a pull-style
library into a served system.  Three concurrent stages:

* the **reader thread** drains ``source.chunks()`` into the
  :class:`~repro_torch.serve.router.MicrobatchRouter` (parse + host-side hash
  routing happen here, off the device path);
* the **feed thread** pops routed microbatches, copies each from a ring of
  pinned host buffers to the card (``non_blocking=True``) and dispatches
  engine ``update`` steps.  CUDA launches are asynchronous, so the loop is
  double-buffered: while the card executes batch *t*, the host is already
  parsing/routing batch *t+1* and dispatching *t+2*; the feed loop waits
  for the card only at checkpoints (the host copy of the state), at
  publications that read a counter, and at drain.  On the CPU every step
  runs synchronously;
* the caller's thread reads :meth:`telemetry` (host counters only — it
  never touches the donated device state while updates are in flight).

Shutdown is a graceful drain by default: stop the source, flush the
router's residue (PAD-padded partial batch), feed everything queued, sync
the device, take a final checkpoint when checkpointing is configured, and
return a :class:`ServeReport`.  ``stop(drain=False)`` aborts instead —
queued batches are discarded (counted, never silent) and the state is left
at the last completed update, which is exactly what the checkpoint/restore
replay test recovers from.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.telemetry import TelemetrySnapshot
from repro_torch.d4m.config import ServeConfig

from .query import host_dtype
from .router import DRAIN, MicrobatchRouter
from .sources import Source


class HostStaging:
    """The feed loop's host-to-card copies, through a ring of pinned host
    buffers (one set of rows/cols/vals per slot).

    :meth:`put` fills the next slot's pinned buffers from the routed numpy
    batch, starts its copies to the card with ``non_blocking=True`` on the
    current stream and records an event behind them.  A slot is refilled
    only after its event has completed, so no pinned buffer is overwritten
    while its copy may still be in flight.  On the CPU :meth:`put` returns
    owned tensor copies.
    """

    SLOTS = 3  # the card copies one batch while the host fills the next

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._slots: List[Optional[list]] = [None] * self.SLOTS
        self._next = 0

    def put(self, *arrays: np.ndarray):
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.device.type != "cuda":
            return tuple(t.clone() for t in host)
        i = self._next
        self._next = (i + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is None or any(
            b.shape != t.shape or b.dtype != t.dtype for b, t in zip(slot[0], host)
        ):
            if slot is not None:
                slot[1].synchronize()
            slot = [[torch.empty_like(t, pin_memory=True) for t in host], None]
            self._slots[i] = slot
        elif slot[1] is not None:
            slot[1].synchronize()  # this slot's last copy has left the buffers
        for buf, t in zip(slot[0], host):
            buf.copy_(t)
        out = tuple(buf.to(self.device, non_blocking=True) for buf in slot[0])
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        slot[1] = ev
        return out


@dataclasses.dataclass
class ServeReport:
    """Outcome of one serve run (final counters; see ``telemetry`` for the
    full :class:`~repro_torch.core.telemetry.TelemetrySnapshot`, including the
    session's device-side counters nested under ``.session`` post-drain)."""

    drained: bool
    records_in: int
    records_fed: int
    batches_fed: int
    records_dropped: int
    blocked_events: int
    malformed: int
    wall_s: float
    ingest_rate: float
    checkpoints: List[Dict[str, int]]
    telemetry: TelemetrySnapshot


class D4MServer:
    """Serve one source into one session.  See the module docstring.

    The session must be exclusively owned by the server while it runs: the
    engine updates its state in place, so no other thread may touch
    ``session.state`` (including snapshots/telemetry) until the server
    stops.  Published views are the only state other threads read.
    """

    def __init__(self, session, source: Source, config: ServeConfig | None = None):
        self.session = session
        self.source = source
        self.config = (config or ServeConfig()).validate()
        # Fault plan resolution: an explicit config plan wins; otherwise the
        # environment (how fleet workers inherit the controller's plan).
        # One instance is shared with the source and the session's
        # checkpoint manager so in-process chaos tests see every fire in a
        # single summary().
        if self.config.faults is not None:
            self._faults = self.config.faults
        else:
            from repro_torch.faults import FaultPlan

            self._faults = FaultPlan.from_env()
        if self._faults is not None:
            if hasattr(self.source, "set_faults"):
                self.source.set_faults(self._faults)
            if session._ckpt_dir is not None:
                session._manager().set_faults(self._faults)
        # Observability resolution mirrors faults: explicit config wins
        # (True arms, False forces off), otherwise the REPRO_OBS environment
        # variable (how fleet workers inherit the controller's choice).  Off
        # means every site below holds None and costs one `is not None`.
        from repro_torch.obs import MetricsRegistry, TraceRing

        if self.config.metrics is not None:
            self._metrics = MetricsRegistry() if self.config.metrics else None
        else:
            self._metrics = MetricsRegistry.from_env()
        if self._metrics is not None:
            self._h_dispatch = self._metrics.histogram("serve.update_dispatch_ns")
            self._h_publish = self._metrics.histogram("serve.publish_ns")
            self.trace = TraceRing()
            self._trace_worker = os.environ.get("REPRO_FAULTS_WORKER")
            if hasattr(self.source, "set_metrics"):
                self.source.set_metrics(self._metrics)
            session._obs = self._metrics.histogram("session.view_build_ns")
        else:
            self._h_dispatch = self._h_publish = None
            self.trace = None
            self._trace_worker = None
            session._obs = None  # a prior metrics-on serve must not linger
        if (
            self.config.max_batch is not None
            and self.config.max_batch > session.batch_size
        ):
            raise ValueError(
                f"max_batch ({self.config.max_batch}) exceeds the session "
                f"batch_size ({session.batch_size}) — the routing slot capacity"
            )
        if self.config.checkpoint_every is not None and session._ckpt_dir is None:
            raise ValueError(
                "checkpoint_every is set but the session has no checkpoint_dir"
            )
        self.router = MicrobatchRouter(
            None if session.kind == "single" else session.n_instances,
            slot_cap=session.batch_size,
            max_batch=self.config.max_batch,
            max_latency_ms=self.config.max_latency_ms,
            queue_depth=self.config.queue_depth,
            backpressure=self.config.backpressure,
            zero=session.sr.zero_as(session.dtype),
            val_dtype=host_dtype(session.dtype),
            metrics=self._metrics,
        )
        # the online query plane (ServeConfig.publish_every): an immutable
        # StreamView is published at microbatch boundaries; the source's
        # reader thread answers query frames against it, so one socket
        # serves inserts and queries without the readers ever touching the
        # donated device state this feed loop mutates
        self._publish_every = self.config.publish_every
        self._tracker = None
        self._executor = None
        if self._publish_every is not None:
            from .query import DegreeTracker, QueryExecutor

            if self.config.track_degrees:
                tracker = DegreeTracker(session.sr, session.dtype)
                self._tracker = tracker if tracker.supported else None
            self._executor = QueryExecutor(session, server=self)
            if hasattr(self.source, "set_query_handler"):
                self.source.set_query_handler(self._executor.execute)
        self.views_published = 0
        self._staging = HostStaging(session.device)
        self._reader: Optional[threading.Thread] = None
        self._feeder: Optional[threading.Thread] = None
        self._abort = threading.Event()
        self._started = False
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None
        self.batches_fed = 0
        self.records_fed = 0
        self.records_discarded = 0  # queued batches thrown away by an abort
        self.checkpoints: List[Dict[str, int]] = []
        self._drained = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "D4MServer":
        if self._started:
            return self
        self._started = True
        self.session._serving = True
        if self._tracker is not None and self.session.nnz():
            # warm start (restored checkpoint / pre-ingested session): the
            # incremental fold must begin from the existing state's degree
            # reduction, or every published view would under-count the
            # records that precede this serve
            from repro_torch.core import analytics

            self._tracker.seed(
                *analytics.degrees(
                    self.session.snapshot(),
                    cap=self.session.plan.snapshot_cap,
                    sr=self.session.sr,
                )
            )
        if self._publish_every is not None:
            # publish the (possibly empty) starting view so queries racing
            # the first microbatch get a well-defined answer, not an error
            self._publish()
        self.source.start()
        self._t0 = time.monotonic()
        self._reader = threading.Thread(
            target=self._read_loop, name="d4m-serve-reader", daemon=True
        )
        self._feeder = threading.Thread(
            target=self._feed_loop, name="d4m-serve-feeder", daemon=True
        )
        self._reader.start()
        self._feeder.start()
        return self

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the stream to end and the drain to complete."""
        done = self._done.wait(timeout)
        if done:
            self._reader.join()
            self._feeder.join()
            if self._error is not None:
                err, self._error = self._error, None
                raise err
        return done

    def run(self, timeout: Optional[float] = None) -> ServeReport:
        """Start, serve to exhaustion, drain, and report (the blocking
        convenience wrapper ``D4MStream.serve`` uses)."""
        self.start()
        if not self.join(timeout):
            self.stop(drain=True)
        return self.report()

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop serving.  ``drain=True`` feeds everything already received;
        ``drain=False`` aborts after the in-flight update."""
        if not self._started:
            return
        if not drain:
            self._abort.set()
        self.source.stop()
        self.join(
            timeout if timeout is not None else self.config.drain_timeout_s
        )

    # -- the two loops -------------------------------------------------------
    def _read_loop(self) -> None:
        try:
            for rows, cols, vals in self.source.chunks():
                if self._abort.is_set():
                    break
                self.router.push(rows, cols, vals)
        except BaseException as e:  # pragma: no cover - surfaced via join()
            self._error = self._error or e
        finally:
            self.router.close(drain=not self._abort.is_set())

    def _feed_loop(self) -> None:
        from repro_torch.obs import torch_profile

        with torch_profile(self.config.profile_dir):
            self._feed_loop_impl()

    def _feed_loop_impl(self) -> None:
        in_flight = None  # popped batch not yet counted fed (error account)
        try:
            while True:
                item = self.router.pop(timeout=self.config.poll_interval_s)
                if item is DRAIN:
                    break
                if item is None:
                    self.router.flush_if_stale()
                    continue
                if self._abort.is_set():
                    self.records_discarded += int(item[3])
                    continue  # keep popping so a blocked producer unwinds
                rows, cols, vals, live = item
                in_flight = item
                if self._faults is not None:
                    spec = self._faults.fire(
                        "router.slow_consumer", cursor=self.batches_fed
                    )
                    if spec is not None:
                        # a consumer that can't keep up: the bounded queue
                        # fills behind us and the backpressure policy
                        # (block/drop) engages upstream
                        time.sleep(float(spec.args.get("seconds", 0.05)))
                if self._h_dispatch is None:
                    self._dispatch(rows, cols, vals)
                else:
                    t0 = time.perf_counter_ns()
                    self._dispatch(rows, cols, vals)
                    t1 = time.perf_counter_ns()
                    self._h_dispatch.record(t1 - t0)
                    self.trace.append(
                        "update", t0, t1, batch=int(live),
                        worker=self._trace_worker,
                    )
                self.batches_fed += 1
                self.records_fed += int(live)
                in_flight = None
                if self._tracker is not None:
                    # fold this microbatch's degrees on the host while the
                    # device chews the dispatched update (rows/cols/vals
                    # are the routed numpy arrays, PAD-masked inside)
                    self._tracker.feed(rows, cols, vals)
                if self._faults is not None:
                    spec = self._faults.fire(
                        "worker.crash_after_n_batches", cursor=self.batches_fed
                    )
                    if spec is not None:
                        # SIGKILL shape: no unwind, no final checkpoint —
                        # only a durable earlier generation + journal
                        # replay can recover this worker
                        os._exit(int(spec.args.get("exit_code", 137)))
                every = self.config.checkpoint_every
                if every is not None and self.batches_fed % every == 0:
                    self._checkpoint()
                if (
                    self._publish_every is not None
                    and self.batches_fed % self._publish_every == 0
                ):
                    self._publish()
            if not self._abort.is_set():
                self._drained = True
            self.session.synchronize()
            self._t1 = time.monotonic()
            if self._publish_every is not None and self._drained:
                # the drain boundary is a microbatch boundary: publish the
                # final view so post-drain queries see every fed record
                self._publish()
            if self.config.checkpoint_every is not None:
                if self._drained:
                    self._checkpoint(final=True)
                else:
                    # aborted: no new checkpoint, but let the last async
                    # save publish so a restart sees it
                    self.session.wait_checkpoint()
        except BaseException as e:
            self._error = self._error or e
            self._t1 = self._t1 or time.monotonic()
            if in_flight is not None:
                # the batch whose dispatch raised: popped, never applied
                self.records_discarded += int(in_flight[3])
            # unwind the producer side: stop the source and keep draining the
            # queue until the reader has published DRAIN — a blocked push (or
            # a throttled source's quiet gap) must not strand the reader, or
            # the subsequent join() would hang instead of raising the error
            self._abort.set()
            try:
                self.source.stop()
            except Exception:
                pass
            while True:
                item = self.router.pop(timeout=0.2)
                if item is DRAIN:
                    break
                if item is not None:
                    # counted, never silent: these batches were routed but
                    # will never be fed
                    self.records_discarded += int(item[3])
                    continue
                if not (self._reader is not None and self._reader.is_alive()):
                    break  # reader already gone; nothing more can arrive
        finally:
            # state is quiescent again: sess.query falls back to library
            # binding (the published views stay answerable either way)
            self.session._serving = False
            self._done.set()

    def _dispatch(self, rows, cols, vals) -> None:
        s = self.session
        rows, cols, vals = s.shard_stream(*self._staging.put(rows, cols, vals))
        s.update(rows, cols, vals)

    def _publish(self) -> None:
        """Publish an immutable StreamView at a microbatch boundary.

        Runs on whichever thread owns the state at that moment (start():
        the caller; afterwards: only the feed loop between dispatches), so
        the snapshot program is ordered after every dispatched update and
        the view holds exactly ``records_fed`` source records.  The
        tracker's degree vectors are lifted and seeded into the view so
        degrees/top_k queries never re-reduce the snapshot.
        """
        cap = self.config.publish_cap
        degrees = None
        if self._tracker is not None:
            from repro_torch.core import analytics

            out_ids, out_vals, in_ids, in_vals = self._tracker.arrays()
            degrees = analytics.degrees_from_vectors(
                out_ids,
                out_vals,
                in_ids,
                in_vals,
                cap if cap is not None else self.session.plan.snapshot_cap,
                self.session.sr,
                self.session.dtype,
                device=self.session.device,
            )
        if self._h_publish is None:
            self.session.view(
                cap, records=self.records_fed, degrees=degrees, publish=True
            )
        else:
            t0 = time.perf_counter_ns()
            self.session.view(
                cap, records=self.records_fed, degrees=degrees, publish=True
            )
            t1 = time.perf_counter_ns()
            self._h_publish.record(t1 - t0)
            self.trace.append(
                "publish", t0, t1, records=int(self.records_fed),
                worker=self._trace_worker,
            )
        self.views_published += 1

    def _checkpoint(self, final: bool = False) -> None:
        # save_async's device->host copy is queued on this thread's stream
        # behind every dispatched update and waited for, so the cursor is
        # exact: records_fed source records are in the saved state
        cursor = self.records_fed
        self.session.checkpoint(
            step=self.batches_fed,
            extra={
                "cursor": int(cursor),
                "batches_fed": int(self.batches_fed),
                "final": bool(final),
            },
        )
        self.checkpoints.append({"step": self.batches_fed, "cursor": int(cursor)})
        if final:
            self.session.wait_checkpoint()

    # -- observability -------------------------------------------------------
    def telemetry(self) -> TelemetrySnapshot:
        """Live host-side counters; safe to call from any thread while the
        server runs (never touches the donated device state).

        Returns a typed :class:`~repro_torch.core.telemetry.TelemetrySnapshot`
        carrying only the serve-loop fields — the device-side state
        counters stay ``None`` here (reading them would race the donated
        buffers); :meth:`report` nests a full state snapshot once the feed
        loop is quiescent.
        """
        now = self._t1 or time.monotonic()
        wall = max(now - self._t0, 1e-9) if self._t0 is not None else 0.0
        c = self.router.counters()
        snap = TelemetrySnapshot(
            engine=self.session.kind,
            n_instances=self.session.n_instances,
            records_in=c["records_in"],
            records_fed=self.records_fed,
            batches_fed=self.batches_fed,
            records_dropped=c["dropped_records"] + self.records_discarded,
            routing_dropped=c["routing_dropped"],
            blocked_events=c["blocked_events"],
            queue_depth=c["queue_depth"],
            pending=c["pending"],
            malformed=getattr(self.source, "malformed", 0),
            source_records=getattr(self.source, "records_out", 0),
            wall_s=wall,
            ingest_rate=self.records_fed / wall if wall else 0.0,
            checkpoints=list(self.checkpoints),
            drained=self._drained,
        )
        if self._publish_every is not None:
            snap.views_published = self.views_published
            snap.queries_served = (
                self._executor.queries_served
                if self._executor is not None
                else 0
            )
            view = self.session.latest_view()
            if view is not None:
                snap.view_seq = int(view.seq)
                snap.view_staleness_records = max(
                    0, self.records_fed - int(view.records or 0)
                )
        if self._metrics is not None:
            snap.histograms = self._metrics.dump()["histograms"]
        return snap

    @property
    def metrics(self):
        """The live :class:`~repro_torch.obs.MetricsRegistry`, or ``None`` when
        observability is off."""
        return self._metrics

    def metrics_dump(self) -> Optional[Dict]:
        """JSON-ready registry dump (``None`` when observability is off) —
        what a fleet worker piggybacks on its control-channel telemetry."""
        return None if self._metrics is None else self._metrics.dump()

    def report(self) -> ServeReport:
        """Final report; call after :meth:`join`/:meth:`run`/:meth:`stop`.
        Includes the session's device-side counters (nnz, cascades) — the
        state is quiescent once the feed loop has exited."""
        if not self._done.is_set():
            raise RuntimeError("report() before the server finished; join() first")
        tel = self.telemetry()
        tel.session = self.session.telemetry()
        return ServeReport(
            drained=self._drained,
            records_in=tel.records_in,
            records_fed=self.records_fed,
            batches_fed=self.batches_fed,
            records_dropped=tel.records_dropped,
            blocked_events=tel.blocked_events,
            malformed=tel.malformed,
            wall_s=tel.wall_s,
            ingest_rate=tel.ingest_rate,
            checkpoints=list(self.checkpoints),
            telemetry=tel,
        )
