"""Fleet controller: spawn, feed, supervise, and aggregate N workers (port
of ``repro.fleet.controller``).

:class:`FleetController` is the outer tier of the paper's architecture —
the piece that turns "one served session" into "many independent stores
composed by routing" (arXiv 1902.00846).  One box, N subprocesses is the
first leg: on one card the N workers each hold a CUDA context and share
the device by time-slicing.  The control/data-plane split below is the
multi-host shape, so nothing here assumes shared memory — workers are
reached only through sockets.

The fleet runs on the card unless it is given ``device="cpu"``: the
controller resolves the device before it spawns anything (no CUDA and no
``device="cpu"`` raises), builds the kernels once for all workers, and
names the device in every worker's plan.

Planes:

* **control plane** — one TCP listener; each worker connects back, sends
  ``attach``, receives its ``plan`` (the ``StreamConfig`` wire form +
  serve knobs + checkpoint/restore directive), then streams ``hello`` /
  ``telemetry`` / ``checkpoint`` / ``report`` / ``error`` messages as
  newline-delimited JSON.
* **data plane** — one TCP connection per worker into that worker's
  :class:`~repro_torch.serve.TCPSource`, carrying the framed binary wire format.
  Closing it is the drain signal: FIN arrives strictly after the last
  frame, so the worker ingests everything, then drains — lossless shutdown
  without any in-band sentinel.

Fault tolerance — the journal/cursor contract:

* every record is appended to its owner's **journal** *before* it is
  written to the data socket, so no failure mode can lose a record that
  the fleet has accepted;
* a worker's ``checkpoint`` notice carries the *global* cursor of a
  checkpoint that is durably on disk; only then is the journal trimmed
  below that cursor — the journal always covers everything a restart
  could need to replay;
* on worker death (``SIGKILL``, crash, socket error) the controller
  respawns it pointed at the last acknowledged checkpoint (each
  incarnation checkpoints into a fresh generation directory, so step
  numbers never collide), waits for ``hello`` to confirm the restored
  cursor matches, and replays the journal from that record on — records
  the dead incarnation ingested but never durably checkpointed are
  re-fed, records it checkpointed are not: cursor-exact, no loss, no
  double-fold.

Aggregation: per-worker ``TelemetrySnapshot``s are summed with
:meth:`~repro_torch.core.telemetry.TelemetrySnapshot.merge` (which refuses mixed
schema versions), with the conservation checks ``fleet records_in ==
Σ fed + Σ dropped`` and ``Σ delivered == Σ journaled`` exposed on the
:class:`FleetReport`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.telemetry import TelemetrySnapshot
from repro_torch.d4m.config import ServeConfig, StreamConfig
from repro_torch.device import resolve_device
from repro_torch.faults import (
    ENV_VAR,
    GENERATION_ENV_VAR,
    WORKER_ENV_VAR,
    FaultPlan,
    RetryPolicy,
)
from repro_torch.runtime.elastic import Heartbeat
from repro_torch.serve import wire

from .routing import host_key_range, split_by_host

_TEL_FIELDS = {f.name for f in dataclasses.fields(TelemetrySnapshot)}


def _tel_from_json(d: Dict[str, Any]) -> TelemetrySnapshot:
    """Rebuild a snapshot from ``TelemetrySnapshot.to_json()`` wire form
    (unknown keys were flattened extras — they go back into ``extras``)."""
    kw: Dict[str, Any] = {}
    extras: Dict[str, Any] = {}
    for k, v in d.items():
        if k == "session" and isinstance(v, dict):
            kw["session"] = _tel_from_json(v)
        elif k in _TEL_FIELDS:
            kw[k] = v
        else:
            extras[k] = v
    return TelemetrySnapshot(extras=extras, **kw)


class _Journal:
    """Per-worker record journal: everything routed to the worker that is
    not yet covered by a durable checkpoint.  ``base`` counts trimmed
    records; ``total`` counts all records ever appended, so the retained
    window is ``[base, total)``."""

    def __init__(self) -> None:
        self.base = 0
        self.total = 0
        self._chunks: deque = deque()
        self._lock = threading.Lock()

    def append(self, rows, cols, vals) -> None:
        with self._lock:
            self._chunks.append((rows, cols, vals))
            self.total += int(rows.shape[0])

    def trim(self, cursor: int) -> None:
        """Drop whole chunks that a durable checkpoint at ``cursor`` makes
        unneeded (chunk granularity: a partially-covered chunk is kept)."""
        with self._lock:
            while self._chunks:
                n = int(self._chunks[0][0].shape[0])
                if self.base + n > cursor:
                    break
                self.base += n
                self._chunks.popleft()

    def replay_from(self, cursor: int) -> List[Tuple]:
        """The record tail from global offset ``cursor`` on, as chunks."""
        with self._lock:
            if cursor < self.base:
                raise RuntimeError(
                    f"journal trimmed to {self.base} but replay needs "
                    f"{cursor}: a checkpoint was acked that is not durable"
                )
            out = []
            offset = self.base
            for rows, cols, vals in self._chunks:
                n = int(rows.shape[0])
                if offset + n > cursor:
                    lo = max(cursor - offset, 0)
                    out.append((rows[lo:], cols[lo:], vals[lo:]))
                offset += n
            return out


class WorkerHandle:
    """Controller-side state of one worker slot (stable across restarts)."""

    def __init__(self, worker_id: int):
        self.worker_id = worker_id
        self.journal = _Journal()
        self.proc: Optional[subprocess.Popen] = None
        self.generation = 0
        self.restarts = 0
        self.ctrl_conn: Optional[socket.socket] = None
        self.data_sock: Optional[socket.socket] = None
        self.data_port: Optional[int] = None
        self.cursor_base = 0  # cursor the live incarnation restored from
        self.pending_plan: Optional[Dict[str, Any]] = None
        self.hello_event = threading.Event()
        self.report_event = threading.Event()
        self.telemetry: Optional[TelemetrySnapshot] = None
        self.report: Optional[TelemetrySnapshot] = None
        self.report_cursor: Optional[int] = None
        self.snapshot_path: Optional[str] = None
        self.last_ckpt: Optional[Dict[str, Any]] = None  # dir/step/cursor
        self.error: Optional[str] = None
        self.metrics_dump: Optional[Dict[str, Any]] = None  # latest obs dump
        # kernel -> wrapper launches over the reporting incarnation's life
        self.launches: Optional[Dict[str, int]] = None
        self.log_path: Optional[str] = None
        self.quarantined = False  # crash-loop breaker tripped; never revived
        self.last_revive_error: Optional[str] = None
        # heartbeat coverage starts at this incarnation's hello: imports +
        # session build before it can legitimately take far longer than any
        # useful hang deadline (spawn_timeout_s owns that window instead)
        self.hb_armed = False

    @property
    def delivered(self) -> Optional[int]:
        """Unique records of this worker's shard folded into its final
        state (replays excluded — the cursor is global by construction)."""
        return self.report_cursor


@dataclasses.dataclass
class FleetReport:
    """Outcome of one fleet run."""

    n_workers: int
    records_in: int  # records the controller accepted and routed
    records_delivered: int  # Σ per-worker final global cursors (unique)
    telemetry: TelemetrySnapshot  # merge() of the final worker snapshots
    per_worker: List[Dict[str, Any]]
    wall_s: float
    aggregate_rate: float  # unique records / controller wall
    restarts: int
    snapshot_paths: List[Optional[str]]
    # per-worker (rows, cols, vals) loaded eagerly at report time, so the
    # report outlives the fleet workdir
    snapshot_triples: List[Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = dataclasses.field(
        default_factory=list
    )
    # crash-loop casualties: one entry per quarantined worker slot with its
    # orphaned key-range and the exact journaled-but-undelivered count
    quarantined: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    records_quarantined: int = 0  # Σ journaled-but-undelivered, exact

    @property
    def conserved(self) -> bool:
        """Both conservation contracts: per-worker serve accounting summed
        (``records_in == records_fed + records_dropped``) and the fleet
        ledger — every routed record either delivered exactly once or
        exactly accounted against a quarantined worker, never silently
        lost."""
        t = self.telemetry
        serve_ok = (t.records_in or 0) == (t.records_fed or 0) + (
            t.records_dropped or 0
        )
        return serve_ok and (
            self.records_delivered + self.records_quarantined
            == self.records_in
        )

    def merged_snapshot(self, cap: Optional[int] = None, sr=None, device=None):
        """Fold the per-worker snapshots into the fleet-global
        :class:`~repro_torch.core.assoc.Assoc`, on ``device`` (the card
        unless ``device="cpu"``; without CUDA that raises).

        Host hashing makes the per-worker key sets disjoint, and each
        worker's snapshot is canonical (sorted, unique keys), so the union
        compacts to exactly what a single process ingesting the whole
        stream snapshots — bit-identical for exactly-representable values
        (integer-valued counts).  On the card the union is one
        ``sort_dedup`` call (``assoc.from_triples``) over the concatenated
        snapshots.  A bfloat16 fleet's values arrive as float32 (the
        workers' snapshot files hold them so, exactly).
        """
        import torch

        from repro_torch.core import assoc as assoc_mod
        from repro_torch.core.semiring import PLUS_TIMES

        dev = resolve_device(device)
        if self.quarantined:
            raise RuntimeError(
                f"merged_snapshot unavailable: worker(s) "
                f"{[q['worker'] for q in self.quarantined]} are quarantined; "
                f"their shard is exactly accounted in records_quarantined "
                f"({self.records_quarantined} records)"
            )
        sr = sr or PLUS_TIMES
        rows, cols, vals = [], [], []
        for triple in self.snapshot_triples:
            if triple is None:
                raise RuntimeError("a worker produced no snapshot")
            rows.append(triple[0])
            cols.append(triple[1])
            vals.append(triple[2])
        r = np.concatenate(rows) if rows else np.zeros((0,), np.int32)
        c = np.concatenate(cols) if cols else np.zeros((0,), np.int32)
        v = np.concatenate(vals) if vals else np.zeros((0,), np.float32)
        cap = int(cap) if cap is not None else max(int(r.shape[0]), 1)
        return assoc_mod.from_triples(
            *(torch.from_numpy(x).to(dev) for x in (r, c, v)), cap=cap, sr=sr
        )


class FleetController:
    """Spawn and drive a fleet of ``n_workers`` subprocesses.

    ``config`` is the per-worker :class:`~repro_torch.d4m.StreamConfig` (every
    worker runs the same plan — ``config.plan(hosts=n_workers)`` is the
    fleet-wide capacity preview).  ``serve_config`` defaults to
    ``config.serve`` or checkpointing defaults; set ``checkpoint_every``
    there to enable restart-from-checkpoint supervision.

    ``device`` is where every worker runs (``None``: the card); it is
    resolved here, before anything is spawned, and a CUDA device without
    CUDA raises.

    Use as a context manager or call :meth:`close` — it kills whatever is
    still running.  The blocking convenience path is :meth:`run`.
    """

    def __init__(
        self,
        config: StreamConfig,
        n_workers: int,
        workdir: str,
        serve_config: Optional[ServeConfig] = None,
        report_interval_s: float = 0.25,
        encoding: str = "binary",
        chunk_poll_every: int = 8,
        restart_dead: bool = True,
        max_restarts_per_worker: int = 3,
        spawn_timeout_s: float = 120.0,
        env: Optional[Dict[str, str]] = None,
        python: str = sys.executable,
        faults: Optional[FaultPlan] = None,
        heartbeat_timeout_s: Optional[float] = None,
        connect_retry: Optional[RetryPolicy] = None,
        metrics: Optional[bool] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.config = config.validate()
        self.n_workers = int(n_workers)
        self.workdir = os.path.abspath(workdir)
        self.serve_config = (
            serve_config or config.serve or ServeConfig()
        ).validate()
        self.report_interval_s = float(report_interval_s)
        self.encoding = encoding
        self.chunk_poll_every = int(chunk_poll_every)
        self.restart_dead = bool(restart_dead)
        self.max_restarts_per_worker = int(max_restarts_per_worker)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.extra_env = dict(env or {})
        self.python = python
        # Fault plan: consulted at controller sites (journal_disk_full) and
        # propagated to every worker via the environment, where it drives
        # the serve/checkpoint sites with only_worker scoping.  Explicit
        # argument wins; otherwise inherit the environment (so a chaos CI
        # job can inject without touching call sites).
        self._faults = faults if faults is not None else FaultPlan.from_env()
        # Observability: the one-switch fleet enable.  An explicit metrics=
        # argument wins; otherwise REPRO_OBS (same resolution as the serve
        # loop).  When the fleet plane is on, it is threaded into the
        # workers' ServeConfig (unless the caller pinned serve metrics
        # explicitly), so one flag arms the controller's own registry AND
        # every worker's — FleetController.metrics() then merges them all.
        from repro_torch.obs import MetricsRegistry

        if metrics is not None:
            self._metrics = MetricsRegistry() if metrics else None
        else:
            self._metrics = MetricsRegistry.from_env()
        if self._metrics is not None and self.serve_config.metrics is None:
            self.serve_config = dataclasses.replace(
                self.serve_config, metrics=True
            )
        self._h_push = (
            None if self._metrics is None
            else self._metrics.histogram("fleet.push_ns")
        )
        # Liveness: socket errors catch dead workers; the heartbeat deadline
        # catches HUNG-but-connected ones (no control-plane message for
        # longer than the timeout).  The deadline arms per incarnation at
        # ``hello`` — startup (imports, restore, session build) is covered
        # by spawn_timeout_s, not the heartbeat, so the timeout can be
        # sized for the telemetry cadence rather than worst-case cold
        # compile.  Disabled (None) by default.
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._hb = (
            Heartbeat(range(n_workers), timeout_s=float(heartbeat_timeout_s))
            if heartbeat_timeout_s is not None
            else None
        )
        self.connect_retry = connect_retry or RetryPolicy(
            max_attempts=8, base_delay_s=0.05, max_delay_s=1.0, deadline_s=30.0
        )
        self.workers = [WorkerHandle(i) for i in range(self.n_workers)]
        self.records_in = 0
        self._listener: Optional[socket.socket] = None
        self._ctrl_port: Optional[int] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._closing = threading.Event()
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "FleetController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def start(self) -> "FleetController":
        if self._started:
            return self
        self._started = True
        if self.device.type == "cuda":
            # one build for the fleet, before N workers would each run nvcc
            # at first use (and outrun spawn_timeout_s)
            from repro_torch.kernels import _build

            _build.build_all()
        os.makedirs(self.workdir, exist_ok=True)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(self.n_workers * 2)
        self._ctrl_port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-ctrl-accept", daemon=True
        )
        self._accept_thread.start()
        for h in self.workers:
            self._spawn(h, restore=None)
        for h in self.workers:
            self._await_hello(h)
        self._t0 = time.monotonic()
        return self

    def close(self) -> None:
        """Tear everything down (idempotent; abort semantics)."""
        self._closing.set()
        for h in self.workers:
            for sock in (h.data_sock, h.ctrl_conn):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
            h.data_sock = h.ctrl_conn = None
            if h.proc is not None and h.proc.poll() is None:
                h.proc.kill()
                h.proc.wait()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None

    # -- spawning + handshake ------------------------------------------------
    def _worker_dirs(self, h: WorkerHandle) -> Tuple[str, str]:
        gen_dir = os.path.join(
            self.workdir, f"w{h.worker_id}", f"g{h.generation}"
        )
        os.makedirs(gen_dir, exist_ok=True)
        return gen_dir, os.path.join(gen_dir, "ckpt")

    def _spawn(self, h: WorkerHandle, restore: Optional[Dict[str, Any]]) -> None:
        gen_dir, ckpt_dir = self._worker_dirs(h)
        checkpointing = self.serve_config.checkpoint_every is not None
        h.pending_plan = {
            "type": "plan",
            "config": self.config.to_dict(),
            "device": str(self.device),
            "serve": self.serve_config.to_dict(),
            "checkpoint_dir": ckpt_dir if checkpointing else None,
            "restore": restore,
            "report_interval_s": self.report_interval_s,
            "encoding": self.encoding,
            "snapshot_path": os.path.join(gen_dir, "snapshot.npz"),
        }
        h.hello_event.clear()
        h.report_event.clear()
        h.telemetry = None
        h.log_path = os.path.join(gen_dir, "worker.log")
        env = dict(os.environ)
        # the worker imports repro_torch from the controller's checkout,
        # wherever the subprocess starts
        src_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = src_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        if self._faults is not None:
            # ship the plan to the worker; WORKER_ENV_VAR binds the process
            # to its slot so only_worker-scoped specs hit one worker.  Each
            # incarnation rebuilds from specs with fresh counters — "crash
            # after N batches" means N batches of each incarnation.
            env[ENV_VAR] = self._faults.to_env()
            env[WORKER_ENV_VAR] = str(h.worker_id)
            # only_generation-scoped specs read this: crash generation 0
            # once, let the revival run clean (vs. unscoped = crash-loop)
            env[GENERATION_ENV_VAR] = str(h.generation)
        env.update(self.extra_env)
        h.hb_armed = False  # this incarnation's deadline arms at its hello
        if self._hb is not None:
            self._hb.ping(h.worker_id)  # fresh deadline for the new process
        with open(h.log_path, "ab") as log:
            h.proc = subprocess.Popen(
                [
                    self.python, "-m", "repro_torch.fleet.worker",
                    "--worker-id", str(h.worker_id),
                    "--controller", f"127.0.0.1:{self._ctrl_port}",
                ],
                stdout=log, stderr=subprocess.STDOUT, env=env,
            )

    def _await_hello(self, h: WorkerHandle) -> None:
        deadline = time.monotonic() + self.spawn_timeout_s
        while not h.hello_event.wait(timeout=0.2):
            if time.monotonic() > deadline or (
                h.proc is not None and h.proc.poll() is not None
            ):
                raise RuntimeError(
                    f"worker {h.worker_id} failed to come up "
                    f"(exit={h.proc.poll() if h.proc else None}); "
                    f"log: {self._log_tail(h)}"
                )
        h.data_sock = self.connect_retry.call(
            lambda: socket.create_connection(
                ("127.0.0.1", h.data_port), timeout=30
            )
        )
        h.data_sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _log_tail(self, h: WorkerHandle, n: int = 12) -> str:
        try:
            with open(h.log_path, "r", errors="replace") as f:
                return " | ".join(f.read().splitlines()[-n:])
        except OSError:
            return "<no log>"

    # -- control-plane message pump ------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(
                target=self._conn_loop, args=(conn,),
                name="fleet-ctrl-conn", daemon=True,
            ).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        reader = conn.makefile("r", encoding="utf-8")
        try:
            attach = json.loads(reader.readline() or "null")
            if not attach or attach.get("type") != "attach":
                conn.close()
                return
            h = self.workers[int(attach["worker"])]
            with self._lock:
                h.ctrl_conn = conn
                plan = h.pending_plan
            conn.sendall((json.dumps(plan) + "\n").encode("utf-8"))
            if self._hb is not None:
                self._hb.ping(h.worker_id)
            for raw in reader:
                msg = json.loads(raw)
                kind = msg.get("type")
                if self._hb is not None:
                    self._hb.ping(h.worker_id)
                if kind == "hello":
                    h.data_port = int(msg["data_port"])
                    h.cursor_base = int(msg["cursor"])
                    h.hb_armed = True  # serving now; deadline means a hang
                    h.hello_event.set()
                elif kind == "telemetry":
                    h.telemetry = _tel_from_json(msg["telemetry"])
                    if msg.get("metrics") is not None:
                        h.metrics_dump = msg["metrics"]
                elif kind == "checkpoint":
                    with self._lock:
                        h.last_ckpt = {
                            "dir": msg["dir"],
                            "step": int(msg["step"]),
                            "cursor": int(msg["cursor"]),
                        }
                    h.journal.trim(int(msg["cursor"]))
                elif kind == "report":
                    h.report = _tel_from_json(msg["telemetry"])
                    h.telemetry = h.report
                    if msg.get("metrics") is not None:
                        h.metrics_dump = msg["metrics"]
                    h.report_cursor = int(msg["cursor"])
                    h.snapshot_path = msg.get("snapshot_path")
                    h.launches = msg.get("launches")
                    h.report_event.set()
                elif kind == "error":
                    h.error = msg.get("error", "unknown worker error")
                    h.report_event.set()
        except (OSError, ValueError):
            pass  # connection died; the supervisor path handles the worker
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- data plane ----------------------------------------------------------
    def push(self, rows, cols, vals) -> None:
        """Route one record chunk across the fleet and send each worker its
        slice (journal-first, so a crash between journal and socket is
        always recoverable by replay).

        ``records_in`` counts per-part *after* the journal append succeeds:
        a journal failure (disk full) raises before the part is counted, so
        the ledger never claims acceptance of records the fleet cannot
        recover.  Parts owned by a quarantined worker are journaled but not
        sent — they become the report's exact ``records_quarantined``.
        """
        if self._h_push is None:
            self._push_impl(rows, cols, vals)
            return
        t0 = time.perf_counter_ns()
        try:
            self._push_impl(rows, cols, vals)
        finally:
            self._h_push.record(time.perf_counter_ns() - t0)

    def _push_impl(self, rows, cols, vals) -> None:
        # route + journal + send for one chunk (push() adds the timing)
        rows = np.asarray(rows, np.int32).ravel()
        cols = np.asarray(cols, np.int32).ravel()
        vals = np.asarray(vals, np.float32).ravel()
        if rows.shape[0] == 0:
            return
        parts = split_by_host(rows, cols, vals, self.n_workers)
        for h, (r, c, v) in zip(self.workers, parts):
            if r.shape[0] == 0:
                continue
            if self._faults is not None:
                spec = self._faults.fire(
                    "controller.journal_disk_full", cursor=h.journal.total
                )
                if spec is not None:
                    raise OSError(
                        f"journal append failed for worker {h.worker_id} "
                        f"(injected disk-full); records_in={self.records_in} "
                        f"counts only accepted records"
                    )
            h.journal.append(r, c, v)
            self.records_in += int(r.shape[0])
            if h.quarantined:
                continue  # journaled (exactly accounted), never sent
            self._send(h, [(r, c, v)])

    def _send(self, h: WorkerHandle, chunks) -> None:
        try:
            for r, c, v in chunks:
                h.data_sock.sendall(wire.encode(r, c, v, self.encoding))
        except OSError:
            self._handle_death(h)

    def poll_workers(self) -> None:
        """Detect silently-dead workers (SIGKILL leaves the data socket
        buffering for a while — the exit code does not lie), and, when a
        heartbeat deadline is configured, hung-but-connected ones (live
        process, open sockets, no control-plane message for longer than
        the timeout)."""
        if self._metrics is not None and self._hb is not None:
            now = time.time()
            for wid, last in self._hb.last.items():
                self._metrics.gauge(f"fleet.heartbeat_age_s.w{wid}").set(
                    max(0.0, now - last)
                )
        for h in self.workers:
            if (
                not h.quarantined
                and h.proc is not None
                and h.proc.poll() is not None
                and not h.report_event.is_set()
            ):
                self._handle_death(h)
        if self._hb is not None:
            for wid in self._hb.dead():
                h = self.workers[wid]
                if h.quarantined or h.report_event.is_set() or not h.hb_armed:
                    # done, written off, or still booting (hello not seen:
                    # that window belongs to spawn_timeout_s) — not hung
                    self._hb.ping(wid)
                    continue
                self.kill_worker(wid)  # hung: only SIGKILL reaches it
                self._handle_death(h)

    def kill_worker(self, worker_id: int) -> None:
        """SIGKILL one worker (fault-injection surface for tests/benches)."""
        h = self.workers[worker_id]
        if h.proc is not None and h.proc.poll() is None:
            h.proc.send_signal(signal.SIGKILL)
            h.proc.wait()

    def _handle_death(self, h: WorkerHandle) -> None:
        if self._closing.is_set() or h.quarantined:
            return
        if not self.restart_dead:
            raise RuntimeError(
                f"worker {h.worker_id} died (exit="
                f"{h.proc.poll() if h.proc else None}, restarts={h.restarts}); "
                f"log: {self._log_tail(h)}"
            )
        # crash-loop breaker: each revival attempt (successful spawn that
        # later dies again, or a failed spawn/handshake/replay) burns one of
        # max_restarts_per_worker; past that the slot is quarantined — its
        # key-range and exact undelivered count surface in the FleetReport
        # instead of an infinite revive loop.
        while h.restarts < self.max_restarts_per_worker:
            try:
                self._revive(h)
                return
            except (RuntimeError, OSError, TimeoutError) as err:
                h.last_revive_error = repr(err)
        self._quarantine(h)

    def _quarantine(self, h: WorkerHandle) -> None:
        h.quarantined = True
        for sock in (h.data_sock, h.ctrl_conn):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        h.data_sock = h.ctrl_conn = None
        if h.proc is not None and h.proc.poll() is None:
            h.proc.kill()
            h.proc.wait()

    def _revive(self, h: WorkerHandle) -> None:
        """Respawn a dead worker from its last durable checkpoint and
        replay the journal tail — the cursor-exact restart contract.

        The new incarnation reports the cursor it *actually* restored
        (damaged generations fall back — see
        :meth:`repro_torch.checkpoint.manager.CheckpointManager.restore`); the
        replay is cut at that cursor, so a fallback restore is lossless as
        long as the journal still covers it.  ``replay_from`` raises when
        it does not (an acked-durable checkpoint turned out unreadable) —
        a genuine loss scenario that burns a revival attempt and, when
        attempts are exhausted, quarantines with exact accounting.
        """
        h.restarts += 1
        for sock in (h.data_sock, h.ctrl_conn):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        h.data_sock = h.ctrl_conn = None
        if h.proc is not None and h.proc.poll() is None:
            h.proc.kill()
        if h.proc is not None:
            h.proc.wait()
        h.generation += 1
        with self._lock:
            restore = dict(h.last_ckpt) if h.last_ckpt else None
        self._spawn(h, restore=restore)
        self._await_hello(h)
        expect = restore["cursor"] if restore else 0
        if h.cursor_base > expect:
            raise RuntimeError(
                f"worker {h.worker_id} restored cursor {h.cursor_base} "
                f"beyond the acked {expect}: the incarnation claims records "
                f"the controller never saw durable"
            )
        self._send(h, h.journal.replay_from(h.cursor_base))

    # -- drain + aggregation -------------------------------------------------
    def finish(self, timeout_s: float = 300.0) -> "FleetReport":
        """Close the data plane (drain signal), collect every worker's
        final report, and aggregate."""
        deadline = time.monotonic() + float(timeout_s)
        for h in self.workers:
            if h.quarantined:
                continue
            if h.data_sock is not None:
                try:
                    h.data_sock.shutdown(socket.SHUT_WR)
                except OSError:
                    self._handle_death(h)
        pending = [h for h in self.workers if not h.quarantined]
        while pending:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"workers {[h.worker_id for h in pending]} did not "
                    f"report within {timeout_s}s"
                )
            still = []
            for h in pending:
                if h.quarantined:
                    continue  # written off mid-drain; report() accounts it
                if h.report_event.wait(timeout=0.2):
                    if h.error is not None:
                        raise RuntimeError(
                            f"worker {h.worker_id} failed: {h.error}; "
                            f"log: {self._log_tail(h)}"
                        )
                elif h.proc is not None and h.proc.poll() is not None:
                    # died mid-drain: revive, replay, re-signal drain
                    self._handle_death(h)
                    if not h.quarantined:
                        try:
                            h.data_sock.shutdown(socket.SHUT_WR)
                        except OSError:
                            pass
                        still.append(h)
                else:
                    if self._hb is not None:
                        # hung-but-connected mid-drain is still a death;
                        # nothing else calls poll_workers during finish
                        gen_before = h.generation
                        self.poll_workers()
                        if h.quarantined:
                            continue
                        if h.generation != gen_before:
                            # killed + revived: re-signal the drain
                            try:
                                h.data_sock.shutdown(socket.SHUT_WR)
                            except OSError:
                                pass
                    still.append(h)
            pending = still
        self._t1 = time.monotonic()
        for h in self.workers:
            if h.proc is not None:
                h.proc.wait()
        return self.report()

    def run(self, source, finish_timeout_s: float = 300.0) -> "FleetReport":
        """Blocking convenience: start, drain ``source`` through the fleet,
        finish, close."""
        self.start()
        try:
            source.start()
            for i, (r, c, v) in enumerate(source.chunks()):
                self.push(r, c, v)
                if self.chunk_poll_every and i % self.chunk_poll_every == 0:
                    self.poll_workers()
            source.stop()
            return self.finish(timeout_s=finish_timeout_s)
        finally:
            self.close()

    def telemetry(self) -> TelemetrySnapshot:
        """Live fleet-wide counters: the merge of the latest per-worker
        snapshots (final reports once a worker drained)."""
        tels = [h.telemetry for h in self.workers if h.telemetry is not None]
        if not tels:
            return TelemetrySnapshot(engine="fleet")
        return TelemetrySnapshot.merge(tels)

    def metrics(self) -> Optional[Dict[str, Any]]:
        """The fleet-wide observability view: every worker's latest
        registry dump (piggybacked on its control-plane telemetry) merged
        with the controller's own registry.

        Counters and gauges sum; histograms merge bucket-wise, so the
        fleet distribution conserves every worker's event counts exactly.
        ``None`` when no registry exists anywhere (observability off).
        """
        from repro_torch.obs import MetricsRegistry

        dumps = [
            h.metrics_dump for h in self.workers if h.metrics_dump is not None
        ]
        if self._metrics is not None:
            dumps.append(self._metrics.dump())
        if not dumps:
            return None
        return MetricsRegistry.merge_dumps(dumps)

    def _quarantine_entry(self, h: WorkerHandle) -> Dict[str, Any]:
        """Exact loss accounting for one quarantined slot: every record
        routed to it is journaled; the part durably checkpointed before the
        crash loop counts as delivered, the rest is the undelivered tail."""
        acked = int(h.last_ckpt["cursor"]) if h.last_ckpt else 0
        lo, hi = host_key_range(h.worker_id, self.n_workers)
        return {
            "worker": h.worker_id,
            "key_hash_lo": lo,
            "key_hash_hi": hi,
            "journaled": h.journal.total,
            "delivered": acked,
            "undelivered": h.journal.total - acked,
            "restarts": h.restarts,
            "last_error": h.last_revive_error or h.error,
            "log_tail": self._log_tail(h),
        }

    def report(self) -> FleetReport:
        live = [h for h in self.workers if not h.quarantined]
        tels = [h.report for h in live if h.report is not None]
        if len(tels) != len(live):
            raise RuntimeError("report() before every live worker reported")
        if tels:
            merged = TelemetrySnapshot.merge(tels)
            sessions = [t.session for t in tels if t.session is not None]
            if sessions:
                merged.session = TelemetrySnapshot.merge(sessions)
        else:  # every worker quarantined: nothing to merge
            merged = TelemetrySnapshot(engine="fleet")
        wall = (self._t1 or time.monotonic()) - (self._t0 or 0.0)
        quarantine = [
            self._quarantine_entry(h) for h in self.workers if h.quarantined
        ]
        delivered = sum(h.report_cursor or 0 for h in live) + sum(
            q["delivered"] for q in quarantine
        )
        per_worker = [
            {
                "worker": h.worker_id,
                "delivered": h.report_cursor,
                "journaled": h.journal.total,
                "restarts": h.restarts,
                "quarantined": h.quarantined,
                "ingest_rate": (h.report.ingest_rate if h.report else None),
                "records_fed": (h.report.records_fed if h.report else None),
                "launches": h.launches,
            }
            for h in self.workers
        ]
        triples: List[Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = []
        for h in self.workers:
            if h.snapshot_path is None or not os.path.exists(h.snapshot_path):
                triples.append(None)
                continue
            with np.load(h.snapshot_path) as z:
                triples.append((z["rows"], z["cols"], z["vals"]))
        return FleetReport(
            n_workers=self.n_workers,
            records_in=self.records_in,
            records_delivered=delivered,
            telemetry=merged,
            per_worker=per_worker,
            wall_s=max(wall, 1e-9),
            aggregate_rate=self.records_in / max(wall, 1e-9),
            restarts=sum(h.restarts for h in self.workers),
            snapshot_paths=[h.snapshot_path for h in self.workers],
            snapshot_triples=triples,
            quarantined=quarantine,
            records_quarantined=sum(q["undelivered"] for q in quarantine),
        )
