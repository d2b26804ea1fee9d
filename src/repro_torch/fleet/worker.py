"""Fleet worker entry point: ``python -m repro_torch.fleet.worker`` (port of
``repro.fleet.worker``).

One worker is one process running the port's ``D4MStream.serve()`` stack
unchanged over its shard of the stream, on the device the controller's
plan names (the card unless the fleet was given ``device="cpu"``).
Lifecycle, driven entirely by the controller over a newline-delimited-JSON
control channel (one TCP connection, worker-initiated so only the
controller needs a known port):

1. connect to ``--controller`` and send ``attach``;
2. receive the ``plan`` message: the full :class:`~repro_torch.d4m.StreamConfig`
   wire form (``StreamConfig.to_dict``), the device, the serve knobs, this
   incarnation's checkpoint directory, and — on a restart — the exact
   ``(dir, step, cursor)`` of the last checkpoint the controller saw
   acknowledged as durable;
3. build the session (``D4MStream.from_dict``), allocate its state (on the
   card this also brings up the CUDA context, before the controller's
   heartbeat arms), restore it if asked, bind a
   :class:`~repro_torch.serve.TCPSource` on an ephemeral port, and send
   ``hello`` with the data port and the restored cursor — the controller
   replays its journal from exactly that record onward;
4. serve until the controller closes the data connection (natural drain:
   the source ends when its one producer disconnects), sending periodic
   ``telemetry`` messages and a ``checkpoint`` notice for every checkpoint
   that is *durably on disk* (manifest published by the atomic rename —
   never the merely-scheduled async save, so the controller's journal
   trimming can never outrun what a restart could actually recover);
5. on drain: final checkpoint (the serve loop's own ``final=True`` path),
   snapshot to an ``.npz`` next to the checkpoint dir, send ``report``
   (with the kernels' launch counts of this process's life), and exit 0.

Checkpoint cursors on the control channel are *global* (records of this
worker's shard folded into the state since the fleet started): the plan's
restored cursor — nonzero after a restart — is added to the serve loop's
incarnation-local cursor before reporting.  Each incarnation saves into a
fresh generation directory, so step numbers never collide across restarts.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time
from typing import Any, Dict, Optional

import numpy as np


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's ``launch_count`` (``kernels/<name>/ops.py``) in
    this process: 0 for a kernel never launched, and for every kernel on
    the CPU, where the wrappers run their plain versions."""
    import importlib

    from repro_torch.kernels._build import KERNELS

    return {
        name: int(importlib.import_module(f"repro_torch.kernels.{name}.ops").launch_count)
        for name in KERNELS
    }


def _send(sock: socket.socket, msg: Dict[str, Any], lock: threading.Lock) -> None:
    data = (json.dumps(msg) + "\n").encode("utf-8")
    with lock:
        sock.sendall(data)


def _latest_durable_checkpoint(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """The newest published checkpoint's ``(step, extra)``, or ``None``.

    Reads only what the atomic ``os.replace`` made visible; a checkpoint
    mid-write lives in ``tmp-*`` and is invisible here by construction.
    """
    try:
        from repro_torch.checkpoint.manager import CheckpointManager

        mgr = CheckpointManager(ckpt_dir)
        step = mgr.latest_step()
        if step is None:
            return None
        path = os.path.join(ckpt_dir, f"ckpt-{step:09d}", "manifest.json")
        with open(path) as f:
            manifest = json.load(f)
        return {"step": step, "extra": manifest.get("extra", {})}
    except (OSError, ValueError, json.JSONDecodeError):
        return None  # racing a publish/gc; retry next poll


def _restore_session(sess, restore_dir: str, step: Optional[int]) -> Dict[str, Any]:
    """Restore ``sess`` from a *different* directory than it checkpoints to
    (each incarnation saves into its own generation dir).  Reuses
    ``D4MStream.restore`` — and with it the owned-copy rules the replay
    parity tests pin down — by temporarily pointing the session at the
    restore dir."""
    save_dir = sess._ckpt_dir
    sess._ckpt_dir, sess._mgr = restore_dir, None
    try:
        return sess.restore(step=step, fallback=True)
    finally:
        sess._ckpt_dir, sess._mgr = save_dir, None


def _write_snapshot(sess, snapshot_path: str) -> None:
    """The session's global snapshot as ``rows/cols/vals/nnz/overflow`` in
    an npz, through a temp file, fsync and an atomic rename: the controller
    can never observe (and try to merge) a half-written file.  bfloat16
    values are written as float32, which holds each of them exactly."""
    from repro_torch.serve.query import host

    # stale tmp files from a crashed earlier incarnation of this generation
    # must not accumulate next to the snapshot
    snap_dir = os.path.dirname(snapshot_path) or "."
    base = os.path.basename(snapshot_path)
    for name in os.listdir(snap_dir):
        if name.startswith(base + ".tmp-"):
            try:
                os.remove(os.path.join(snap_dir, name))
            except OSError:
                pass
    snap = sess.snapshot()
    nnz = int(snap.nnz)
    tmp = f"{snapshot_path}.tmp-{os.getpid()}.npz"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            rows=host(snap.rows[:nnz]),
            cols=host(snap.cols[:nnz]),
            vals=host(snap.vals[:nnz]),
            nnz=nnz,
            overflow=bool(snap.overflow),
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, snapshot_path)


def run_worker(worker_id: int, controller: str) -> int:
    # Bind this process to its fleet slot BEFORE anything builds a
    # FaultPlan from the environment, so only_worker-scoped specs in the
    # controller's propagated plan target exactly this worker.
    from repro_torch.faults import GENERATION_ENV_VAR, WORKER_ENV_VAR, RetryPolicy

    os.environ[WORKER_ENV_VAR] = str(worker_id)
    host, _, port = controller.rpartition(":")
    ctrl = RetryPolicy(max_attempts=8, base_delay_s=0.05, deadline_s=30.0).call(
        lambda: socket.create_connection(
            (host or "127.0.0.1", int(port)), timeout=30
        )
    )
    ctrl_lock = threading.Lock()
    reader = ctrl.makefile("r", encoding="utf-8")
    _send(ctrl, {"type": "attach", "worker": worker_id, "pid": os.getpid()},
          ctrl_lock)
    line = reader.readline()
    if not line:
        return 2
    plan = json.loads(line)
    if plan.get("type") != "plan":
        raise RuntimeError(f"expected plan, got {plan.get('type')!r}")

    # heavy imports after the handshake so a config error surfaces fast
    from repro_torch import serve
    from repro_torch.d4m.config import ServeConfig
    from repro_torch.d4m.session import D4MStream
    from repro_torch.serve.server import D4MServer

    sess = D4MStream.from_dict(
        plan["config"], device=plan["device"],
        checkpoint_dir=plan.get("checkpoint_dir"),
    )
    sess.state  # allocate now: startup belongs to spawn_timeout_s, not the heartbeat
    sess.synchronize()
    cursor_base = 0
    restore = plan.get("restore")
    if restore:
        # fallback=True: if the acked generation is torn/corrupt, walk back
        # to the newest one that verifies; if NOTHING loads, come up fresh
        # at cursor 0.  Either way, ``hello`` reports the cursor actually
        # restored and the controller cuts its journal replay there — it,
        # not this process, decides whether that cursor is recoverable.
        from repro_torch.checkpoint.manager import CheckpointDamaged

        try:
            extra = _restore_session(sess, restore["dir"], restore.get("step"))
            cursor_base = int(extra.get("cursor", 0))
        except (CheckpointDamaged, FileNotFoundError):
            cursor_base = 0

    src = serve.TCPSource(
        port=0, encoding=plan.get("encoding", "binary"), linger=False
    ).start()
    serve_cfg = ServeConfig.from_dict(plan.get("serve") or {})
    server = D4MServer(sess, src, serve_cfg)
    faults = server._faults  # one shared instance for every worker-side site
    if faults is not None:
        # rebind explicitly: the plan may have arrived via the serve config's
        # wire form rather than the environment, in which case from_env's
        # auto-binding never ran
        faults.bind(worker_id)
        gen = os.environ.get(GENERATION_ENV_VAR)
        if gen:
            faults.bind_generation(int(gen))

    stop_requested = threading.Event()

    def control_reader() -> None:
        # the controller's only inbound messages are stop/abort; EOF means
        # the controller died — abort, don't serve a headless stream
        try:
            for raw in reader:
                msg = json.loads(raw)
                if msg.get("type") == "stop":
                    stop_requested.set()
                    server.stop(drain=bool(msg.get("drain", True)))
        except (OSError, ValueError):
            pass
        if not server._done.is_set():
            stop_requested.set()
            try:
                server.stop(drain=False)
            except Exception:
                pass

    threading.Thread(target=control_reader, daemon=True,
                     name="fleet-ctrl-reader").start()

    server.start()
    _send(ctrl, {
        "type": "hello", "worker": worker_id, "data_port": src.port,
        "cursor": cursor_base,
    }, ctrl_lock)

    interval = float(plan.get("report_interval_s", 0.5))
    ckpt_dir = plan.get("checkpoint_dir")
    last_ckpt_step = -1

    def notify_durable() -> None:
        nonlocal last_ckpt_step
        durable = _latest_durable_checkpoint(ckpt_dir)
        if durable is not None and durable["step"] > last_ckpt_step:
            last_ckpt_step = durable["step"]
            _send(ctrl, {
                "type": "checkpoint", "worker": worker_id,
                "step": durable["step"], "dir": ckpt_dir,
                "cursor": cursor_base + int(durable["extra"].get("cursor", 0)),
            }, ctrl_lock)

    try:
        while not server._done.wait(timeout=interval):
            if faults is not None and faults.fire(
                "worker.hang", cursor=server.batches_fed
            ) is not None:
                # hung-but-connected: the process stays alive and every
                # socket stays open, but no control-plane message ever
                # arrives again — only the controller's heartbeat deadline
                # can tell this apart from a healthy quiet worker
                while True:
                    time.sleep(3600.0)
            tel_msg = {
                "type": "telemetry", "worker": worker_id,
                "telemetry": server.telemetry().to_json(),
            }
            dump = server.metrics_dump()
            if dump is not None:
                tel_msg["metrics"] = dump
            _send(ctrl, tel_msg, ctrl_lock)
            if ckpt_dir is not None:
                notify_durable()
        server.join()
        report = server.report()
        if ckpt_dir is not None:  # the final checkpoint is durable post-join
            notify_durable()
        snapshot_path = plan.get("snapshot_path")
        if snapshot_path:
            _write_snapshot(sess, snapshot_path)
        report_msg = {
            "type": "report", "worker": worker_id,
            "telemetry": report.telemetry.to_json(),
            "cursor": cursor_base + int(report.records_fed),
            "snapshot_path": snapshot_path,
            "launches": launch_counts(),
        }
        dump = server.metrics_dump()
        if dump is not None:
            report_msg["metrics"] = dump
        _send(ctrl, report_msg, ctrl_lock)
        return 0
    except BaseException as e:  # noqa: BLE001 - one report, then die visibly
        if stop_requested.is_set() and isinstance(e, OSError):
            return 2
        try:
            _send(ctrl, {
                "type": "error", "worker": worker_id, "error": repr(e),
            }, ctrl_lock)
        except OSError:
            pass
        raise
    finally:
        try:
            ctrl.close()
        except OSError:
            pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker-id", type=int, required=True)
    ap.add_argument("--controller", required=True,
                    help="host:port of the controller's control listener")
    args = ap.parse_args(argv)
    return run_worker(args.worker_id, args.controller)


if __name__ == "__main__":
    sys.exit(main())
