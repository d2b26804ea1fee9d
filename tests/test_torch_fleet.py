"""``repro_torch.fleet`` against the JAX package, on the CPU: real worker
subprocesses of the port over loopback sockets.

* **parity** — a 4-worker port fleet's merged snapshot is bit-identical to
  the JAX ``repro.d4m.D4MStream`` single-process snapshot of the same stream;
* **fault tolerance** — SIGKILL a worker mid-stream and the controller
  revives it from its last durable checkpoint, replays the journal tail
  cursor-exactly, and the final state is still bit-identical;
* a worker that dies with ``restart_dead=False`` fails the controller
  loudly;
* a port worker's checkpoint restores in the reference's ``D4MStream``;
* the controller resolves its device before spawning anything: without
  CUDA and without ``device="cpu"`` it raises, and so does
  ``merged_snapshot``.

Mirrors ``tests/fleet/test_fleet.py``; workers run with ``device="cpu"``.
"""
import os
import time

import numpy as np
import pytest

from repro import d4m as jd4m
from repro_torch import d4m, serve
from repro_torch.fleet import FleetController, FleetReport, controller

from _torch_fleet import (
    CAP, CHUNK, ENV, SERVE, TOTAL, assert_bit_identical, config, records,
    reference_snapshot,
)
from _torch_parity import assert_assoc_same


def test_fleet_parity_vs_jax_single_process(tmp_path):
    rows, cols, vals = records()
    ctl = FleetController(
        config(), n_workers=4, workdir=str(tmp_path / "fleet"),
        serve_config=d4m.ServeConfig(**SERVE),
        report_interval_s=0.2, env=ENV, device="cpu",
    )
    report = ctl.run(serve.ArraySource(rows, cols, vals, chunk_records=CHUNK),
                     finish_timeout_s=600)

    assert report.conserved
    assert report.records_in == TOTAL
    assert report.records_delivered == TOTAL
    assert report.restarts == 0
    tel = report.telemetry
    assert tel.records_in == tel.records_fed == TOTAL
    assert tel.records_dropped == 0
    assert tel.n_instances == 4 * 2  # fleet-wide instance count
    per_host_fed = [w["records_fed"] for w in report.per_worker]
    assert sum(per_host_fed) == TOTAL
    assert all(f > 0 for f in per_host_fed)  # hash split actually spreads
    # every worker reported its kernels' launch counts; on the CPU the
    # wrappers run their plain versions and launch nothing
    for w in report.per_worker:
        assert w["launches"] == {
            "hier_cascade": 0, "merge_add": 0, "scatter_add": 0, "sort_dedup": 0,
        }
    assert_bit_identical(
        report.merged_snapshot(cap=CAP, device="cpu"),
        reference_snapshot(rows, cols, vals),
    )


def test_fleet_kill_worker_restart_replay_parity(tmp_path):
    """SIGKILL one worker after its first durable checkpoint; the revived
    incarnation restores, replays the journal tail, and the fleet drains to
    the same bit-identical state with nothing lost or double-counted."""
    rows, cols, vals = records(seed=13)
    ctl = FleetController(
        config(), n_workers=2, workdir=str(tmp_path / "fleet"),
        serve_config=d4m.ServeConfig(checkpoint_every=2, **SERVE),
        report_interval_s=0.1, env=ENV, device="cpu",
    )
    victim = 1
    with ctl:
        n_chunks = TOTAL // CHUNK
        for i in range(n_chunks):
            lo = i * CHUNK
            ctl.push(rows[lo:lo + CHUNK], cols[lo:lo + CHUNK], vals[lo:lo + CHUNK])
            if i == n_chunks // 2:
                # at least one checkpoint of the victim is durable, so the
                # revival restores from it rather than replaying everything
                deadline = time.monotonic() + 120.0
                while ctl.workers[victim].last_ckpt is None and time.monotonic() < deadline:
                    time.sleep(0.1)
                assert ctl.workers[victim].last_ckpt is not None, (
                    "victim never published a durable checkpoint"
                )
                ctl.kill_worker(victim)
                ctl.poll_workers()  # detect + revive + replay
        report = ctl.finish(timeout_s=600)

    assert report.restarts >= 1
    assert ctl.workers[victim].generation >= 1
    assert report.conserved
    assert report.records_in == report.records_delivered == TOTAL
    assert_bit_identical(
        report.merged_snapshot(cap=CAP, device="cpu"),
        reference_snapshot(rows, cols, vals),
    )
    # the revived incarnation checkpointed into a fresh generation dir
    assert len(os.listdir(tmp_path / "fleet" / f"w{victim}")) >= 2


def test_fleet_worker_error_surfaces(tmp_path):
    """A dead worker with restarts off fails the controller loudly, not
    by hanging the drain."""
    ctl = FleetController(
        config(), n_workers=1, workdir=str(tmp_path / "fleet"),
        restart_dead=False, spawn_timeout_s=120.0, env=ENV, device="cpu",
    )
    with ctl:
        ctl.push(*records(64, seed=3))
        ctl.kill_worker(0)
        with pytest.raises(RuntimeError, match="worker 0 died"):
            ctl.poll_workers()


def test_port_worker_checkpoint_restores_in_the_reference(tmp_path):
    """The final checkpoint a port worker writes loads in the JAX package's
    ``D4MStream.restore``: its cursor is the whole shard and its snapshot
    equals the reference's ingest of the stream, bit for bit."""
    rows, cols, vals = records(seed=17)
    ctl = FleetController(
        config(), n_workers=1, workdir=str(tmp_path / "fleet"),
        serve_config=d4m.ServeConfig(checkpoint_every=4, **SERVE),
        report_interval_s=0.1, env=ENV, device="cpu",
    )
    report = ctl.run(serve.ArraySource(rows, cols, vals, chunk_records=CHUNK),
                     finish_timeout_s=600)
    assert report.conserved and report.records_delivered == TOTAL
    ckpt = ctl.workers[0].last_ckpt
    assert ckpt is not None and ckpt["cursor"] == TOTAL

    want = reference_snapshot(rows, cols, vals)
    ref = jd4m.D4MStream(jd4m.StreamConfig.from_dict(config().to_dict()),
                         checkpoint_dir=ckpt["dir"])
    extra = ref.restore(step=ckpt["step"])
    assert int(extra["cursor"]) == TOTAL and extra["final"]
    got = ref.snapshot(cap=CAP)
    for f in ("rows", "cols", "vals", "nnz", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)))
    assert_assoc_same(report.merged_snapshot(cap=CAP, device="cpu"), want)


def test_controller_without_cuda_raises_before_spawning(tmp_path, monkeypatch):
    """No device and no CUDA: the controller refuses in its constructor,
    before a listener, a directory or a process exists; ``merged_snapshot``
    refuses the same way."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_spawn(*a, **kw):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(controller.subprocess, "Popen", no_spawn)
    workdir = tmp_path / "fleet"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetController(config(), n_workers=2, workdir=str(workdir))
    assert not workdir.exists()

    triple = (np.array([1], np.int32), np.array([2], np.int32), np.array([3.0], np.float32))
    rep = FleetReport(
        n_workers=1, records_in=1, records_delivered=1,
        telemetry=None, per_worker=[], wall_s=1.0, aggregate_rate=1.0,
        restarts=0, snapshot_paths=[None], snapshot_triples=[triple],
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rep.merged_snapshot()
    assert int(rep.merged_snapshot(device="cpu").nnz) == 1


def test_controller_spawns_the_port_worker(tmp_path):
    """The plan names the resolved device and the spawned module is the
    port's worker."""
    ctl = FleetController(config(), n_workers=1, workdir=str(tmp_path / "fleet"),
                          env=ENV, device="cpu")
    with ctl:
        h = ctl.workers[0]
        assert h.pending_plan["device"] == "cpu"
        assert h.proc.args[1:3] == ["-m", "repro_torch.fleet.worker"]
