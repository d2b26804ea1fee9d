"""Fleet chaos and fleet-wide metrics of ``repro_torch.fleet``, on the CPU:
crash, crash-loop, hang and journal failure against real port worker
subprocesses, each held to the reference's invariant class, and the
controller's merged scrape conserving every worker's event counts.

* recoverable faults (one crash, one hang — scoped to generation 0 so the
  revival runs clean) drain to a merged snapshot **bit-identical** to the
  JAX single-process snapshot;
* unrecoverable faults (a worker that crashes in every incarnation, a
  journal that rejects an append) end with **exact accounting**:
  ``records_delivered + records_quarantined == records_in``, the
  quarantined key-range surfaced, and ``merged_snapshot`` refusing.

Mirrors ``tests/faults/test_fleet_chaos.py`` and
``tests/obs/test_fleet_metrics.py``; workers run with ``device="cpu"``.
"""
import json
import os

import numpy as np
import pytest

from repro_torch import d4m, serve
from repro_torch.faults import FaultPlan, Trigger
from repro_torch.fleet import FleetController
from repro_torch.fleet.routing import host_key_range
from repro_torch.obs import hist as obs_hist

from _torch_fleet import (
    CAP, CHUNK, ENV, SERVE, TOTAL, assert_bit_identical, config, records,
    reference_snapshot,
)

_SEEDS = os.path.join(os.path.dirname(__file__), "faults", "seeds.json")


def _fleet_seed() -> int:
    with open(_SEEDS) as f:
        return json.load(f)["fleet_seed"]


def _controller(tmp_path, **kw):
    kw.setdefault("serve_config", d4m.ServeConfig(**SERVE))
    return FleetController(
        config(), n_workers=2, workdir=str(tmp_path / "fleet"),
        report_interval_s=0.1, env=ENV, device="cpu", **kw,
    )


def test_crash_in_generation_zero_recovers_bit_identical(tmp_path):
    """worker.crash_after_n_batches scoped to generation 0: the victim
    hard-exits mid-stream, the controller revives it from the last acked
    checkpoint (or fresh), replays the journal tail, and the drained fleet
    is bit-identical to the reference's single-process ingest."""
    rows, cols, vals = records(seed=_fleet_seed())
    faults = FaultPlan().add(
        "worker.crash_after_n_batches", Trigger.once_at(4),
        only_worker=1, only_generation=0,
    )
    ctl = _controller(tmp_path, faults=faults,
                      serve_config=d4m.ServeConfig(checkpoint_every=2, **SERVE))
    report = ctl.run(serve.ArraySource(rows, cols, vals, chunk_records=CHUNK),
                     finish_timeout_s=600)
    assert report.restarts == 1, "one crash, one clean revival"
    assert not report.quarantined
    assert report.conserved
    assert report.records_in == report.records_delivered == TOTAL
    assert ctl.workers[1].generation == 1
    assert_bit_identical(report.merged_snapshot(cap=CAP, device="cpu"),
                         reference_snapshot(rows, cols, vals))


def test_crash_loop_ends_quarantined_with_exact_accounting(tmp_path):
    """An unscoped crash spec re-fires in every incarnation: after
    max_restarts_per_worker failed revivals the slot is quarantined, its
    key-range and journaled-but-undelivered count surface in the report,
    the ledger still balances exactly, and merged_snapshot refuses."""
    rows, cols, vals = records(seed=7)
    faults = FaultPlan().add(
        "worker.crash_after_n_batches", Trigger.nth(1), only_worker=1,
    )
    ctl = _controller(tmp_path, faults=faults, max_restarts_per_worker=2)
    with ctl:
        for lo in range(0, TOTAL, CHUNK):
            ctl.push(rows[lo:lo + CHUNK], cols[lo:lo + CHUNK], vals[lo:lo + CHUNK])
            ctl.poll_workers()
        report = ctl.finish(timeout_s=600)

    assert len(report.quarantined) == 1
    q = report.quarantined[0]
    assert q["worker"] == 1
    assert (q["key_hash_lo"], q["key_hash_hi"]) == host_key_range(1, 2)
    assert q["restarts"] == 2, "every allowed revival was burned"
    assert q["journaled"] == ctl.workers[1].journal.total
    assert q["undelivered"] == q["journaled"] - q["delivered"]
    assert report.records_quarantined == q["undelivered"] > 0
    assert report.per_worker[1]["quarantined"] is True
    assert report.conserved
    assert report.records_in == TOTAL
    assert report.records_delivered + report.records_quarantined == TOTAL
    with pytest.raises(RuntimeError, match="quarantined"):
        report.merged_snapshot(cap=CAP, device="cpu")


def test_hung_worker_detected_by_heartbeat_and_recovered(tmp_path):
    """worker.hang scoped to generation 0: the process stays alive with
    every socket open but stops reporting; only the heartbeat deadline can
    see it.  The controller SIGKILLs and revives it, and the fleet drains
    bit-identical."""
    rows, cols, vals = records(seed=5)
    faults = FaultPlan().add(
        "worker.hang", Trigger.nth(1), only_worker=1, only_generation=0,
    )
    ctl = _controller(
        tmp_path, faults=faults,
        serve_config=d4m.ServeConfig(checkpoint_every=2, **SERVE),
        # the healthy cadence is one control message per 0.1 s and the
        # deadline arms at each incarnation's hello (startup is off the
        # clock): 8 s is an 80x margin that still catches the hang quickly
        heartbeat_timeout_s=8.0,
    )
    # the hang site fires in the worker's telemetry loop, whose first turn
    # comes report_interval_s after hello: a paced source keeps the stream
    # open past it (an unpaced one can drain first on a fast CPU)
    report = ctl.run(serve.ArraySource(rows, cols, vals, chunk_records=CHUNK, throttle_s=0.05),
                     finish_timeout_s=600)
    assert report.restarts >= 1, "the hang must be detected as a death"
    assert not report.quarantined
    assert report.conserved
    assert report.records_in == report.records_delivered == TOTAL
    assert_bit_identical(report.merged_snapshot(cap=CAP, device="cpu"),
                         reference_snapshot(rows, cols, vals))


def test_journal_disk_full_rejects_before_any_send(tmp_path):
    """controller.journal_disk_full: the append raises *before* the part
    is counted or sent, so records_in counts only accepted records and the
    ledger still balances."""
    rows, cols, vals = records(seed=3)
    faults = FaultPlan().add("controller.journal_disk_full", Trigger.once_at(600))
    ctl = _controller(tmp_path, faults=faults)
    rejected = 0
    with ctl:
        for lo in range(0, TOTAL, CHUNK):
            try:
                ctl.push(rows[lo:lo + CHUNK], cols[lo:lo + CHUNK], vals[lo:lo + CHUNK])
            except OSError:
                rejected += 1
        report = ctl.finish(timeout_s=600)

    assert rejected == 1, "the once_at spec rejects exactly one append"
    assert faults.summary()["controller.journal_disk_full"]["fires"] == 1
    assert report.records_in < TOTAL, "rejected records are not counted"
    assert report.conserved
    assert report.records_delivered == report.records_in
    assert not report.quarantined


def test_fleet_metrics_scrape_conserves_counts(tmp_path):
    """The controller's merged scrape conserves every worker's event
    counts exactly: the merged ``serve.update_dispatch_ns`` histogram holds
    the sum of the per-worker bucket counts, equal to the fleet's
    ``batches_fed``; the push histogram and heartbeat gauges join it."""
    rows, cols, vals = records(1024, seed=13)
    ctl = _controller(tmp_path, metrics=True, heartbeat_timeout_s=60.0)
    report = ctl.run(serve.ArraySource(rows, cols, vals, chunk_records=256),
                     finish_timeout_s=600)
    assert report.conserved and report.records_in == 1024

    dumps = [h.metrics_dump for h in ctl.workers]
    assert all(d is not None for d in dumps)
    merged = ctl.metrics()
    name = "serve.update_dispatch_ns"
    per_worker = [obs_hist.state_count(d["histograms"][name]) for d in dumps]
    assert all(n > 0 for n in per_worker)
    merged_st = merged["histograms"][name]
    assert obs_hist.state_count(merged_st) == sum(per_worker)
    np.testing.assert_array_equal(
        np.asarray(merged_st["counts"]),
        np.sum([d["histograms"][name]["counts"] for d in dumps], axis=0),
    )
    assert merged_st["max_ns"] == max(d["histograms"][name]["max_ns"] for d in dumps)
    assert obs_hist.state_count(merged_st) == int(report.telemetry.batches_fed)
    assert obs_hist.state_count(merged["histograms"]["fleet.push_ns"]) > 0
    tel_hist = report.telemetry.histograms
    assert tel_hist is not None
    assert obs_hist.state_count(tel_hist[name]) == sum(per_worker)
    hb = [k for k in merged["gauges"] if k.startswith("fleet.heartbeat_age_s")]
    assert len(hb) == 2
