"""``repro_torch.fleet`` — compose N worker processes into one logical store
(port of ``repro.fleet``).

The paper's 1.9B updates/s is not one fast node: it is 34,000 hierarchical
D4M instances across 1,100 nodes, fed through hierarchical *routing* of
updates to independent instances (arXiv 1902.00846, 2001.06935).  This
subsystem is that outer tier: a fleet of worker processes, each running the
port's ``D4MStream.serve()`` stack unchanged, composed by

* :mod:`repro_torch.fleet.routing` — the **host tier** of the two-level
  hash router.  ``route_host`` consumes the *top* bits of the exact same
  ``key_hash32`` whose *low* end (modulo K) the in-process instance router
  consumes, so (host, instance) assignment is deterministic and disjoint;
* :mod:`repro_torch.fleet.worker` — the worker entry point
  (``python -m repro_torch.fleet.worker``): builds a session from a planned
  ``StreamConfig`` shipped over the control channel, on the device the
  plan names, binds a ``TCPSource`` for its data shard, serves it, and
  reports ``TelemetrySnapshot``s, durable-checkpoint notices and its
  kernels' launch counts back to the controller;
* :mod:`repro_torch.fleet.controller` — :class:`FleetController` spawns
  workers as subprocesses, splits an input source across hosts with
  ``route_host``, journals every routed record until the owning worker's
  checkpoint covers it, detects dead or hung workers and restarts them from
  their last durable checkpoint with cursor-exact replay, and aggregates
  fleet-wide telemetry via ``TelemetrySnapshot.merge`` with conservation
  checks.

Quick start (one card, 4 worker processes)::

    from repro_torch import d4m, fleet, serve

    cfg = d4m.StreamConfig(cuts=(64,), top_capacity=4096, batch_size=128,
                           instances_per_device=2)
    ctl = fleet.FleetController(cfg, n_workers=4, workdir="/tmp/fleet")
    report = ctl.run(serve.RMATSource(100_000, chunk_records=1024))
    print(report.telemetry.ingest_rate, report.records_delivered)
    snap = report.merged_snapshot()      # bit-identical to one-process ingest

Pass ``device="cpu"`` to both for a fleet on the CPU.
"""
from .controller import FleetController, FleetReport, WorkerHandle
from .routing import host_prefix_bits, route_host, split_by_host

__all__ = [
    "FleetController",
    "FleetReport",
    "WorkerHandle",
    "host_prefix_bits",
    "route_host",
    "split_by_host",
]
