"""Fleet benchmark: aggregate served rate vs worker-process count (port of
the reference's ``benchmarks/bench_fleet.py``).

The paper's headline number is an aggregate of independent instances
behind hierarchical routing.  Each point of the hosts sweep spawns
``hosts`` worker processes of :mod:`repro_torch.fleet` (each the full
serve stack over K packed instances, on the device the plan names: the
card, all of them sharing it), routes one R-MAT stream across them with the
two-level hash router, and reports

* **aggregate rate** — unique source records over the controller's wall
  clock (the last worker's ``hello`` to the last report), per fleet size;
* **per-worker rates**, and record conservation (every routed record
  delivered exactly once: ``FleetReport.conserved``), which must hold; the
  merged snapshot (one ``sort_dedup`` call over the workers' snapshots)
  must hold numpy's distinct keys of the stream, each with its count of
  records as its value;
* the **fleet_scaling verdict**: aggregate rate at N workers >=
  ``EFFICIENCY_FLOOR`` x N x the single-worker rate, at the largest N the
  host's cores can run in parallel.

The workers' kernels' launch counts come back in their reports.  The
controller builds the kernels once before it spawns any worker, so the
reference's warm-up fleet (which fills the JAX compilation cache) has no
counterpart here.

Beyond the reference's parameters: ``cuts`` and ``top_capacity`` size each
worker's session, and ``track_degrees`` is the workers' ``ServeConfig``
field (the default's ``True`` keeps host degree vectors per microbatch).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch import d4m, serve
from repro_torch.bench.reporting import BenchmarkReport
from repro_torch.fleet import FleetController

from . import _common

EFFICIENCY_FLOOR = 0.7  # aggregate(N) >= floor * min(N, cores) * aggregate(1)

#: one compute thread a worker (the paper's one core an instance group)
WORKER_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _usable_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover - non-Linux
        return os.cpu_count() or 1


def _run_fleet(n_workers: int, k: int, src, batch: int, top: int, workdir: str, dev,
               cuts=None, track_degrees: bool = True):
    ctl = FleetController(
        _common.stream_config(k, batch, top, src.rows.shape[0], cuts),
        n_workers=n_workers,
        workdir=os.path.join(workdir, f"h{n_workers}"),
        serve_config=None if track_degrees else d4m.ServeConfig(track_degrees=False),
        report_interval_s=0.5,
        env=WORKER_ENV,
        device=str(dev),
    )
    return ctl.run(src)


def _worker_launches(rep) -> dict:
    out = {name: 0 for name in _common.kernel_modules()}
    for w in rep.per_worker:
        out = _common.add_launches(out, w["launches"] or {})
    return out


def main(
    smoke: bool = False,
    hosts_values=(1, 2, 4),
    k: int | None = None,
    total_records: int | None = None,
    chunk: int | None = None,
    batch: int | None = None,
    scale: int | None = None,
    cuts=None,
    top_capacity: int | None = None,
    track_degrees: bool = True,
    device: str = "cuda",
):
    dev = _common.device_of(device)
    k = k if k is not None else (2 if smoke else 4)
    total = total_records if total_records is not None else (
        24_000 if smoke else 400_000
    )
    chunk = chunk if chunk is not None else (1024 if smoke else 4096)
    batch = batch if batch is not None else (256 if smoke else 512)
    scale = scale if scale is not None else (14 if smoke else 18)
    top = top_capacity if top_capacity is not None else int(total * 1.25)
    cores = _usable_cores()
    report = BenchmarkReport("fleet", device=str(dev))
    rates: dict[int, float] = {}
    failures = []
    gen = serve.RMATSource(total, chunk_records=chunk, scale=scale, pregenerate=True)
    rows, cols, vals = (np.concatenate(x) for x in zip(*gen.chunks()))
    want = _common.key_counts(rows, cols)

    with tempfile.TemporaryDirectory(prefix="bench-fleet-") as workdir:
        for hosts in hosts_values:
            src = serve.ArraySource(rows, cols, vals, chunk_records=chunk)
            rep = _run_fleet(hosts, k, src, batch, top, workdir, dev, cuts, track_degrees)
            before = _common.launch_counts()
            merged = rep.merged_snapshot(device=str(dev))
            launches = _common.add_launches(_worker_launches(rep),
                                            _common.launches_since(before))
            merged_nnz, values_exact = int(merged.nnz), _common.holds_counts(merged, want)
            del merged
            _common.release(dev)
            if not rep.conserved:
                failures.append(f"hosts={hosts}: routed {rep.records_in}, delivered "
                                f"{rep.records_delivered}")
            if not values_exact:
                failures.append(f"hosts={hosts}: merged snapshot nnz {merged_nnz} vs "
                                f"{want[0].size} distinct keys, or a key's value is not its "
                                f"count of records")
            rates[hosts] = rep.aggregate_rate
            params = {
                "hosts": hosts, "k_per_device": k, "total_records": total,
                "batch": batch, "rmat_scale": scale,
            }
            if cuts is not None or top_capacity is not None:
                params.update(cuts=list(cuts or ()), top_capacity=top)
            if not track_degrees:
                params["track_degrees"] = False
            worker_rates = [float(w["ingest_rate"] or 0.0) for w in rep.per_worker]
            print(
                f"fleet,aggregate,hosts={hosts},k={k},"
                f"rate={rep.aggregate_rate:,.0f}/s,wall_s={rep.wall_s:.3f},"
                f"conserved={rep.conserved},restarts={rep.restarts},"
                f"merged_nnz={merged_nnz},values_exact={values_exact},launches={launches}",
                flush=True,
            )
            report.add(
                "fleet_rate", params=params,
                updates_per_sec=rep.aggregate_rate, wall_s=rep.wall_s,
                records_delivered=int(rep.records_delivered),
                conserved=bool(rep.conserved),
                restarts=int(rep.restarts),
                worker_rates=worker_rates,
                merged_nnz=merged_nnz,
                nnz_exact=merged_nnz == want[0].size,
                values_exact=values_exact,
                launches=launches,
                **rep.telemetry.serve_counters(),
            )

    # gate the largest fleet the host can run in parallel; a 1-core box can
    # only attest the N=1 leg, but the whole curve still lands in the history
    parallelizable = [h for h in hosts_values if h <= cores]
    gate_hosts = max(parallelizable) if parallelizable else min(hosts_values)
    floor_rate = EFFICIENCY_FLOOR * gate_hosts * rates[min(hosts_values)]
    passed = rates[gate_hosts] >= floor_rate
    scaling = rates[gate_hosts] / max(rates[min(hosts_values)], 1e-9)
    print(
        f"verdict,fleet_scaling,{passed},hosts={gate_hosts},"
        f"scaling={scaling:.2f}x,cores={cores},"
        f"floor={EFFICIENCY_FLOOR}*{gate_hosts}",
        flush=True,
    )
    report.add(
        "fleet_scaling",
        params={
            "hosts": gate_hosts, "k_per_device": k,
            "floor": EFFICIENCY_FLOOR, "usable_cores": cores,
            "max_hosts_measured": int(max(hosts_values)),
        },
        passed=bool(passed),
        scaling={str(h): float(r) for h, r in rates.items()},
    )
    report.write()
    _common.raise_failures("fleet", failures)
    return rates


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--hosts", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--total-records", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    main(
        smoke=args.smoke,
        hosts_values=tuple(args.hosts),
        k=args.k,
        total_records=args.total_records,
        chunk=args.chunk,
        batch=args.batch,
        scale=args.scale,
        device=args.device,
    )
