"""Serving benchmark: sustained end-to-end ingest rate vs. the raw engine
(port of the reference's ``benchmarks/bench_serve.py``).

* **raw engine rate** — the ceiling: a timed ``update`` loop over
  pre-routed host ``[K, B]`` batches (no ingress path), on the engine the
  session picks (``cuda`` at K>1, ``single`` at K=1 on the card);
* **served rate** — the same records pushed through the whole
  :mod:`repro_torch.serve` loop from pre-materialized arrays (batching,
  routing, bounded queue, feed thread, pinned staging), start to drain;
* **feed_efficiency** = served / raw, with the verdict that the serve loop
  sustains >= 50% of the raw rate at the largest K;
* a **socket rate** leg: the same path through a loopback TCP socket (text
  wire format).

Every run must conserve the stream (all records fed, none dropped) and end
with a snapshot that holds numpy's distinct keys of its stream, each with
its count of records as its value (every record carries 1).

Beyond the reference's parameters: ``cuts`` and ``top_capacity`` size the
session (the defaults derive from ``batch``; ``top_capacity`` may name one
capacity a K of ``k_values``, as the ``single`` engine at K=1 holds the
whole stream in one top layer), ``track_degrees`` is the
served runs' ``ServeConfig`` field (the default's ``True`` keeps host
degree vectors per microbatch), and ``socket_records`` feeds the socket leg
only the stream's first records (all by default).
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch import d4m, serve
from repro_torch.bench.reporting import BenchmarkReport
from repro_torch.core.telemetry import TelemetrySnapshot

from . import _common

EFFICIENCY_FLOOR = 0.5  # served must reach this fraction of raw at K=8


def _workload(k: int, batches: int, batch: int, scale: int, seed: int = 0):
    """One flat record stream, plus its pre-routed per-batch host arrays
    (the raw-engine input), from the same R-MAT edges."""
    src = serve.RMATSource(
        batches * batch, chunk_records=batch, scale=scale, seed=seed,
        pregenerate=True,
    )
    rows, cols, vals = [], [], []
    for r, c, v in src.chunks():
        rows.append(r)
        cols.append(c)
        vals.append(v)
    flat = (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals))
    routed = [
        serve.route_numpy(rows[t], cols[t], vals[t], k, batch)[:3]
        for t in range(batches)
    ]
    return flat, routed


def run_raw(sess: d4m.D4MStream, routed, batch: int) -> tuple[float, float]:
    """Timed update loop over pre-routed host batches: what the serve
    loop's feed thread feeds (the same numpy arrays, the same upload, the
    same update step) with no ingress machinery."""
    squeeze = sess.kind == "single"

    def step(b):
        r, c, v = b
        if squeeze:
            r, c, v = r[0], c[0], v[0]
        sess.update(r, c, v)

    step(routed[0])  # warm-up
    _common.sync(sess.device)
    sess.reset()
    _common.sync(sess.device)
    t0 = time.perf_counter()
    for b in routed:
        step(b)
    _common.sync(sess.device)
    dt = time.perf_counter() - t0
    return len(routed) * batch / dt, dt


def run_served(sess: d4m.D4MStream, flat, batch: int, track_degrees: bool = True):
    """Timed full serve loop from a pre-materialized source."""
    r, c, v = flat
    warm = sess.serve(
        serve.ArraySource(r[: 2 * batch], c[: 2 * batch], v[: 2 * batch],
                          chunk_records=batch),
        max_latency_ms=1e9, track_degrees=track_degrees,
    )
    if not warm.drained:
        raise RuntimeError("serve: the warm-up run did not drain")
    sess.reset()
    return sess.serve(serve.ArraySource(r, c, v, chunk_records=batch), max_latency_ms=1e9,
                      track_degrees=track_degrees)


def run_socket(sess: d4m.D4MStream, flat, batch: int, track_degrees: bool = True):
    """The same loop through a loopback TCP socket (text wire format)."""
    r, c, v = flat
    sess.reset()
    src = serve.TCPSource(port=0).start()
    sender = threading.Thread(
        target=serve.send_triples,
        args=("127.0.0.1", src.port, r, c, v),
        kwargs={"chunk_records": 4 * batch},
    )
    sender.start()
    report = sess.serve(src, max_latency_ms=1e9, track_degrees=track_degrees)
    sender.join(timeout=600)
    return report


def _conserved(report, n: int) -> bool:
    return bool(report.drained and report.records_fed == n and report.records_dropped == 0
                and report.records_in == report.records_fed + report.records_dropped)


def main(
    smoke: bool = False,
    k_values=(1, 8),
    batches: int | None = None,
    batch: int | None = None,
    scale: int | None = None,
    cuts=None,
    top_capacity=None,
    track_degrees: bool = True,
    socket_records: int | None = None,
    device: str = "cuda",
):
    dev = _common.device_of(device)
    batches = batches if batches is not None else (60 if smoke else 400)
    batch = batch if batch is not None else (256 if smoke else 512)
    scale = scale if scale is not None else (14 if smoke else 18)
    if top_capacity is None:
        tops = [int(batches * batch * 1.25)] * len(k_values)
    elif isinstance(top_capacity, (list, tuple)):
        if len(top_capacity) != len(k_values):
            raise ValueError(f"top_capacity names {len(top_capacity)} capacities for "
                             f"{len(k_values)} values of K")
        tops = [int(t) for t in top_capacity]
    else:
        tops = [int(top_capacity)] * len(k_values)
    report = BenchmarkReport("serve", device=str(dev))
    efficiency = {}
    served_tels = []
    failures = []
    for k, top in zip(k_values, tops):
        flat, routed = _workload(k, batches, batch, scale)
        n = flat[0].shape[0]
        want = _common.key_counts(flat[0], flat[1])
        n_sock = n if socket_records is None else min(int(socket_records), n)
        sock_flat = tuple(x[:n_sock] for x in flat)
        sock_want = want if n_sock == n else _common.key_counts(*sock_flat[:2])
        params = {
            "k_per_device": k, "batches": batches, "batch": batch,
            "rmat_scale": scale,
        }
        if cuts is not None or top_capacity is not None:
            params.update(cuts=list(cuts or ()), top_capacity=top)
        if not track_degrees:
            params["track_degrees"] = False
        sess = d4m.D4MStream(_common.stream_config(k, batch, top, n, cuts), device=dev)
        params["engine"] = sess.kind
        before = _common.launch_counts()
        raw_rate, raw_wall = run_raw(sess, routed, batch)
        launches = _common.launches_since(before)
        snap = sess.snapshot()
        raw_nnz, raw_values = int(snap.nnz), _common.holds_counts(snap, want)
        print(
            f"serve,raw_engine,k={k},engine={sess.kind},rate={raw_rate:,.0f}/s,"
            f"wall_s={raw_wall:.3f},nnz={raw_nnz},values_exact={raw_values},"
            f"launches={launches}", flush=True,
        )
        report.add("raw_engine_rate", params=params, updates_per_sec=raw_rate, wall_s=raw_wall,
                   nnz=raw_nnz, nnz_exact=raw_nnz == want[0].size, values_exact=raw_values,
                   launches=launches)
        del sess, snap
        _common.release(dev)

        sess = d4m.D4MStream(_common.stream_config(k, batch, top, n, cuts), device=dev)
        before = _common.launch_counts()
        served = run_served(sess, flat, batch, track_degrees)
        launches = _common.launches_since(before)
        tel = served.telemetry
        snap = sess.snapshot()
        served_nnz, served_values = int(snap.nnz), _common.holds_counts(snap, want)
        efficiency[k] = served.ingest_rate / raw_rate
        conserved = _conserved(served, n)
        print(
            f"serve,served,k={k},rate={served.ingest_rate:,.0f}/s,"
            f"wall_s={served.wall_s:.3f},efficiency={efficiency[k]:.2f},"
            f"blocked={tel.blocked_events},conserved={conserved},nnz={served_nnz},"
            f"values_exact={served_values},launches={launches}", flush=True,
        )
        served_tels.append(tel)
        report.add(
            "served_rate", params=params,
            updates_per_sec=served.ingest_rate, wall_s=served.wall_s,
            efficiency=efficiency[k],
            conserved=conserved, nnz=served_nnz, nnz_exact=served_nnz == want[0].size,
            values_exact=served_values, launches=launches,
            **tel.serve_counters(),
        )

        del snap
        before = _common.launch_counts()
        sock = run_socket(sess, sock_flat, batch, track_degrees)
        launches = _common.launches_since(before)
        snap = sess.snapshot()
        sock_nnz, sock_values = int(snap.nnz), _common.holds_counts(snap, sock_want)
        sock_conserved = _conserved(sock, n_sock)
        sock_params = params if n_sock == n else {**params, "socket_records": n_sock}
        print(
            f"serve,socket,k={k},records={n_sock},rate={sock.ingest_rate:,.0f}/s,"
            f"wall_s={sock.wall_s:.3f},conserved={sock_conserved},nnz={sock_nnz},"
            f"values_exact={sock_values},launches={launches}", flush=True,
        )
        report.add("socket_rate", params=sock_params,
                   updates_per_sec=sock.ingest_rate, wall_s=sock.wall_s,
                   conserved=sock_conserved, nnz=sock_nnz,
                   nnz_exact=sock_nnz == sock_want[0].size, values_exact=sock_values,
                   launches=launches)
        del sess, snap
        _common.release(dev)
        for leg, ok in (("served", conserved), ("socket", sock_conserved)):
            if not ok:
                failures.append(f"k={k} {leg}: records not conserved")
        for leg, got, ok, keys in (("raw", raw_nnz, raw_values, want[0].size),
                                   ("served", served_nnz, served_values, want[0].size),
                                   ("socket", sock_nnz, sock_values, sock_want[0].size)):
            if not ok:
                failures.append(f"k={k} {leg}: snapshot nnz {got} vs {keys} distinct keys, "
                                f"or a key's value is not its count of records")

    totals = TelemetrySnapshot.merge(served_tels)
    report.add(
        "served_totals",
        params={"k_values": [int(k) for k in k_values]},
        **totals.serve_counters(),
    )

    gate_k = max(k_values)
    passed = efficiency[gate_k] >= EFFICIENCY_FLOOR
    print(
        f"verdict,feed_efficiency,{passed},k={gate_k},"
        f"efficiency={efficiency[gate_k]:.2f},floor={EFFICIENCY_FLOOR}"
    )
    report.add(
        "feed_efficiency",
        params={"k_per_device": gate_k, "floor": EFFICIENCY_FLOOR},
        passed=bool(passed),
        efficiency={str(k): float(e) for k, e in efficiency.items()},
    )
    report.write()
    _common.raise_failures("serve", failures)
    return efficiency


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--k", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--batches", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    main(
        smoke=args.smoke,
        k_values=tuple(args.k),
        batches=args.batches,
        batch=args.batch,
        scale=args.scale,
        device=args.device,
    )
