"""Observability-plane benchmark: what does instrumentation cost? (port of
the reference's ``benchmarks/bench_obs.py``)

* **rate_metrics_off** — an R-MAT stream through the whole serve loop
  (publishing views, so every instrumented stage runs) with
  ``ServeConfig(metrics=False)``, best of ``repeats`` (the two legs' runs
  interleaved, off-on then on-off, where the reference runs every
  metrics-off run first);
* **rate_metrics_on** — the same stream and session shape with
  ``metrics=True``: every dispatch, publish, flush and view build timed into
  live histograms;
* the verdict ``obs_overhead``: the enabled run sustains at least
  ``1 - OVERHEAD_CEILING`` of the disabled rate, the two drained snapshots
  are bit-identical, and a METRICS scrape over a live socket returns
  summaries equal to the in-process registry.

The correctness parts are also their own fields (``bit_identical``,
``scrape_exact``), beside ``within_ceiling``: a false one, or a stream not
conserved, ends the section with an error; a ceiling missed is a
measurement.

Beyond the reference's parameters: ``cuts`` and ``top_capacity`` size the
session, and ``track_degrees`` is the served runs' ``ServeConfig`` field.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import d4m, serve
from repro_torch.bench.reporting import BenchmarkReport
from repro_torch.obs import hist as obs_hist

from . import _common

OVERHEAD_CEILING = 0.02  # enabled may cost at most 2% of the disabled rate

#: ingest-side histograms a scrape cannot perturb (quiescent after feed)
_QUIET_HISTS = ("serve.update_dispatch_ns", "serve.publish_ns",
                "router.flush_ns", "session.view_build_ns")


def _warmup(sess: d4m.D4MStream, r, c, v, batch: int, track_degrees: bool = True) -> None:
    warm = sess.serve(
        serve.ArraySource(r[: 2 * batch], c[: 2 * batch], v[: 2 * batch],
                          chunk_records=batch),
        max_latency_ms=1e9, publish_every=1, track_degrees=track_degrees,
    )
    if not warm.drained:
        raise RuntimeError("obs: the warm-up run did not drain")
    sess.reset()


def _timed_run(k: int, batch: int, top: int, r, c, v, publish_every: int,
               metrics: bool, dev, cuts=None, track_degrees: bool = True):
    """One served run; returns (rate, wall, snap, conserved, launches) where
    snap is the drained snapshot's triples."""
    before = _common.launch_counts()
    sess = d4m.D4MStream(_common.stream_config(k, batch, top, r.shape[0], cuts), device=dev)
    _warmup(sess, r, c, v, batch, track_degrees)
    src = serve.ArraySource(r, c, v, chunk_records=batch)
    server = serve.D4MServer(
        sess, src,
        d4m.ServeConfig(max_latency_ms=1e9, publish_every=publish_every,
                        drain_timeout_s=600.0, metrics=metrics,
                        track_degrees=track_degrees),
    ).start()
    if not server.join(timeout=600):
        raise RuntimeError("obs: the server did not stop")
    report = server.report()
    conserved = bool(report.drained and report.records_fed == r.shape[0]
                     and report.records_dropped == 0)
    s = sess.snapshot()
    nnz = int(s.nnz)
    snap = tuple(x[:nnz].cpu().numpy().copy() for x in (s.rows, s.cols, s.vals))
    launches = _common.launches_since(before)
    del sess, server, s
    _common.release(dev)
    return report.ingest_rate, report.wall_s, snap, conserved, launches


def _timed_legs(repeats: int, **run):
    """Best-of-``repeats`` served ingest rate with metrics off and on, the
    two legs' runs interleaved (off-on, on-off, ...) so that neither leg
    takes the process's first-run costs alone; returns ``{metrics: (rate,
    wall, snap, conserved, launches)}``, snap the leg's last drained
    snapshot triples."""
    out = {False: (0.0, 0.0, None, True, {}), True: (0.0, 0.0, None, True, {})}
    for i in range(repeats):
        for metrics in ((False, True) if i % 2 == 0 else (True, False)):
            rate, wall, snap, ok, launches = _timed_run(metrics=metrics, **run)
            best, best_wall, _, conserved, total = out[metrics]
            if rate > best:
                best, best_wall = rate, wall
            out[metrics] = (best, best_wall, snap, conserved and ok,
                            _common.add_launches(total, launches))
    return out


def _quiesce_hists(server, names, timeout_s: float = 30.0) -> None:
    """Wait until the named histograms stop changing: the feed thread
    publishes the view before it records its publish/view-build spans, so
    a scrape issued the instant a covering view appears can race the last
    ``record()`` calls."""
    prev = None
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        cur = {n: server.metrics.dump()["histograms"][n] for n in names}
        if cur == prev:
            return
        prev = cur
        time.sleep(0.05)
    raise RuntimeError("obs: the ingest-side histograms never went quiescent")


def _scrape_exact(k: int, batch: int, top: int, r, c, v,
                  publish_every: int, dev, cuts=None, track_degrees: bool = True) -> bool:
    """Serve over a loopback socket with metrics on, scrape through the
    METRICS op, and compare the wire summaries to the in-process registry
    for every quiescent histogram: equal integers, bit for bit."""
    n = r.shape[0]
    sess = d4m.D4MStream(_common.stream_config(k, batch, top, r.shape[0], cuts), device=dev)
    _warmup(sess, r, c, v, batch, track_degrees)
    src = serve.TCPSource(port=0, encoding="binary", linger=False)
    server = serve.D4MServer(
        sess, src,
        d4m.ServeConfig(max_latency_ms=1e9, publish_every=publish_every,
                        drain_timeout_s=600.0, metrics=True,
                        track_degrees=track_degrees),
    ).start()
    exact = True
    with serve.QueryClient("127.0.0.1", src.port, timeout_s=120.0) as qc:
        for lo in range(0, n, 4 * batch):
            qc.insert(r[lo:lo + 4 * batch], c[lo:lo + 4 * batch],
                      v[lo:lo + 4 * batch])
        deadline = time.monotonic() + 120
        while True:
            rep = qc.request("stats")
            if not rep.ok:
                raise RuntimeError(f"obs: stats query failed: {rep.error}")
            if rep.scalars["records"] == n:
                break
            if time.monotonic() >= deadline:
                raise RuntimeError("obs: the stream never fully published")
            time.sleep(0.01)
        _quiesce_hists(server, _QUIET_HISTS)
        rep = qc.metrics()
        if not rep.ok:
            raise RuntimeError(f"obs: metrics scrape failed: {rep.error}")
        local = server.metrics.dump()["histograms"]
        for name in _QUIET_HISTS:
            st = local[name]
            if obs_hist.state_count(st) == 0:
                exact = False
            if not np.array_equal(rep.arrays[f"hist.{name}.counts"],
                                  np.asarray(st["counts"], np.int64)):
                exact = False
            if rep.scalars["summaries"].get(name) \
                    != obs_hist.summarize_state(st):
                exact = False
    if not server.join(timeout=600):
        raise RuntimeError("obs: the server did not stop")
    del sess, server
    _common.release(dev)
    return exact


def _bit_identical(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def main(
    smoke: bool = False,
    k: int = 8,
    batches: int | None = None,
    batch: int | None = None,
    scale: int | None = None,
    publish_every: int | None = None,
    repeats: int = 3,
    cuts=None,
    top_capacity: int | None = None,
    track_degrees: bool = True,
    device: str = "cuda",
):
    dev = _common.device_of(device)
    batches = batches if batches is not None else (60 if smoke else 400)
    batch = batch if batch is not None else (256 if smoke else 512)
    scale = scale if scale is not None else (14 if smoke else 18)
    publish_every = publish_every if publish_every is not None else (
        6 if smoke else 10
    )
    if batches % publish_every:
        raise ValueError(f"batches ({batches}) must be a multiple of publish_every ({publish_every})")
    top = top_capacity if top_capacity is not None else int(batches * batch * 1.25)
    r, c, v = _common.rmat_records(batches, batch, scale)
    params = {
        "k_per_device": k, "batches": batches, "batch": batch,
        "rmat_scale": scale, "publish_every": publish_every,
        "repeats": repeats,
    }
    if cuts is not None or top_capacity is not None:
        params.update(cuts=list(cuts or ()), top_capacity=top)
    if not track_degrees:
        params["track_degrees"] = False
    shape = dict(cuts=cuts, track_degrees=track_degrees)
    report = BenchmarkReport("obs", device=str(dev))

    legs = _timed_legs(repeats, k=k, batch=batch, top=top, r=r, c=c, v=v,
                       publish_every=publish_every, dev=dev, **shape)
    off_rate, off_wall, off_snap, off_ok, off_l = legs[False]
    print(f"obs,metrics_off,k={k},rate={off_rate:,.0f}/s,"
          f"wall_s={off_wall:.3f},conserved={off_ok},launches={off_l}", flush=True)
    report.add("rate_metrics_off", params=params,
               updates_per_sec=off_rate, wall_s=off_wall, conserved=off_ok, launches=off_l)

    on_rate, on_wall, on_snap, on_ok, on_l = legs[True]
    overhead = 1.0 - on_rate / off_rate
    print(f"obs,metrics_on,k={k},rate={on_rate:,.0f}/s,"
          f"wall_s={on_wall:.3f},overhead={overhead:.4f},conserved={on_ok},"
          f"launches={on_l}", flush=True)
    report.add("rate_metrics_on", params=params,
               updates_per_sec=on_rate, wall_s=on_wall,
               overhead=float(overhead), conserved=on_ok, launches=on_l)

    bit = _bit_identical(off_snap, on_snap)
    exact = _scrape_exact(k, batch, top, r, c, v, publish_every, dev, **shape)
    within = bool(overhead <= OVERHEAD_CEILING)
    passed = bool(within and bit and exact)
    print(f"verdict,obs_overhead,{passed},k={k},overhead={overhead:.4f},"
          f"ceiling={OVERHEAD_CEILING},bit_identical={bit},"
          f"scrape_exact={exact}")
    report.add(
        "obs_overhead",
        params={**params, "ceiling": OVERHEAD_CEILING},
        passed=passed,
        overhead=float(overhead),
        within_ceiling=within,
        bit_identical=bool(bit),
        scrape_exact=bool(exact),
    )
    report.write()
    failures = []
    if not bit:
        failures.append("the metrics-on snapshot differs from the metrics-off one")
    if not exact:
        failures.append("the METRICS scrape differs from the in-process registry")
    if not (off_ok and on_ok):
        failures.append("a served stream was not conserved")
    _common.raise_failures("obs", failures)
    return {"overhead": overhead, "bit_identical": bit, "scrape_exact": exact}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--batches", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--publish-every", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    main(
        smoke=args.smoke,
        k=args.k,
        batches=args.batches,
        batch=args.batch,
        scale=args.scale,
        publish_every=args.publish_every,
        repeats=args.repeats,
        device=args.device,
    )
