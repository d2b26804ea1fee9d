"""Query-plane benchmark: what does querying a live stream cost? (port of
the reference's ``benchmarks/bench_query.py``)

* **ingest_only_rate** — an R-MAT stream pushed through a loopback TCP
  socket into a served session with the query plane armed
  (``publish_every`` set, views publishing) and no client asking;
* **mixed_rate** — the same stream and path while a second connection asks
  the live views a rotating mix (stats / degrees / top_k / row / get), with
  the sustained query QPS on the side;
* the verdict ``query_cost``: the mixed run sustains at least
  ``1 - COST_CEILING`` of the ingest-only rate AND the final live view's
  degrees, answered over the wire, are bit-identical to the drained
  session's snapshot reduction.

The correctness part is also its own field, ``bit_identical``, beside
``within_ceiling``: a false ``bit_identical`` or a stream not conserved
ends the section with an error; a ceiling missed is a measurement.

Beyond the reference's parameters: ``cuts`` and ``top_capacity`` size the
session, and ``track_degrees`` is the served runs' ``ServeConfig`` field.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch import d4m, serve
from repro_torch.bench.reporting import BenchmarkReport
from repro_torch.core import analytics

from . import _common

COST_CEILING = 0.10  # mixed ingest may cost at most this fraction of baseline


def _warmup(sess: d4m.D4MStream, r, c, v, batch: int, track_degrees: bool = True) -> None:
    """Run the update, publish and query paths once (the kernels build at
    first use), then reset the state."""
    warm = sess.serve(
        serve.ArraySource(r[: 2 * batch], c[: 2 * batch], v[: 2 * batch],
                          chunk_records=batch),
        max_latency_ms=1e9, publish_every=1, track_degrees=track_degrees,
    )
    if not warm.drained:
        raise RuntimeError("query: the warm-up run did not drain")
    view = sess.latest_view()
    view.degrees()
    view.top_k(10, "out")
    view.row(0)
    view.get(0, 0)
    view.stats()
    sess.reset()


def _hammer(port: int, n_records: int, space: int, sent_done, out) -> None:
    """Rotate the query mix against the live views until a view covering
    the whole stream has answered a degrees query, then disconnect (the
    open client counts as a producer, so staying would stall the drain)."""
    rng = np.random.default_rng(1)
    count = 0
    t0 = time.perf_counter()
    with serve.QueryClient("127.0.0.1", port, encoding="binary",
                           timeout_s=120.0) as qc:
        while True:
            op = count % 5
            if op == 0:
                rep = qc.request("stats")
            elif op == 1:
                rep = qc.request("degrees")
            elif op == 2:
                rep = qc.request("top_k", k=10, by="out")
            elif op == 3:
                rep = qc.request("row", r=int(rng.integers(0, space)))
            else:
                rep = qc.request(
                    "get", r=int(rng.integers(0, space)),
                    c=int(rng.integers(0, space)),
                )
            if not rep.ok:
                raise RuntimeError(f"query failed: {rep.error}")
            count += 1
            if sent_done.is_set():
                rep = qc.request("degrees")
                count += 1
                if rep.ok and rep.view_records == n_records:
                    out["final_degrees"] = rep
                    break
                time.sleep(0.002)  # the covering view is one publish away
    dt = time.perf_counter() - t0
    out["queries"] = count
    out["qps"] = count / dt


def _serve_tcp(sess, r, c, v, batch: int, publish_every: int, space: int,
               with_queries: bool, track_degrees: bool = True):
    src = serve.TCPSource(port=0, encoding="binary", linger=False)
    server = serve.D4MServer(
        sess, src,
        d4m.ServeConfig(max_latency_ms=1e9, publish_every=publish_every,
                        drain_timeout_s=600.0, track_degrees=track_degrees),
    ).start()
    out = {}
    sent_done = threading.Event()
    hammerer = None
    if with_queries:
        hammerer = threading.Thread(
            target=_hammer, args=(src.port, r.shape[0], space, sent_done, out),
            daemon=True,
        )
        hammerer.start()
    sent = serve.send_triples(
        "127.0.0.1", src.port, r, c, v,
        encoding="binary", chunk_records=4 * batch,
    )
    sent_done.set()
    if hammerer is not None:
        hammerer.join(timeout=600)
        if hammerer.is_alive() or "final_degrees" not in out:
            raise RuntimeError("query: the hammer never saw the full view")
    if not server.join(timeout=600):
        raise RuntimeError("query: the server did not stop")
    report = server.report()
    conserved = bool(
        sent == r.shape[0] and report.drained and report.records_fed == r.shape[0]
        and report.records_dropped == 0 and report.malformed == 0
    )
    return report, out, conserved


def _bit_identical(sess: d4m.D4MStream, reply) -> bool:
    """The wire-served live-view degrees vs the drained snapshot reduction."""
    want_out, want_in = analytics.degrees(
        sess.snapshot(), cap=sess.plan.snapshot_cap, sr=sess.sr
    )

    def live(a):
        n = int(a.nnz)
        return a.rows[:n].cpu().numpy(), a.vals[:n].cpu().numpy()

    for ids_key, vals_key, want in (
        ("out_ids", "out_vals", want_out), ("in_ids", "in_vals", want_in)
    ):
        ids, vals = live(want)
        if not np.array_equal(reply.arrays[ids_key], ids):
            return False
        got = np.asarray(reply.arrays[vals_key], np.float32)
        if not np.array_equal(got.view(np.uint32),
                              vals.astype(np.float32).view(np.uint32)):
            return False
    return True


def main(
    smoke: bool = False,
    k: int = 8,
    batches: int | None = None,
    batch: int | None = None,
    scale: int | None = None,
    publish_every: int | None = None,
    cuts=None,
    top_capacity: int | None = None,
    track_degrees: bool = True,
    device: str = "cuda",
):
    dev = _common.device_of(device)
    batches = batches if batches is not None else (60 if smoke else 400)
    batch = batch if batch is not None else (256 if smoke else 512)
    scale = scale if scale is not None else (14 if smoke else 18)
    # the last periodic publish must cover the whole stream (the final
    # drain view only appears after the query client disconnects)
    publish_every = publish_every if publish_every is not None else (
        6 if smoke else 10
    )
    if batches % publish_every:
        raise ValueError(f"batches ({batches}) must be a multiple of publish_every ({publish_every})")
    top = top_capacity if top_capacity is not None else int(batches * batch * 1.25)
    space = 1 << scale
    r, c, v = _common.rmat_records(batches, batch, scale)
    report = BenchmarkReport("query", device=str(dev))

    sess = d4m.D4MStream(_common.stream_config(k, batch, top, r.shape[0], cuts), device=dev)
    params = {
        "k_per_device": k, "batches": batches, "batch": batch,
        "rmat_scale": scale, "publish_every": publish_every, "engine": sess.kind,
    }
    if cuts is not None or top_capacity is not None:
        params.update(cuts=list(cuts or ()), top_capacity=top)
    if not track_degrees:
        params["track_degrees"] = False
    _warmup(sess, r, c, v, batch, track_degrees)
    before = _common.launch_counts()
    only, _, only_conserved = _serve_tcp(sess, r, c, v, batch, publish_every, space,
                                         with_queries=False, track_degrees=track_degrees)
    launches = _common.launches_since(before)
    print(
        f"query,ingest_only,k={k},rate={only.ingest_rate:,.0f}/s,"
        f"wall_s={only.wall_s:.3f},"
        f"views={only.telemetry['views_published']},conserved={only_conserved},"
        f"launches={launches}", flush=True,
    )
    report.add(
        "ingest_only_rate", params=params,
        updates_per_sec=only.ingest_rate, wall_s=only.wall_s,
        views_published=int(only.telemetry["views_published"]),
        conserved=only_conserved, launches=launches,
    )

    del sess
    _common.release(dev)
    sess = d4m.D4MStream(_common.stream_config(k, batch, top, r.shape[0], cuts), device=dev)
    _warmup(sess, r, c, v, batch, track_degrees)
    before = _common.launch_counts()
    mixed, out, mixed_conserved = _serve_tcp(sess, r, c, v, batch, publish_every, space,
                                             with_queries=True, track_degrees=track_degrees)
    launches = _common.launches_since(before)
    cost = 1.0 - mixed.ingest_rate / only.ingest_rate
    print(
        f"query,mixed,k={k},rate={mixed.ingest_rate:,.0f}/s,"
        f"wall_s={mixed.wall_s:.3f},qps={out['qps']:,.0f}/s,"
        f"queries={out['queries']},cost={cost:.3f},conserved={mixed_conserved},"
        f"launches={launches}", flush=True,
    )
    report.add(
        "mixed_rate", params=params,
        updates_per_sec=mixed.ingest_rate, wall_s=mixed.wall_s,
        query_qps=out["qps"], queries_served=int(out["queries"]),
        ingest_cost=cost, conserved=mixed_conserved, launches=launches,
    )

    bit = _bit_identical(sess, out["final_degrees"])
    del sess
    _common.release(dev)
    within = bool(cost <= COST_CEILING)
    passed = bool(within and bit)
    print(
        f"verdict,query_cost,{passed},k={k},cost={cost:.3f},"
        f"ceiling={COST_CEILING},bit_identical={bit}"
    )
    report.add(
        "query_cost",
        params={**params, "ceiling": COST_CEILING},
        passed=passed,
        ingest_cost=float(cost),
        within_ceiling=within,
        bit_identical=bool(bit),
        query_qps=float(out["qps"]),
    )
    report.write()
    failures = []
    if not bit:
        failures.append("the live view's degrees differ from the drained snapshot's")
    if not (only_conserved and mixed_conserved):
        failures.append("a served stream was not conserved")
    _common.raise_failures("query", failures)
    return {"cost": cost, "qps": out["qps"], "bit_identical": bit}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--batches", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--publish-every", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    main(
        smoke=args.smoke,
        k=args.k,
        batches=args.batches,
        batch=args.batch,
        scale=args.scale,
        publish_every=args.publish_every,
        device=args.device,
    )
