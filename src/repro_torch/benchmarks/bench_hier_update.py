"""Paper Figs. 4 & 5: streaming update rate vs. number and spacing of cuts
(port of the reference's ``benchmarks/bench_hier_update.py``).

One instance (the ``single`` engine, K=1: each group canonicalized by the
``sort_dedup`` kernel and merged into layer 1 by ``merge_add``, then the
cond cascade of ``merge_add``s), an R-MAT power-law stream inserted in fixed
groups; the instantaneous rate of every group and the cumulative rate, for
0 / 2 / 4 / 8 cuts and close vs. wide cut spacing (Fig. 3).

The stream is drawn once per ``(seed, total_edges, group_size, scale)`` on
the host (``repro_torch.data.rmat``, numpy), uploaded to the device outside
the timed window, and reused by all four cut schedules; each group is timed
to ``torch.cuda.synchronize()``.  Every schedule's snapshot must hold
numpy's distinct keys of the stream, each with its count of edges as its
value, with no overflow (``nnz``, as in the reference, sums the layers,
where a key may sit in more than one).

Expected shape (the paper's claims): with 0 cuts the rate decays as the
one layer grows; more cuts give a higher and flatter rate.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import d4m
from repro_torch.bench.reporting import BenchmarkReport
from repro_torch.data import rmat

from . import _common

#: points of the per-group rate trajectory kept in the artifact (means over
#: equal slices of the stream)
TRACE_POINTS = 20


def make_stream(seed: int, total_edges: int, group_size: int, scale: int,
                device: torch.device):
    """``[G, B]`` rows and cols on ``device``, the numpy arrays behind them,
    and one warm-up group from another seed."""
    groups = list(rmat.edge_stream(np.random.default_rng(seed), total_edges, group_size, scale))
    src = np.stack([g[0] for g in groups])
    dst = np.stack([g[1] for g in groups])
    ws, wd, _ = next(rmat.edge_stream(np.random.default_rng(seed + 999), group_size, group_size, scale))
    dev = {
        "rows": torch.from_numpy(src).to(device),
        "cols": torch.from_numpy(dst).to(device),
        "vals": torch.ones(group_size, dtype=torch.float32, device=device),
        "warm": (torch.from_numpy(ws).to(device), torch.from_numpy(wd).to(device)),
    }
    return dev, src, dst


def run_stream(
    cuts: Sequence[int],
    stream: Dict[str, torch.Tensor],
    group_size: int,
    top_capacity: int,
    device: torch.device,
    want,
) -> Tuple[List[float], float, int, int, bool, bool, List[int]]:
    """Returns (per-group instantaneous rates, cumulative rate, final nnz
    summed over the layers, the snapshot's nnz (distinct keys), whether the
    snapshot holds ``want`` (:func:`_common.key_counts` of the stream),
    overflowed, cascades per layer)."""
    sess = d4m.D4MStream(
        d4m.StreamConfig(cuts=tuple(cuts), top_capacity=top_capacity, batch_size=group_size),
        device=device,
    )
    if sess.kind != "single":
        raise RuntimeError(f"hier: expected the single engine, got {sess.kind!r}")
    vals = stream["vals"]
    sess.update(*stream["warm"], vals)  # builds the kernels at first use (untimed)
    _common.sync(device)
    sess.reset()
    _common.sync(device)
    rates = []
    t_total = 0.0
    rows, cols = stream["rows"], stream["cols"]
    for g in range(rows.shape[0]):
        t0 = time.perf_counter()
        sess.update(rows[g], cols[g], vals)
        _common.sync(device)
        dt = time.perf_counter() - t0
        t_total += dt
        rates.append(group_size / dt)
    total = rows.shape[0] * group_size
    snap = sess.snapshot()
    out = (rates, total / t_total, sess.nnz(), int(snap.nnz), _common.holds_counts(snap, want),
           sess.overflowed(), [int(c) for c in sess.state.cascades.tolist()])
    del sess, snap
    _common.release(device)
    return out


def cut_schedules(total_edges: int, group_size: int):
    """0/2/4/8-cut schedules mirroring Fig. 3's close vs. wide spacing."""
    e = total_edges
    g = group_size
    return {
        "0cut": (),
        "2cut_wide": (4 * g, e // 4),
        "4cut_close": (2 * g, 8 * g, 32 * g, 128 * g),
        "8cut_close": tuple(g * 2**i for i in range(1, 9)),
    }


def _trace(rates: List[float]) -> List[float]:
    return [float(np.mean(part)) for part in np.array_split(np.asarray(rates), TRACE_POINTS)
            if part.size]


def main(total_edges: int = 800_000, group_size: int = 5_000, scale: int = 18,
         seed: int = 0, device: str = "cuda"):
    dev = _common.device_of(device)
    report = BenchmarkReport("hier_update", device=str(dev))
    top = int(total_edges * 1.4)
    t0 = time.perf_counter()
    stream, src, dst = make_stream(seed, total_edges, group_size, scale, dev)
    t_gen = time.perf_counter() - t0
    want = _common.key_counts(src, dst)
    t_count = time.perf_counter() - t0 - t_gen
    del src, dst
    print(f"hier_update,stream,edges={total_edges},distinct={want[0].size},"
          f"made_s={t_gen:.1f},counted_s={t_count:.1f}", flush=True)
    rows, failures = [], []
    for name, cuts in cut_schedules(total_edges, group_size).items():
        before = _common.launch_counts()
        rates, cum, nnz, snap_nnz, values, overflow, cascades = run_stream(
            cuts, stream, group_size, top, dev, want)
        launches = _common.launches_since(before)
        n = len(rates)
        first, last = sum(rates[: n // 4]) / (n // 4), sum(rates[-n // 4:]) / (n // 4)
        exact = snap_nnz == want[0].size and not overflow
        if not (exact and values):
            failures.append(f"{name}: snapshot nnz {snap_nnz} vs {want[0].size} distinct keys, "
                            f"overflow {overflow}, values exact {values}")
        rows.append((name, cuts, cum, first, last, nnz))
        print(
            f"hier_update,{name},cuts={len(cuts)},cum_rate={cum:,.0f}/s,"
            f"first_quarter={first:,.0f}/s,last_quarter={last:,.0f}/s,nnz={nnz},"
            f"snapshot_nnz={snap_nnz},"
            f"nnz_exact={exact},values_exact={values},launches={launches}",
            flush=True,
        )
        report.add(
            name,
            params={
                "cuts": list(cuts),
                "total_edges": total_edges,
                "group_size": group_size,
                "rmat_scale": scale,
                "engine": "single",
            },
            updates_per_sec=cum,
            wall_s=total_edges / cum,
            first_quarter_rate=first,
            last_quarter_rate=last,
            rate_trace=_trace(rates),
            nnz=int(nnz),
            snapshot_nnz=snap_nnz,
            distinct_keys=int(want[0].size),
            nnz_exact=bool(exact),
            values_exact=values,
            overflow=bool(overflow),
            cascades=cascades,
            launches=launches,
        )
    byname = {r[0]: r for r in rows}
    flat_cum = byname["0cut"][2]
    best_cum = max(r[2] for r in rows)
    v1 = byname["8cut_close"][2] > flat_cum
    v2 = byname["0cut"][3] > byname["0cut"][4]  # the 0-cut rate decays
    print(f"verdict,hier_beats_flat,{v1},ratio={best_cum / flat_cum:.2f}x")
    print(f"verdict,flat_rate_decays,{v2}")
    report.add("verdict_hier_beats_flat", passed=bool(v1), ratio=best_cum / flat_cum)
    report.add("verdict_flat_rate_decays", passed=bool(v2))
    report.write()
    _common.raise_failures("hier", failures)
    return rows


if __name__ == "__main__":
    main()
