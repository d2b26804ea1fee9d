"""Lane-skipping cascade kernel benchmark, ``BENCH_cascade_kernel.json``
(port of the reference's ``benchmarks/bench_cascade_kernel.py``).

One packed update step (K instances, same cuts, same shapes) on three
engines of the port, on one device:

* ``packed`` — the branchless cascade over the ``[K]`` axis
  (``multistream.packed_update`` with ``branchless=True``): every layer
  merge runs every step, so a step costs the sum of the layer caps whether
  or not a cut fired (the reference's ``branchless``);
* ``cuda`` — the ``hier_cascade`` kernel (``sort_dedup`` canonicalizes the
  batch): layer merges are predicated per lane on the card, so a step costs
  what the lanes whose cuts fired need (the reference's ``pallas``);
* ``single`` — K=1, the cond cascade over ``merge_add`` (the reference's
  ``cond``), for context.

Each engine runs through a ``D4MStream`` of that engine and its
``raw_update`` step, timed to ``torch.cuda.synchronize()``.  Cascade
frequency is swept by key locality and by cut schedule.  The headline is
``lane_skip_speedup``: packed vs cuda step time on the 0%-cascade stream at
equal K and cuts, which must be >= 2x with no cascade at all.  The ``cuda``
and ``packed`` states must agree (nnz and cascade counters per instance).

``batch`` (the reference's 256 by default) sets each instance's records a
step; the schedules' cuts, top capacity and 0%-stream key space scale with
it, so each schedule keeps its cascade rate at any batch.
"""
from __future__ import annotations

import math
import time
import zlib

import numpy as np
import torch

from repro_torch import d4m
from repro_torch.bench.reporting import BenchmarkReport

from . import _common

BATCH = 256

# name -> (cuts, top_capacity, key_space) at BATCH; the cascade rate is set
# by how fast distinct keys accumulate in layer 1 against c1
SCHEDULES = {
    # layer 1 can never exceed its cut: the pure fast path
    "0pct": ((512, 4096), 16384, 200),
    # fresh keys every batch: layer 1 fires every ~2-3 steps
    "hot": ((512, 4096), 16384, 1 << 30),
    # tight cut schedule: cascades on nearly every step at every layer
    "tight_cuts": ((64, 512), 16384, 1 << 30),
}


def schedule(name: str, batch: int = BATCH):
    """``(cuts, top_capacity, key_space)`` of a schedule at ``batch``
    records a step: :data:`SCHEDULES` scaled by ``batch / BATCH``."""
    cuts, top, key_space = SCHEDULES[name]

    def scaled(x):
        return x * batch // BATCH

    if key_space < 1 << 30:  # a bounded key space scales with the batch
        key_space = scaled(key_space)
    return tuple(scaled(c) for c in cuts), scaled(top), key_space


def _stream(seed, steps, k, key_space, batch, device):
    # keys are (row, col) pairs: each coordinate from sqrt(key_space), so
    # the pair space bounds layer-1 occupancy
    side = max(1, math.isqrt(key_space))
    rng = np.random.default_rng(seed)
    r = torch.from_numpy(rng.integers(0, side, (steps, k, batch)).astype(np.int32)).to(device)
    c = torch.from_numpy(rng.integers(0, side, (steps, k, batch)).astype(np.int32)).to(device)
    v = torch.ones((steps, k, batch), dtype=torch.float32, device=device)
    return r, c, v


def _session(engine, k, cuts, top, batch, device):
    return d4m.D4MStream(
        d4m.StreamConfig(cuts=cuts, top_capacity=top, batch_size=batch, instances_per_device=k,
                         engine=engine, branchless=True if engine == "packed" else None),
        device=device,
    )


def _time_engine(sess, R, C, V, device, warmup=2):
    """Thread the state through ``sess.raw_update`` over the stream;
    returns (seconds a step, final state, launches)."""
    step = sess.raw_update
    squeeze = sess.kind == "single"

    def batch(t):
        return (R[t, 0], C[t, 0], V[t, 0]) if squeeze else (R[t], C[t], V[t])

    before = _common.launch_counts()
    h = sess.state
    for t in range(warmup):
        h = step(h, *batch(t))
    _common.sync(device)
    steps = R.shape[0] - warmup
    t0 = time.perf_counter()
    for t in range(warmup, R.shape[0]):
        h = step(h, *batch(t))
    _common.sync(device)
    wall = (time.perf_counter() - t0) / steps
    return wall, h, _common.launches_since(before)


def bench_point(k, name, steps, report, device, batch=BATCH):
    cuts, top, key_space = schedule(name, batch)
    # a stable seed a schedule (hash() is salted per process: the gate must
    # compare runs on identical streams)
    R, C, V = _stream(zlib.crc32(name.encode()) % 1000, steps, k, key_space, batch, device)

    br_s, h_br, br_l = _time_engine(_session("packed", k, cuts, top, batch, device), R, C, V,
                                    device)
    cu_sess = _session("cuda", k, cuts, top, batch, device)
    cu_s, h_cu, cu_l = _time_engine(cu_sess, R, C, V, device)

    nnz_cu = torch.stack([l.nnz for l in h_cu.layers], dim=1)
    nnz_br = torch.stack([l.nnz for l in h_br.layers], dim=1)
    agree = bool(torch.equal(nnz_cu, nnz_br) and torch.equal(h_cu.cascades, h_br.cascades))
    casc = int(h_cu.cascades[:, 1:].sum())
    rate = float(casc) / (steps * k)
    caps = cu_sess.plan.layer_caps
    del h_br, h_cu, cu_sess
    _common.release(device)
    params = {"k": k, "schedule": name}
    if batch != BATCH:
        params["batch"] = batch
    for engine, wall, launches in (("packed", br_s, br_l), ("cuda", cu_s, cu_l)):
        print(
            f"cascade_step,k={k},schedule={name},engine={engine},"
            f"step_us={wall * 1e6:.0f},cascades_per_step={rate:.2f},launches={launches}",
            flush=True,
        )
        report.add(
            "cascade_step",
            params={**params, "engine": engine},
            updates_per_sec=k * batch / wall,
            wall_s=wall,
            cascades_per_step=rate,
            sum_layer_caps=int(sum(caps)),
            engines_agree=agree,
            launches=launches,
        )

    if k == 1:
        cond_s, _, cond_l = _time_engine(_session("single", 1, cuts, top, batch, device), R, C, V,
                                         device)
        _common.release(device)
        print(f"cascade_step,k=1,schedule={name},engine=single,"
              f"step_us={cond_s * 1e6:.0f},launches={cond_l}", flush=True)
        report.add(
            "cascade_step",
            params={**params, "engine": "single"},
            updates_per_sec=batch / cond_s,
            wall_s=cond_s,
            cascades_per_step=rate,
            launches=cond_l,
        )
    return br_s, cu_s, rate, agree


def main(smoke: bool = False, k_values=None, steps: int | None = None, batch: int = BATCH,
         device: str = "cuda"):
    dev = _common.device_of(device)
    report = BenchmarkReport("cascade_kernel", device=str(dev))
    ks = tuple(k_values) if k_values else ((1, 8) if smoke else (1, 8, 32))
    steps = steps or (8 if smoke else 16)
    names = ("0pct", "hot") if smoke else tuple(SCHEDULES)
    failures = []
    for k in ks:
        speedup = rate0 = None
        for name in names:
            br_s, cu_s, rate, agree = bench_point(k, name, steps, report, dev, batch)
            if not agree:
                failures.append(f"k={k} {name}: the cuda and packed engines' states differ")
            if name == "0pct":
                speedup, rate0 = br_s / cu_s, rate
        if speedup is not None:
            # the headline claim means something only on a true 0%-cascade stream
            ok = speedup >= 2.0 and rate0 == 0.0
            print(
                f"lane_skip_speedup,k={k},speedup={speedup:.1f}x,"
                f"cascades_per_step={rate0},passed={ok}", flush=True
            )
            report.add(
                "lane_skip_speedup",
                params={"k": k} if batch == BATCH else {"k": k, "batch": batch},
                speedup=float(speedup),
                cascades_per_step=float(rate0),
                passed=bool(ok),
            )
    report.write()
    _common.raise_failures("cascade_kernel", failures)


if __name__ == "__main__":
    main()
