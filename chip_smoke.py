#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which asserts (any failure exits non-zero):

1. build every kernel from the sources in the checkout (``nvcc``, sm_90a);
2. hold the ``hier_cascade`` kernel against its plain PyTorch version on the
   card, bit-exactly, at the CPU parity tests' shapes and at a mid shape
   where both cuts fire, for every semiring fold code, and with NaN and
   -0.0 in the batches and in entries the layers already hold;
3. drive the port's main path at full width: K=8 hash-routed instances of
   the paper's instance shape (``configs/d4m_stream.CONFIG``: groups of
   100,000 R-MAT scale-20 edges, cuts 100k/1M/10M) with a top capacity of
   16,000,000 each, 200 groups through ``D4MStream(cfg).ingest``; replay the
   same routed batches through the kernel alone (timed on the card, the
   wrapper's host time apart) and through the plain version, and require
   all three states to be bit-identical; check
   the snapshot's distinct-key count and ``query.top_k`` against numpy;
4. print a ``{"kernels": [...]}`` line, the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
ENTRY_BYTES = 12  # int32 row + int32 col + float32 value
STEPS = 200
K = 8
TOP_CAPACITY = 16_000_000
DEVICE = "cuda"
# a spin of the card (~5 ms at H100 clocks) queued ahead of each timed
# launch, so the wrapper's host work overlaps it and the events around the
# launch time the kernel alone
SLEEP_CYCLES = 10_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """A failed check ends the run with a non-zero exit (not an assert,
    which ``python -O`` would drop)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def leaves(h):
    out = []
    for l in h.layers:
        out += [l.rows, l.cols, l.vals, l.nnz, l.overflow]
    return out + [h.cascades]


def compare(torch, got, want, what: str) -> float:
    """Bitwise equality of two hierarchies; returns the max abs value error
    (0.0 when identical), raising on any difference."""
    err = 0.0
    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        if g.dtype.is_floating_point:
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
            if not same:
                both = torch.isfinite(g) & torch.isfinite(w)
                err = max(err, float((g[both] - w[both]).abs().max()) if both.any() else float("inf"))
        else:
            same = torch.equal(g, w)
        if not same:
            raise RuntimeError(f"{what}: leaf {i} differs (max abs value error {err})")
    return err


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")


def plain_update(h, rows, cols, vals, cuts, caps, sr):
    """What ``ops.cascade_update`` computes, through its plain version on
    the card: the reference the kernel is held to."""
    from repro_torch.core import multistream
    from repro_torch.kernels.hier_cascade import ops

    batch = ops.canonical_batch(rows, cols, vals, sr)
    bufs, nnz, cascades, overflow = multistream.flat_layer_state(h)
    overflow[:, 0] |= batch.overflow
    ops.cascade_step_plain(bufs, nnz, cascades, overflow, batch, cuts, caps, sr)
    return multistream.from_flat_layer_state(bufs, nnz, cascades, overflow)


def special_values(torch, np, rng, shape):
    """About a quarter each of NaN, -0.0, +0.0 and normal float32 values."""
    v = rng.normal(size=shape).astype(np.float32)
    pick = rng.integers(0, 4, shape)
    v[pick == 0], v[pick == 1], v[pick == 2] = np.nan, -0.0, 0.0
    return torch.tensor(v, device=DEVICE)


def plant_special(torch, h):
    """Overwrite every third live entry of every layer with -0.0 and the
    next with NaN, so later merges fold into such entries."""
    for l in h.layers:
        idx = torch.arange(l.capacity, device=l.vals.device)
        live = idx < l.nnz[:, None]
        l.vals[live & (idx % 3 == 0)] = -0.0
        l.vals[live & (idx % 3 == 1)] = float("nan")


def phase_parity(torch, np):
    """Kernel against plain version on the card, bit-exactly."""
    from repro_torch.core import semiring
    from repro_torch.kernels.hier_cascade import ops

    cases = [
        # (name, K, cuts, top, batch, steps, key space, semiring)
        ("absent-K1", 1, (512,), 2048, 8, 5, 48, "plus.times"),
        ("absent-K8", 8, (512,), 2048, 8, 5, 48, "plus.times"),
        ("forced-K1", 1, (8, 32), 256, 16, 6, 48, "plus.times"),
        ("forced-K8", 8, (8, 32), 256, 16, 6, 48, "plus.times"),
        ("overflow", 2, (8,), 12, 16, 6, 256, "plus.times"),
        ("max.plus", 2, (8, 32), 256, 16, 5, 48, "max.plus"),
        ("min.plus", 2, (8, 32), 256, 16, 5, 48, "min.plus"),
        ("union.first", 2, (8, 32), 256, 16, 5, 48, "union.first"),
    ]
    for srn in ("plus.times", "max.plus", "min.plus", "union.first"):
        cases.append((f"mid-{srn}", 8, (4096, 32768), 262144, 4096, 64, 1024, srn))
    for srn in ("plus.times", "max.plus", "min.plus", "union.first"):
        cases.append((f"nan-{srn}", 8, (8, 32), 256, 16, 8, 48, srn))
        cases.append((f"mid-nan-{srn}", 8, (4096, 32768), 262144, 4096, 24, 1024, srn))
    err = 0.0
    for name, k, cuts, top, batch, steps, space, srn in cases:
        sr = semiring.get(srn)
        rng = np.random.default_rng(len(name) * 7919 + steps)
        special = "nan" in name
        R = torch.tensor(rng.integers(0, space, (steps, k, batch)), dtype=torch.int32, device=DEVICE)
        C = torch.tensor(rng.integers(0, space, (steps, k, batch)), dtype=torch.int32, device=DEVICE)
        if special:
            V = special_values(torch, np, rng, (steps, k, batch))
        else:
            V = torch.tensor(rng.normal(size=(steps, k, batch)), dtype=torch.float32, device=DEVICE)
        hk, caps = ops.init_state(k, cuts, top, batch, sr, device=DEVICE)
        hp, _ = ops.init_state(k, cuts, top, batch, sr, device=DEVICE)
        for t in range(steps):
            hk = ops.cascade_update(hk, R[t], C[t], V[t], cuts, caps, sr)
            hp = plain_update(hp, R[t], C[t], V[t], cuts, caps, sr)
            if special and t == 1:
                plant_special(torch, hk)
                plant_special(torch, hp)
        torch.cuda.synchronize()
        err = max(err, compare(torch, hk, hp, name))
        casc = hk.cascades.cpu()
        if name.startswith("mid"):
            check((casc[:, 1] > 0).all(), (name, casc))
        if name.startswith("mid-") and not special:
            check(int(casc[:, 2].sum()) > 0, (name, casc))
        if special:
            n_nan = sum(int(l.vals.isnan().sum()) for l in hk.layers)
            check(n_nan > 0, (name, "NaN survives in the layers"))
        log(f"[parity] {name}: bit-identical, cascades per layer {casc.sum(0).tolist()}")
    return err


def phase_main(torch, np):
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.core import multistream
    from repro_torch.d4m import D4MStream
    from repro_torch.data import rmat
    from repro_torch.kernels.hier_cascade import ops

    group, n_edges = CONFIG.group_size, STEPS * CONFIG.group_size
    rng = np.random.default_rng(CONFIG.seed)
    t0 = time.perf_counter()
    src, dst = rmat.rmat_edges(rng, n_edges, CONFIG.scale, CONFIG.a, CONFIG.b, CONFIG.c)
    t_gen = time.perf_counter() - t0
    keys = src.astype(np.int64) * 2**32 + dst.astype(np.int64)
    n_distinct = int(np.unique(keys).size)
    out_deg = np.bincount(src)
    log(f"[main] {n_edges:,} R-MAT scale-{CONFIG.scale} edges, {n_distinct:,} distinct, "
        f"made in {t_gen:.1f} s, counted in {time.perf_counter() - t0 - t_gen:.1f} s (host)")

    cfg = CONFIG.to_session(
        instances_per_device=K, top_capacity=TOP_CAPACITY, snapshot_cap=n_distinct
    )
    sess = D4MStream(cfg)
    check(sess.kind == "cuda", sess.kind)
    plan = sess.plan
    log(f"[main] caps {plan.layer_caps}, state {plan.total_bytes / 1e9:.2f} GB planned")
    R = torch.tensor(src.reshape(STEPS, group), device=DEVICE)
    C = torch.tensor(dst.reshape(STEPS, group), device=DEVICE)
    V = torch.ones((STEPS, group), dtype=torch.float32, device=DEVICE)
    sess.state  # allocate before the clock starts
    torch.cuda.synchronize()

    # -- the main path, counted --------------------------------------------
    ops.launch_count = 0
    dropped = torch.zeros((), dtype=torch.int64, device=DEVICE)
    t0 = time.perf_counter()
    for g in range(STEPS):
        dropped += sess.ingest(R[g], C[g], V[g])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_count
    check(launches == STEPS, launches)
    rate = n_edges / wall
    log(f"[main] ingest: {STEPS} groups in {wall:.3f} s = {rate:,.0f} updates/s, "
        f"{launches} hier_cascade launches")
    check(int(dropped) == 0, int(dropped))
    check(not sess.overflowed(), "no instance overflowed")
    casc = sess.state.cascades.cpu()
    check((casc[:, 1] > 0).all() and int(casc[:, 2].sum()) > 0, casc)
    log(f"[main] cascades per instance and layer: {casc.tolist()}")

    # -- the same routed batches: kernel alone (timed) and plain version ---
    def event():
        return torch.cuda.Event(enable_timing=True)

    batches, marks = [], []
    for g in range(STEPS):
        e0, e1, e2 = event(), event(), event()
        e0.record()
        br, bc, bv, _ = sess.route(R[g], C[g], V[g])
        e1.record()
        batches.append(ops.canonical_batch(br, bc, bv, sess.sr))
        e2.record()
        marks.append((e0, e1, e2))
    torch.cuda.synchronize()
    route_ms = float(np.mean([a.elapsed_time(b) for a, b, _ in marks]))
    canon_ms = float(np.mean([b.elapsed_time(c) for _, b, c in marks]))
    log(f"[main] per step: route {route_ms:.4f} ms, canonicalize {canon_ms:.4f} ms "
        f"(CUDA events, step by step)")
    cuts, caps, sr = sess.cuts, plan.layer_caps, sess.sr

    def fresh():
        h = multistream.init_packed(K, cuts, cfg.top_capacity, cfg.batch_size, sr, device=DEVICE)
        return multistream.flat_layer_state(h)

    # each launch waits behind a spin of the card: the wrapper's host work
    # (checks, scratch, ctypes arguments) runs meanwhile, so the events time
    # the kernel alone; the host time is taken apart, on the host clock
    s0, s1 = event(), event()
    s0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    s1.record()
    torch.cuda.synchronize()
    sleep_ms = s0.elapsed_time(s1)
    flat_k = fresh()
    kernel_ms, host_ms = [], []
    for b in batches:
        flat_k[3][:, 0] |= b.overflow
        start, end = event(), event()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        ops.cascade_step_kernel(*flat_k, b, cuts, caps, sr)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        kernel_ms.append((start, end))
    torch.cuda.synchronize()
    kernel_ms = [s.elapsed_time(e) for s, e in kernel_ms]
    overruns = sum(h >= sleep_ms for h in host_ms)
    log(f"[main] wrapper host time {np.mean(host_ms):.4f} ms/launch mean "
        f"(max {max(host_ms):.4f}); spin ahead of each launch {sleep_ms:.3f} ms; "
        f"{overruns} launches where the host outlasted the spin")

    flat_p = fresh()
    merges, plain_ms = [], []
    for b in batches:
        flat_p[3][:, 0] |= b.overflow
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.cascade_step_plain(*flat_p, b, cuts, caps, sr, merges=merges)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)

    err = compare(torch, multistream.from_flat_layer_state(*flat_k), sess.state, "replay vs main path")
    err = max(err, compare(torch, multistream.from_flat_layer_state(*flat_p), sess.state, "plain vs kernel"))
    log("[main] main-path state == kernel replay == plain version (bit-identical)")

    # least bytes a step must move: every merge reads its two live inputs and
    # writes its live output; a fired cascade also clears its source
    step_bytes = sum(
        ENTRY_BYTES * (n_dst + n_src + n_out + (n_src if cleared else 0))
        for n_dst, n_src, n_out, cleared in merges
    ) / STEPS + K * 3 * plan.n_layers * 4
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    ms = float(np.mean(kernel_ms))
    log(f"[main] hier_cascade: {ms:.4f} ms/step mean (median {np.median(kernel_ms):.4f}, "
        f"max {max(kernel_ms):.4f}); bound {bound_ms:.5f} ms/step "
        f"({step_bytes / 1e6:.2f} MB/step at 3.35 TB/s); plain version "
        f"{np.mean(plain_ms):.3f} ms/step")

    # -- read side -----------------------------------------------------------
    snap = sess.snapshot(cap=n_distinct)
    check(int(snap.nnz) == n_distinct, (int(snap.nnz), n_distinct))
    check(not bool(snap.overflow), "the snapshot fits its cap")
    live = snap.vals[: n_distinct]
    check(bool(torch.isfinite(live).all()), "finite snapshot values")
    check(float(live.double().sum()) == float(n_edges), "snapshot values sum to the edge count")
    ids, counts = sess.query.top_k(10)
    ids, counts = ids.cpu().numpy(), counts.cpu().numpy()
    check(np.array_equal(counts, np.sort(out_deg)[::-1][:10].astype(np.float32)), counts)
    check(np.array_equal(out_deg[ids].astype(np.float32), counts), (ids, counts))
    log(f"[main] snapshot nnz {int(snap.nnz):,} == distinct keys; top-10 out-degree "
        f"ids {ids.tolist()} counts {counts.tolist()}")
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return {
        "launches": launches,
        "err": err,
        "ms": ms,
        "plain_ms": float(np.mean(plain_ms)),
        "bound_ms": bound_ms,
        "host_ms": float(np.mean(host_ms)),
        "rate": rate,
    }


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing beside this script ({e})",
              file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()
    parity_err = phase_parity(torch, np)
    main = phase_main(torch, np)

    kernels = [{
        "name": "hier_cascade",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hier_cascade.cu",
        "replaces": "src/repro/kernels/hier_cascade/kernel.py:168",
        "launches": main["launches"],
        "max_abs_err": max(parity_err, main["err"]),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "host_ms": main["host_ms"],
        "parity": "bit-identical",
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
