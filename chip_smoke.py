#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which asserts (any failure exits non-zero):

1. build every kernel from the sources in the checkout (``nvcc``, sm_90a,
   one process per source, all started together);
2. hold the ``hier_cascade`` kernel against its plain PyTorch version on the
   card, bit-exactly, at the CPU parity tests' shapes and at a mid shape
   where both cuts fire, for every semiring fold code, and with NaN and
   -0.0 in the batches and in entries the layers already hold;
3. hold ``merge_add`` and ``sort_dedup`` against their plain versions, bit
   for bit: every fold code, float32 and bfloat16, NaN and -0.0, leading
   batch axes, caps below the union, empty inputs, one huge run, ~1 M
   entries;
4. make the R-MAT stream once (200 groups of 100,000 scale-20 edges,
   ``configs/d4m_stream.CONFIG``) and count it with numpy;
5. the ``cuda`` engine at full width: K=8 hash-routed instances of the
   paper's instance shape (cuts 100k/1M/10M, top capacity 16,000,000
   each) through ``D4MStream(cfg).ingest``, 200 ``sort_dedup`` calls and
   200 ``hier_cascade`` launches; replay the same routed batches through
   the kernel alone (timed on the card, the wrapper's host time apart) and
   through the plain versions, and require all three states bit-identical;
6. the read side: the K=8 snapshot and ``query.degrees`` through the
   kernels and inside ``kernels.plain_versions()``, bit-identical, checked
   against numpy's distinct count and ``bincount``;
7. the ``single`` engine (K=1, ``CONFIG`` unchanged: top capacity 140 M)
   at full width, through the kernels and inside ``plain_versions()``,
   bit-identical, every cascade level firing;
8. per-call times of ``sort_dedup`` and ``merge_add`` at the main paths'
   shapes, with their byte bounds, plain versions and ``torch.sort`` of
   the same keys as a reference;
9. the algebra and graph queries on a uniform random graph (2^16
   vertices, 500,000 edges, ``max_fanout`` 64), kernels against plain bit
   for bit, triangles against scipy's ``trace(A^3)/6``;
10. print a ``{"kernels": [...]}`` line, the card's name and power limit,
    and as the last line ``{"ok": true, "device": {...}}``.

Launch counters are zeroed just before each path and read just after;
inside ``plain_versions()`` they must not move.

Without CUDA, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
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
    """What ``ops.cascade_update`` computes, through the plain versions on
    the card (``from_triples_plain``, ``cascade_step_plain``): the reference
    the kernels are held to."""
    from repro_torch.core import assoc, multistream

    batch = assoc.from_triples_plain(rows, cols, vals, cap=rows.shape[-1], sr=sr)
    flat = plain_step(multistream.flat_layer_state(h), batch, cuts, caps, sr)
    return multistream.from_flat_layer_state(*flat)


def plain_step(flat, batch, cuts, caps, sr, merges=None):
    """``ops.cascade_step_plain`` on the flat state, the batch's overflow
    OR-ed into layer 1 first, as the wrapper does."""
    from repro_torch.kernels.hier_cascade import ops

    bufs, nnz, cascades, overflow = flat
    overflow[:, 0] |= batch.overflow
    ops.cascade_step_plain(bufs, nnz, cascades, overflow, batch, cuts, caps, sr, merges=merges)
    return bufs, nnz, cascades, overflow


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


def assoc_same(torch, got, want, what: str) -> float:
    """Bitwise equality of two Assocs (values compared by bit pattern);
    returns the max abs value error (0.0 when identical), raising on any
    difference."""
    err = 0.0
    for f in ("rows", "cols", "vals", "nnz", "overflow"):
        g, w = getattr(got, f), getattr(want, f)
        check(g.shape == w.shape and g.dtype == w.dtype, (what, f, g.shape, w.shape, g.dtype, w.dtype))
        if g.dtype.is_floating_point:
            bits = torch.int16 if g.element_size() == 2 else torch.int32
            same = torch.equal(g.view(bits), w.view(bits))
            if not same:
                both = torch.isfinite(g) & torch.isfinite(w)
                err = float((g[both].float() - w[both].float()).abs().max()) if both.any() else float("inf")
        else:
            same = torch.equal(g, w)
        if not same:
            raise RuntimeError(f"{what}: {f} differs (max abs value error {err})")
    return err


def random_triples(torch, np, rng, shape, space, special, dtype):
    """int32 rows/cols in ``[0, space)`` and values (a quarter each NaN,
    -0.0, +0.0 and normal when ``special``) on the card."""
    r = torch.tensor(rng.integers(0, space, shape), dtype=torch.int32, device=DEVICE)
    c = torch.tensor(rng.integers(0, space, shape), dtype=torch.int32, device=DEVICE)
    if special:
        v = special_values(torch, np, rng, shape)
    else:
        v = torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=DEVICE)
    return r, c, v.to(dtype)


FOLDS = ("plus.times", "max.plus", "min.plus", "union.first")

# (name, batch, n, key space, cap as a fraction of n): the CPU tests'
# small shapes, tile edges, long runs, one huge run, a mid shape
SORT_CASES = [
    ("n0", (), 0, 4, 1.0),
    ("n1", (), 1, 4, 1.0),
    ("n2", (), 2, 1, 1.0),
    ("n7", (), 7, 3, 1.0),
    ("n333", (), 333, 6, 1.0),
    ("n333-cap", (), 333, 40, 0.1),
    ("batch", (3, 2), 100, 8, 1.0),
    ("tile", (), 4096, 64, 1.0),
    ("tile+1", (2,), 4097, 64, 0.5),
    ("long-runs", (), 50_000, 30, 1.0),
    ("one-run", (), 200_000, 1, 1.0),
    ("K8-group", (8,), 100_000, 1024, 1.0),
    ("mid", (), 1_000_000, 4096, 0.5),
]


def phase_parity_ops(torch, np):
    """``merge_add`` and ``sort_dedup`` against their plain versions on the
    card, bit for bit: every fold code, float32 and bfloat16, NaN and -0.0,
    leading batch axes, caps below the union, empty inputs, runs up to the
    whole input, and a mid shape of about 1 M entries."""
    from repro_torch.core import assoc, semiring
    from repro_torch.kernels.merge_add import ops as mops
    from repro_torch.kernels.sort_dedup import ops as sops

    err, cases = 0.0, 0
    for srn in FOLDS:
        sr = semiring.get(srn)
        for dtype in (torch.float32, torch.bfloat16):
            for special in (False, True):
                rng = np.random.default_rng(len(srn) * 31 + int(special) + 7 * (dtype == torch.bfloat16))
                tag = f"{srn}/{str(dtype)[6:]}/{'special' if special else 'normal'}"
                # from_triples, with and without a valid mask
                for name, batch, n, space, frac in SORT_CASES:
                    r, c, v = random_triples(torch, np, rng, batch + (n,), space, special, dtype)
                    cap = max(1, int(n * frac))
                    valid = None
                    if name in ("n333", "K8-group"):
                        valid = torch.tensor(rng.random(batch + (n,)) < 0.8, device=DEVICE)
                    got = sops.from_triples(r, c, v, cap, sr, valid)
                    want = assoc.from_triples_plain(r, c, v, cap, sr, valid)
                    err = max(err, assoc_same(torch, got, want, f"from_triples {name} {tag}"))
                    cases += 1
                    # the fold stage alone: on the sorted triples, on degree
                    # keys (row, 0), and on sorted unique keys with PAD holes
                    # (what elem_mul and extract_row hand it)
                    if n >= 2 and name in ("n333", "batch", "long-runs", "mid"):
                        order = torch.sort(assoc.pack_keys(r, c), dim=-1, stable=True).indices
                        sr_, sc_, sv_ = (torch.gather(x, -1, order) for x in (r, c, v))
                        holes = torch.tensor(rng.random(batch + (n,)) < 0.3, device=DEVICE)
                        u = assoc.from_triples_plain(r, c, v, n, sr)
                        for fname, cr, cc, cv in (
                            ("sorted", sr_, sc_, sv_),
                            ("degrees", sr_, torch.zeros_like(sc_), sv_),
                            ("holes", torch.where(holes, assoc.PAD, u.rows),
                             torch.where(holes, assoc.PAD, u.cols), u.vals),
                        ):
                            got = sops.combine_sorted(cr, cc, cv, cap, sr)
                            want = assoc.combine_sorted_plain(cr, cc, cv, cap, sr)
                            err = max(err, assoc_same(torch, got, want, f"combine_sorted {fname} {name} {tag}"))
                            cases += 1
                # merge_add on sorted unique inputs
                for name, batch, m, n, space, cap in (
                    ("small", (), 40, 24, 9, None),
                    ("small-cap", (), 40, 24, 9, 10),
                    ("batch", (3, 2), 64, 48, 12, None),
                    ("disjoint-width", (), 1000, 30, 100, 500),
                    ("mid", (), 1_000_000, 300_000, 2048, None),
                    ("mid-cap", (2,), 500_000, 500_000, 1024, 600_000),
                ):
                    ra, ca, va = random_triples(torch, np, rng, batch + (m,), space, special, dtype)
                    rb, cb, vb = random_triples(torch, np, rng, batch + (n,), space, special, dtype)
                    a = assoc.from_triples_plain(ra, ca, va, m, sr)
                    b = assoc.from_triples_plain(rb, cb, vb, n, sr)
                    if name == "batch":
                        a.overflow = torch.tensor(rng.random(batch) < 0.5, device=DEVICE)
                    got = mops.merge_add(a, b, cap, sr)
                    want = assoc.add_plain(a, b, cap, sr)
                    err = max(err, assoc_same(torch, got, want, f"merge_add {name} {tag}"))
                    cases += 1
                for wa, wb in ((0, 5), (5, 0), (0, 0), (1, 0), (1, 1)):  # empty inputs
                    a, b = (
                        assoc.from_triples_plain(*random_triples(torch, np, rng, (w,), 4, special, dtype), w, sr)
                        if w else assoc.empty(0, sr, dtype, DEVICE)
                        for w in (wa, wb)
                    )
                    for cap in (None, 3):
                        got = mops.merge_add(a, b, cap, sr)
                        want = assoc.add_plain(a, b, cap, sr)
                        err = max(err, assoc_same(torch, got, want, f"merge_add widths {wa},{wb} {tag}"))
                        cases += 1
                torch.cuda.synchronize()
                log(f"[parity-ops] {tag}: bit-identical")
    log(f"[parity-ops] merge_add and sort_dedup: {cases} cases bit-identical to their plain versions")
    return err


def counters():
    """The launch counters of the three kernels' wrappers."""
    from repro_torch.kernels.hier_cascade import ops as hc
    from repro_torch.kernels.merge_add import ops as ma
    from repro_torch.kernels.sort_dedup import ops as sd

    return {"hier_cascade": hc, "merge_add": ma, "sort_dedup": sd}


def zero_counts() -> None:
    for mod in counters().values():
        mod.launch_count = 0


def read_counts() -> dict:
    return {name: mod.launch_count for name, mod in counters().items()}


def event(torch):
    return torch.cuda.Event(enable_timing=True)


def phase_data(torch, np):
    """The R-MAT stream of phases 3 and 5 and its numpy counts, made once."""
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.data import rmat

    group, n_edges = CONFIG.group_size, STEPS * CONFIG.group_size
    rng = np.random.default_rng(CONFIG.seed)
    t0 = time.perf_counter()
    src, dst = rmat.rmat_edges(rng, n_edges, CONFIG.scale, CONFIG.a, CONFIG.b, CONFIG.c)
    t_gen = time.perf_counter() - t0
    keys = src.astype(np.int64) * 2**32 + dst.astype(np.int64)
    n_distinct = int(np.unique(keys).size)
    out_deg = np.bincount(src)
    log(f"[data] {n_edges:,} R-MAT scale-{CONFIG.scale} edges, {n_distinct:,} distinct, "
        f"made in {t_gen:.1f} s, counted in {time.perf_counter() - t0 - t_gen:.1f} s (host)")
    return {
        "n_edges": n_edges,
        "n_distinct": n_distinct,
        "out_deg": out_deg,
        "R": torch.tensor(src.reshape(STEPS, group), device=DEVICE),
        "C": torch.tensor(dst.reshape(STEPS, group), device=DEVICE),
        "V": torch.ones((STEPS, group), dtype=torch.float32, device=DEVICE),
    }


def check_reads(torch, np, snap, top_k, data, what):
    """Snapshot nnz equals numpy's distinct count, values sum to the edge
    count, the top-10 out-degrees equal numpy's bincount."""
    n_distinct, out_deg = data["n_distinct"], data["out_deg"]
    check(int(snap.nnz) == n_distinct, (what, int(snap.nnz), n_distinct))
    check(not bool(snap.overflow), f"{what}: the snapshot fits its cap")
    live = snap.vals[:n_distinct]
    check(bool(torch.isfinite(live).all()), f"{what}: finite snapshot values")
    check(float(live.double().sum()) == float(data["n_edges"]), f"{what}: values sum to the edge count")
    ids, counts = (x.cpu().numpy() for x in top_k)
    check(np.array_equal(counts, np.sort(out_deg)[::-1][:10].astype(np.float32)), (what, counts))
    check(np.array_equal(out_deg[ids].astype(np.float32), counts), (what, ids, counts))
    log(f"[{what}] snapshot nnz {int(snap.nnz):,} == distinct keys; top-10 out-degree "
        f"ids {ids.tolist()} counts {counts.tolist()}")


def phase_main(torch, np, data):
    """The ``cuda`` engine (K=8) at full width: ``hier_cascade`` steps, the
    batches canonicalized by ``sort_dedup``."""
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.core import assoc, multistream
    from repro_torch.d4m import D4MStream
    from repro_torch.kernels.hier_cascade import ops

    R, C, V, n_edges = data["R"], data["C"], data["V"], data["n_edges"]
    cfg = CONFIG.to_session(
        instances_per_device=K, top_capacity=TOP_CAPACITY, snapshot_cap=data["n_distinct"]
    )
    sess = D4MStream(cfg)
    check(sess.kind == "cuda", sess.kind)
    plan = sess.plan
    log(f"[main] caps {plan.layer_caps}, state {plan.total_bytes / 1e9:.2f} GB planned")
    sess.state  # allocate before the clock starts
    torch.cuda.synchronize()

    # -- the main path, counted --------------------------------------------
    zero_counts()
    dropped = torch.zeros((), dtype=torch.int64, device=DEVICE)
    t0 = time.perf_counter()
    for g in range(STEPS):
        dropped += sess.ingest(R[g], C[g], V[g])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(launches == {"hier_cascade": STEPS, "sort_dedup": STEPS, "merge_add": 0}, launches)
    rate = n_edges / wall
    log(f"[main] ingest: {STEPS} groups in {wall:.3f} s = {rate:,.0f} updates/s, "
        f"launches {launches}")
    check(int(dropped) == 0, int(dropped))
    check(not sess.overflowed(), "no instance overflowed")
    casc = sess.state.cascades.cpu()
    check((casc[:, 1] > 0).all() and int(casc[:, 2].sum()) > 0, casc)
    log(f"[main] cascades per instance and layer: {casc.tolist()}")

    # -- the same routed batches: kernel alone (timed) and plain version ---
    routed, batches, marks = [], [], []
    for g in range(STEPS):
        e0, e1, e2 = event(torch), event(torch), event(torch)
        e0.record()
        br, bc, bv, _ = sess.route(R[g], C[g], V[g])
        e1.record()
        batches.append(ops.canonical_batch(br, bc, bv, sess.sr))
        e2.record()
        routed.append((br, bc, bv))
        marks.append((e0, e1, e2))
    torch.cuda.synchronize()
    route_ms = float(np.mean([a.elapsed_time(b) for a, b, _ in marks]))
    canon_ms = float(np.mean([b.elapsed_time(c) for _, b, c in marks]))
    log(f"[main] per step: route {route_ms:.4f} ms, canonicalize (sort_dedup) {canon_ms:.4f} ms "
        f"(CUDA events, step by step)")
    cuts, caps, sr = sess.cuts, plan.layer_caps, sess.sr

    def fresh():
        h = multistream.init_packed(K, cuts, cfg.top_capacity, cfg.batch_size, sr, device=DEVICE)
        return multistream.flat_layer_state(h)

    # each launch waits behind a spin of the card: the wrapper's host work
    # (checks, scratch, ctypes arguments) runs meanwhile, so the events time
    # the kernel alone; the host time is taken apart, on the host clock
    s0, s1 = event(torch), event(torch)
    s0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    s1.record()
    torch.cuda.synchronize()
    sleep_ms = s0.elapsed_time(s1)
    flat_k = fresh()
    kernel_ms, host_ms = [], []
    for b in batches:
        flat_k[3][:, 0] |= b.overflow
        start, end = event(torch), event(torch)
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

    # the plain version: batches canonicalized by from_triples_plain (held
    # bit-identical to sort_dedup's), then the plain step, timed alone
    flat_p = fresh()
    merges, plain_ms = [], []
    for (br, bc, bv), b in zip(routed, batches):
        pb = assoc.from_triples_plain(br, bc, bv, cap=br.shape[-1], sr=sr)
        err_b = assoc_same(torch, b, pb, "canonical batch: sort_dedup vs plain")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat_p = plain_step(flat_p, pb, cuts, caps, sr, merges)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)

    err = max(err_b, compare(torch, multistream.from_flat_layer_state(*flat_k), sess.state, "replay vs main path"))
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
        f"{np.mean(plain_ms):.3f} ms/step (the step alone)")
    return sess, {
        "launches": launches,
        "err": err,
        "ms": ms,
        "plain_ms": float(np.mean(plain_ms)),
        "bound_ms": bound_ms,
        "host_ms": float(np.mean(host_ms)),
        "rate": rate,
        "canon_ms": canon_ms,
        "routed": routed[0],
    }


def phase_read_side(torch, np, sess, data):
    """The full-width K=8 snapshot and ``query.degrees`` through the
    kernels, then inside ``plain_versions()``: bit-identical."""
    from repro_torch import kernels

    n = data["n_distinct"]
    out = {}
    for mode in ("kernels", "plain"):
        sess._invalidate()
        torch.cuda.synchronize()
        zero_counts()
        ctx = kernels.plain_versions() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            snap = sess.snapshot(cap=n)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            deg = sess.query.degrees()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            top = sess.query.top_k(10)
        counts = read_counts()
        out[mode] = (snap, deg, top, (t1 - t0) * 1e3, (t2 - t1) * 1e3, counts)
        log(f"[read] {mode}: snapshot {(t1 - t0) * 1e3:.2f} ms, degrees {(t2 - t1) * 1e3:.2f} ms "
            f"(host clock, synchronized), launches {counts}")
    k, p = out["kernels"], out["plain"]
    check(k[5]["merge_add"] > 0 and k[5]["sort_dedup"] > 0, k[5])
    check(sum(p[5].values()) == 0, ("plain_versions() launched a kernel", p[5]))
    err = assoc_same(torch, k[0], p[0], "snapshot")
    for a, b, what in zip(k[1], p[1], ("out-degree", "in-degree")):
        err = max(err, assoc_same(torch, a, b, what))
    check_reads(torch, np, k[0], k[2], data, "read")
    log("[read] K=8 snapshot and degrees: kernels == plain versions (bit-identical)")
    return {"err": err, "snapshot_ms": k[3], "degrees_ms": k[4], "plain_snapshot_ms": p[3],
            "plain_degrees_ms": p[4], "launches": k[5]}


def phase_single(torch, np, data):
    """The single-instance engine (K=1) at the paper's instance shape, at
    full width, through the kernels and again inside ``plain_versions()``."""
    from repro_torch import kernels
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.d4m import D4MStream

    R, C, V, n_edges = data["R"], data["C"], data["V"], data["n_edges"]
    cfg = CONFIG.to_session(snapshot_cap=data["n_distinct"])
    runs = {}
    for mode in ("kernels", "plain"):
        sess = D4MStream(cfg)
        check(sess.kind == "single", sess.kind)
        sess.state
        torch.cuda.synchronize()
        zero_counts()
        ctx = kernels.plain_versions() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            for g in range(STEPS):
                sess.ingest(R[g], C[g], V[g])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = read_counts()
        runs[mode] = (sess, wall, counts)
        log(f"[single] {mode}: {STEPS} groups in {wall:.3f} s = {n_edges / wall:,.0f} updates/s, "
            f"launches {counts}")
        if mode == "kernels":
            plan = sess.plan
            log(f"[single] caps {plan.layer_caps}, state {plan.total_bytes / 1e9:.2f} GB planned")
    sess, wall, counts = runs["kernels"]
    check(counts["sort_dedup"] >= STEPS and counts["merge_add"] >= STEPS
          and counts["hier_cascade"] == 0, counts)
    check(sum(runs["plain"][2].values()) == 0, ("plain_versions() launched a kernel", runs["plain"][2]))
    casc = sess.state.cascades.cpu()
    check(bool((casc[1:] > 0).all()), ("every cascade level fired", casc))
    check(not sess.overflowed(), "the single instance did not overflow")
    log(f"[single] cascades per layer {casc.tolist()}, nnz per layer "
        f"{[int(l.nnz) for l in sess.state.layers]}")
    err = compare(torch, sess.state, runs["plain"][0].state, "single: kernels vs plain")
    log("[single] state through the kernels == plain versions (bit-identical)")
    del runs["plain"]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    snap = sess.snapshot()
    top = sess.query.top_k(10)
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    check_reads(torch, np, snap, top, data, "single")
    log(f"[single] snapshot + degrees + top_k {read_ms:.2f} ms, launches {read_counts()}")
    return sess, {"err": err, "rate": n_edges / wall, "launches": counts}


def phase_algebra(torch, np, n_v=2**16, n_e=500_000, fanout=64):
    """The D4M algebra and graph queries on a bounded-degree graph
    (uniform random, 2^16 vertices, 500,000 edges, max_fanout 64): kernels
    against plain versions bit for bit, the triangle count against scipy."""
    import scipy.sparse as sp

    from repro_torch import kernels
    from repro_torch.core import analytics, assoc
    from repro_torch.core.semiring import MAX_MIN, PLUS_TIMES

    rng = np.random.default_rng(2024)

    def simple_edges():  # no self-loops: a simple graph once symmetrized
        src = rng.integers(0, n_v, n_e)
        dst = (src + rng.integers(1, n_v, n_e)) % n_v
        return np.stack([src, dst]).astype(np.int32)

    edges = [simple_edges(), simple_edges()]
    cap_ab, cap_sq = 2 * n_e, 32_000_000

    def run():
        (ra, ca), (rb, cb) = ([torch.tensor(x, device=DEVICE) for x in e] for e in edges)
        ones = torch.ones(n_e, dtype=torch.float32, device=DEVICE)
        a = assoc.from_triples(ra, ca, ones, n_e)
        b = assoc.from_triples(rb, cb, ones, n_e)
        with assoc.cap_policy(add_cap=cap_ab, matmul_cap=cap_sq, max_fanout=fanout):
            out = {"A": a, "A+B": a + b, "A&B": a & b, "A@A.T": a @ a.T}
        und = analytics.undirected_view(a, sr=PLUS_TIMES)
        out["undirected"] = und
        out["triangles"] = analytics.triangle_count(und, cap_sq=cap_sq, max_fanout=fanout)
        u, v = int(edges[0][0, 0]), int(edges[0][1, 0])
        out["common_neighbors"] = analytics.common_neighbors(und, u, v, cap=4096)
        out["jaccard"] = analytics.jaccard(und, u, v, cap=4096)
        out["reachable_within(2)"] = analytics.reachable_within(a, 2, cap=cap_sq, max_fanout=fanout, sr=MAX_MIN)
        torch.cuda.synchronize()
        return out

    res = {}
    for mode in ("kernels", "plain"):
        zero_counts()
        ctx = kernels.plain_versions() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            res[mode] = run()
            wall = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        log(f"[algebra] {mode}: {wall:.1f} ms (host clock, synchronized), launches {counts}")
        if mode == "kernels":
            check(counts["merge_add"] > 0 and counts["sort_dedup"] > 0, counts)
            launches = counts
        else:
            check(sum(counts.values()) == 0, ("plain_versions() launched a kernel", counts))
    err = 0.0
    for name, got in res["kernels"].items():
        want = res["plain"][name]
        if isinstance(got, assoc.Assoc):
            err = max(err, assoc_same(torch, got, want, f"algebra {name}"))
            check(not bool(got.overflow), f"{name}: no capacity or fanout overflow")
        else:
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)), (name, got, want))
    und = res["kernels"]["undirected"]
    n = int(und.nnz)
    deg = np.bincount(und.rows[:n].cpu().numpy(), minlength=n_v)
    check(int(deg.max()) <= fanout, ("the undirected graph's degree fits max_fanout", int(deg.max())))
    m = sp.csr_matrix((np.ones(n, np.int64), (und.rows[:n].cpu().numpy(), und.cols[:n].cpu().numpy())),
                      shape=(n_v, n_v))
    tri = int((m @ m @ m).diagonal().sum()) // 6
    got = float(res["kernels"]["triangles"])
    check(got == float(tri), ("triangles against scipy trace(A^3)/6", got, tri))
    log(f"[algebra] kernels == plain versions (bit-identical) for {sorted(res['kernels'])}; "
        f"triangles {got:.0f} == scipy trace(A^3)/6; max undirected degree {int(deg.max())}; "
        f"nnz A+B {int(res['kernels']['A+B'].nnz):,}, A@A.T {int(res['kernels']['A@A.T'].nnz):,}, "
        f"reach2 {int(res['kernels']['reachable_within(2)'].nnz):,}")
    return {"err": err, "launches": launches}


def time_kernel(torch, np, fn, reps=10):
    """Mean ms of ``fn`` on the card, each call queued behind a spin so the
    events time the launches alone (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        s, e = event(torch), event(torch)
        s.record()
        fn()
        e.record()
        marks.append((s, e))
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in marks]))


def time_host(torch, np, fn, reps=5):
    """Mean ms of ``fn`` on the host clock, synchronized on both sides (for
    the plain versions, whose many small launches wait on the host)."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(out))


def phase_kernel_times(torch, np, data, main, single):
    """Per-call times of ``sort_dedup`` and ``merge_add`` at the main
    paths' shapes, with their byte bounds and plain versions; torch.sort on
    the same keys as a reference only."""
    from repro_torch.core import assoc
    from repro_torch.kernels.merge_add import ops as mops
    from repro_torch.kernels.sort_dedup import ops as sops

    sr = single.sr
    rows = {}
    br, bc, bv = main["routed"]
    shapes = {
        "[8, 100000] (cuda engine batch)": (br, bc, bv),
        "[100000] (single engine batch)": (data["R"][0], data["C"][0], data["V"][0]),
    }
    for name, (r, c, v) in shapes.items():
        out = sops.from_triples(r, c, v, r.shape[-1], sr)
        nbytes = ENTRY_BYTES * (r.numel() + int(out.nnz.sum()))
        ms = time_kernel(torch, np, lambda: sops.from_triples(r, c, v, r.shape[-1], sr))
        plain = time_host(torch, np, lambda: assoc.from_triples_plain(r, c, v, r.shape[-1], sr))
        keys = assoc.pack_keys(r, c)
        ref = time_kernel(torch, np, lambda: torch.sort(keys, dim=-1, stable=True))
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bytes": nbytes, "torch_sort_ms": ref}
        log(f"[times] sort_dedup {name}: {ms:.4f} ms, bound {rows[name]['bound_ms']:.5f} ms "
            f"({nbytes / 1e6:.2f} MB), plain {plain:.3f} ms; torch.sort of the same keys "
            f"{ref:.4f} ms (reference only)")
    # the fold stage at the degrees' shape (the snapshot's rows with column
    # 0: runs as long as a vertex's out-degree), and the longest such run
    # alone (one thread folds it serially)
    snap = single.snapshot()
    zero_c = torch.where(snap.rows != assoc.PAD, 0, assoc.PAD).to(torch.int32)
    longest = int(data["out_deg"].max())
    run = torch.zeros(longest, dtype=torch.int32, device=DEVICE)
    run_v = torch.ones(longest, dtype=torch.float32, device=DEVICE)
    for name, (r, c, v) in {
        f"degrees fold [{snap.capacity}]": (snap.rows, zero_c, snap.vals),
        f"one run of {longest}": (run, run, run_v),
    }.items():
        cap = r.shape[-1]
        nbytes = ENTRY_BYTES * (r.numel() + int(sops.combine_sorted(r, c, v, cap, sr).nnz))
        ms = time_kernel(torch, np, lambda: sops.combine_sorted(r, c, v, cap, sr), reps=5)
        plain = time_host(torch, np, lambda: assoc.combine_sorted_plain(r, c, v, cap, sr), reps=3)
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bytes": nbytes}
        log(f"[times] sort_dedup fold stage, {name}: {ms:.4f} ms, bound "
            f"{rows[name]['bound_ms']:.5f} ms, plain {plain:.3f} ms")
    # merge_add: the single engine's layer-1 merge (layer 1 holding one
    # batch, a second batch into it), and the snapshot's merges (the top
    # layer + layer 3, then + 2, + 1)
    layers = single.state.layers
    b0, b1 = (assoc.from_triples(data["R"][g], data["C"][g], data["V"][g], data["R"].shape[1], sr)
              for g in (0, 1))
    cap1 = layers[0].capacity
    cases = {"layer-1 merge": (assoc.add(assoc.empty(cap1, sr, device=DEVICE), b0, cap1, sr), b1, cap1)}
    snap = layers[-1]
    for i in range(len(layers) - 2, -1, -1):  # hierarchical.snapshot's order
        cases[f"snapshot merge +layer {i + 1}"] = (snap, layers[i], data["n_distinct"])
        snap = assoc.add(snap, layers[i], cap=data["n_distinct"], sr=sr)
    for name, (a, b, cap) in cases.items():
        out = mops.merge_add(a, b, cap, sr)
        nbytes = ENTRY_BYTES * (int(a.nnz) + int(b.nnz) + int(out.nnz))
        ms = time_kernel(torch, np, lambda: mops.merge_add(a, b, cap, sr), reps=5)
        plain = time_host(torch, np, lambda: assoc.add_plain(a, b, cap, sr), reps=3)
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bytes": nbytes}
        log(f"[times] merge_add {name} ({int(a.nnz):,} + {int(b.nnz):,} -> {int(out.nnz):,}): "
            f"{ms:.4f} ms, bound {rows[name]['bound_ms']:.5f} ms, plain {plain:.3f} ms")
    return rows


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
    ops_err = phase_parity_ops(torch, np)
    data = phase_data(torch, np)
    sess8, main_run = phase_main(torch, np, data)
    read = phase_read_side(torch, np, sess8, data)
    del sess8
    single_sess, single = phase_single(torch, np, data)
    times = phase_kernel_times(torch, np, data, main_run, single_sess)
    del single_sess
    algebra = phase_algebra(torch, np)
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    paths = {"cuda": main_run["launches"], "single": single["launches"], "read": read["launches"],
             "algebra": algebra["launches"]}
    err = max(ops_err, main_run["err"], read["err"], single["err"], algebra["err"])

    def launches(kernel):
        by_path = {p: c[kernel] for p, c in paths.items()}
        return sum(by_path.values()), by_path

    sd8, sd1 = times["[8, 100000] (cuda engine batch)"], times["[100000] (single engine batch)"]
    l1 = times["layer-1 merge"]
    snaps = {k: v for k, v in times.items() if k.startswith("snapshot merge")}
    kernels = [{
        "name": "hier_cascade",
        "route": "cuda",
        "source": "src/repro_torch/csrc/hier_cascade.cu",
        "replaces": "src/repro/kernels/hier_cascade/kernel.py:168",
        "launches": launches("hier_cascade")[0],
        "launches_by_path": launches("hier_cascade")[1],
        "max_abs_err": max(parity_err, main_run["err"]),
        "ms": main_run["ms"],
        "plain_ms": main_run["plain_ms"],
        "bound_ms": main_run["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "host_ms": main_run["host_ms"],
        "parity": "bit-identical",
    }, {
        "name": "merge_add",
        "route": "cuda",
        "source": "src/repro_torch/csrc/merge_add.cu",
        "replaces": "src/repro/kernels/merge_add/kernel.py:75",
        "launches": launches("merge_add")[0],
        "launches_by_path": launches("merge_add")[1],
        "max_abs_err": err,
        "ms": l1["ms"],
        "plain_ms": l1["plain_ms"],
        "bound_ms": l1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "ms_snapshot_merges": {k: v["ms"] for k, v in snaps.items()},
        "plain_ms_snapshot_merges": {k: v["plain_ms"] for k, v in snaps.items()},
        "bound_ms_snapshot_merges": {k: v["bound_ms"] for k, v in snaps.items()},
        "parity": "bit-identical",
    }, {
        "name": "sort_dedup",
        "route": "cuda",
        "source": "src/repro_torch/csrc/sort_dedup.cu",
        "replaces": "src/repro/kernels/sort_dedup/kernel.py:50",
        "launches": launches("sort_dedup")[0],
        "launches_by_path": launches("sort_dedup")[1],
        "max_abs_err": err,
        "ms": sd8["ms"],
        "plain_ms": sd8["plain_ms"],
        "bound_ms": sd8["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "ms_single_batch": sd1["ms"],
        "plain_ms_single_batch": sd1["plain_ms"],
        "bound_ms_single_batch": sd1["bound_ms"],
        "torch_sort_ms": {"[8, 100000]": sd8["torch_sort_ms"], "[100000]": sd1["torch_sort_ms"]},
        "fold_stage": {k: v for k, v in times.items() if k.startswith(("degrees fold", "one run"))},
        "parity": "bit-identical",
    }]
    log(f"[rates] cuda engine K=8 {main_run['rate']:,.0f} updates/s; single engine K=1 "
        f"{single['rate']:,.0f} updates/s")
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
