#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which asserts (any failure exits non-zero):

1. build every kernel from the sources in the checkout (``nvcc``, sm_90a,
   one process per source, all started together);
2. hold the ``hier_cascade`` kernel against its plain PyTorch version on the
   card, bit-exactly, in float32 and bfloat16, at the CPU parity tests'
   shapes, at a mid shape where both cuts fire, on merges of over a million
   entries, with a top layer truncating at its cap, with an equal-key pair
   across every merge-path tile edge, for every semiring fold code, and
   with NaN and -0.0 in the batches and in entries the layers already hold;
3. hold ``merge_add`` and ``sort_dedup`` against their plain versions, bit
   for bit: every fold code, float32 and bfloat16, NaN and -0.0, leading
   batch axes, caps below the union, empty inputs, one huge run, up to 5 M
   entries, a pair across every tile edge; for ``sort_dedup`` also runs
   from every offset in a tile across 1, 2 and ~25 tiles, the degrees'
   shape at 1 M, groups with no, one, scattered and prefix live entries, a
   sort tile exactly full; and ``scatter_add``: float32 and
   bfloat16 tables and rows, PAD
   tails, NaN and -0.0 with row 0 live or dead (C10), negative and
   out-of-range ids, k = 0, d of 1, 3 and 4096, a misaligned table, and the
   embedding path's own shape;
4. make the R-MAT stream once (200 groups of 100,000 scale-20 edges,
   ``configs/d4m_stream.CONFIG``) and count it with numpy;
5. the ``cuda`` engine at full width: K=8 hash-routed instances of the
   paper's instance shape (cuts 100k/1M/10M, top capacity 16,000,000
   each) through ``D4MStream(cfg).ingest``, 200 ``sort_dedup`` calls and
   200 ``hier_cascade`` launches; replay the same routed batches through
   the kernel alone (timed on the card by step kind, the wrapper's host
   time apart, each call under ``torch.cuda.set_sync_debug_mode("error")``)
   and through the plain versions, and require all three states
   bit-identical; then 120 groups in bfloat16 through the kernels and
   inside ``kernels.plain_versions()``, bit-identical;
6. the read side: the K=8 snapshot and ``query.degrees`` through the
   kernels and inside ``kernels.plain_versions()``, bit-identical, checked
   against numpy's distinct count and ``bincount``;
7. the ``single`` engine (K=1, ``CONFIG`` unchanged: top capacity 140 M)
   at full width, through the kernels and inside ``plain_versions()``,
   bit-identical, every cascade level firing;
8. per-call times of ``sort_dedup`` and ``merge_add`` at the main paths'
   shapes (``sort_dedup``: both engines' batches, the degrees' fold stage
   and its longest run, with the CUDA launches and the wrapper's host ms a
   call; ``merge_add``: the layer-1 merge, the snapshot merges and the
   ``single`` engine's last 1->2, 2->3 and 3->4 cascade merges), with
   their byte bounds (dead-tail bytes apart), plain versions and
   ``torch.sort`` of the same keys as a reference;
9. the algebra and graph queries on a uniform random graph (2^16
   vertices, 500,000 edges, ``max_fanout`` 64), kernels against plain bit
   for bit, triangles against scipy's ``trace(A^3)/6``;
10. the embedding-gradient path at granite-3-8b's full width (after the
    streaming phases' state is freed): one optimizer window of 256
    microbatches of 4096 tokens (``TokenStream``, Zipf 1.3) into the
    hierarchical row accumulator, ``hier_flush``, ``dense_grad_of``
    (``scatter_add`` into a [49,664, 4096] float32 table) and lazy AdamW on
    the bfloat16 table; through the kernel and inside ``plain_versions()``,
    bit-identical, against the dense ``index_add_`` baseline (summed in
    float64) at ``rtol=1e-4, atol=1e-5``, with nnz equal to numpy's
    distinct count;
    then ``scatter_add`` alone at that shape, with its bound, plain version
    and ``index_add_`` of the live prefix as a yardstick;
11. the fleet (``repro_torch.fleet``, after the serve phases, with this
    process's streaming state freed first): N = 1, 2 and 4 worker
    processes, each a full-width ``cuda`` session (K=8, ``CONFIG``) fed its
    host-tier shard of the 200 groups by ``FleetController.run``; N=4
    again with the default ``ServeConfig``; and a kill leg (N=2 at reduced
    depth, checkpointing: SIGKILL after the first durable checkpoint,
    revive, replay).  Every merged snapshot (one ``sort_dedup`` call over
    the workers' snapshots) is bit-identical to the library-mode K=8
    snapshot, at N=4 also inside ``plain_versions()``; every worker
    reports its own ``hier_cascade``, ``sort_dedup`` and ``merge_add``
    launches; a ``[fleet-metrics]`` line holds the rates;
12. the port's benchmark suite (after the fleet, this process's streaming
    state freed): ``python -m repro_torch.benchmarks.run --experiment
    src/repro_torch/benchmarks/experiments/chip.json`` in a subprocess, all
    nine sections at full width (``hier`` at the paper's 100 M edges; the
    served sections and the fleet on the 20 M-record stream at ``CONFIG``'s
    cuts, K=8, microbatches of 100,000; the kernels at the main paths'
    shapes); every ``BENCH_<section>.json`` read back through the port's
    parsers, the port's gate clean on an empty history, every section's
    correctness fields true (kernels bit-identical to their plain
    versions, every snapshot's values the stream's counts) and its kernels
    launched; a ``[bench-metrics]`` line holds
    its rates and verdicts, and the ``kernels`` line its launches as
    ``bench_<section>`` paths;
13. print a ``{"kernels": [...]}`` line, the card's name and power limit,
    and as the last line ``{"ok": true, "device": {...}}``.

Launch counters are zeroed just before each path and read just after;
inside ``plain_versions()`` they must not move.

Without CUDA, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
ENTRY_BYTES = 12  # int32 row + int32 col + float32 value
STEPS = 200
BF16_STEPS = 120  # the bfloat16 ingest: layer 1 -> 2 fires in every instance
BOUNDARY_PAIRS = 1 << 20  # entries paired across every tile edge (boundary_case)
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
    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        bits_same(torch, g, w, f"{what}: leaf {i}")
    return 0.0


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


def make_values(torch, np, rng, shape, special, dtype):
    """Values of ``dtype`` on the card.  Floats: normal, or with
    ``special`` a quarter each NaN, -0.0, +0.0 and normal, rounded to the
    type.  int32: half small, half anywhere in the int32 range (so ``plus``
    wraps), and with ``special`` a quarter each INT32_MIN and INT32_MAX."""
    if dtype == torch.int32:
        v = np.where(rng.random(shape) < 0.5, rng.integers(-(2**31), 2**31, shape),
                     rng.integers(-5, 6, shape))
        if special:
            pick = rng.integers(0, 4, shape)
            v[pick == 0], v[pick == 1] = -(2**31), 2**31 - 1
        return torch.tensor(v.astype(np.int32), device=DEVICE)
    if special:
        return special_values(torch, np, rng, shape).to(dtype)
    return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=DEVICE).to(dtype)


def plant_special(torch, h):
    """Overwrite every third live entry of every layer with -0.0 and the
    next with NaN (int32: INT32_MIN and INT32_MAX), so later merges fold
    into such entries."""
    for l in h.layers:
        idx = torch.arange(l.capacity, device=l.vals.device)
        live = idx < l.nnz[:, None]
        ints = l.vals.dtype == torch.int32
        l.vals[live & (idx % 3 == 0)] = -(2**31) if ints else -0.0
        l.vals[live & (idx % 3 == 1)] = 2**31 - 1 if ints else float("nan")


def phase_parity(torch, np):
    """Kernel against plain version on the card, bit-exactly: float32,
    bfloat16, float16 and int32, every fold code, NaN and -0.0 (int32: its
    extremes, and ``plus`` wrapping), merges that span many
    partitions (layers of over a million entries), a merge that truncates
    at the top layer's cap, steps where no cut fires, and equal-key pairs on
    every partition boundary (:func:`boundary_case`)."""
    from repro_torch.core import semiring
    from repro_torch.kernels.hier_cascade import ops

    f32, bf16, f16, i32 = torch.float32, torch.bfloat16, torch.float16, torch.int32
    cases = [
        # (name, K, cuts, top, batch, steps, key space, semiring, value type)
        ("absent-K1", 1, (512,), 2048, 8, 5, 48, "plus.times", f32),
        ("absent-K8", 8, (512,), 2048, 8, 5, 48, "plus.times", f32),
        ("forced-K1", 1, (8, 32), 256, 16, 6, 48, "plus.times", f32),
        ("forced-K8", 8, (8, 32), 256, 16, 6, 48, "plus.times", f32),
        ("overflow", 2, (8,), 12, 16, 6, 256, "plus.times", f32),
        ("max.plus", 2, (8, 32), 256, 16, 5, 48, "max.plus", f32),
        ("min.plus", 2, (8, 32), 256, 16, 5, 48, "min.plus", f32),
        ("union.first", 2, (8, 32), 256, 16, 5, 48, "union.first", f32),
        # merges of 1-2 M entries (hundreds of partitions), cascading into
        # the top layer; a top layer that truncates at its cap
        ("big-plus.times", 8, (131072, 1048576), 4_000_000, 65536, 32, 2048, "plus.times", f32),
        ("big-nan-min.plus-bf16", 8, (131072, 1048576), 4_000_000, 65536, 32, 2048, "min.plus", bf16),
        ("trunc-big", 4, (65536,), 150_000, 65536, 8, 4096, "plus.times", f32),
        ("trunc-big-bf16", 4, (65536,), 150_000, 65536, 8, 4096, "max.plus", bf16),
    ]
    for srn in FOLDS:
        for dt in (f32, bf16):
            tag = "" if dt == f32 else "-bf16"
            cases.append((f"mid-{srn}{tag}", 8, (4096, 32768), 262144, 4096, 64, 1024, srn, dt))
            cases.append((f"nan-{srn}{tag}", 8, (8, 32), 256, 16, 8, 48, srn, dt))
            cases.append((f"mid-nan-{srn}{tag}", 8, (4096, 32768), 262144, 4096, 24, 1024, srn, dt))
        for dt, tag in ((f16, "-f16"), (i32, "-i32")):
            cases.append((f"mid-{srn}{tag}", 8, (4096, 32768), 262144, 4096, 64, 1024, srn, dt))
            cases.append((f"nan-{srn}{tag}", 8, (8, 32), 256, 16, 8, 48, srn, dt))
    err = 0.0
    for name, k, cuts, top, batch, steps, space, srn, dt in cases:
        sr = semiring.get(srn)
        rng = np.random.default_rng(len(name) * 7919 + steps)
        special = "nan" in name
        R = torch.tensor(rng.integers(0, space, (steps, k, batch)), dtype=torch.int32, device=DEVICE)
        C = torch.tensor(rng.integers(0, space, (steps, k, batch)), dtype=torch.int32, device=DEVICE)
        V = make_values(torch, np, rng, (steps, k, batch), special, dt)
        hk, caps = ops.init_state(k, cuts, top, batch, sr, dt, device=DEVICE)
        hp, _ = ops.init_state(k, cuts, top, batch, sr, dt, device=DEVICE)
        for t in range(steps):
            hk = ops.cascade_update(hk, R[t], C[t], V[t], cuts, caps, sr)
            hp = plain_update(hp, R[t], C[t], V[t], cuts, caps, sr)
            if special and t == 1:
                plant_special(torch, hk)
                plant_special(torch, hp)
        torch.cuda.synchronize()
        err = max(err, compare(torch, hk, hp, name))
        casc = hk.cascades.cpu()
        if name.startswith(("mid", "big")):
            check((casc[:, 1] > 0).all(), (name, casc))
            check(int(casc[:, 2].sum()) > 0, (name, casc))
        if name.startswith("trunc"):
            check(bool(hk.layers[-1].overflow.all()), (name, "the top layer truncated at its cap"))
        if special and dt != i32:
            n_nan = sum(int(l.vals.isnan().sum()) for l in hk.layers)
            check(n_nan > 0, (name, "NaN survives in the layers"))
        log(f"[parity] {name}: bit-identical, cascades per layer {casc.sum(0).tolist()}, "
            f"nnz per layer (instance 0) {[int(l.nnz[0]) for l in hk.layers]}")
    for srn in FOLDS:
        for dt in (f32, bf16):
            err = max(err, boundary_case(torch, np, srn, dt))
    for srn in ("plus.times", "min.plus"):
        for dt in (f16, i32):
            err = max(err, boundary_case(torch, np, srn, dt))
    return err


def boundary_case(torch, np, srn, dtype):
    """One step whose two merges pair every entry, with an equal-key pair
    straddling every merge-path partition boundary: layer 1 holds keys
    {1} + S, the batch S, layer 2 {0, 1} + S (S = 2 .. n+1), so in either
    merge's dst-first order the pairs sit at odd/even positions that every
    even diagonal splits.  Layer 1's cut fires into layer 2."""
    from repro_torch.core import semiring
    from repro_torch.kernels.hier_cascade import ops

    sr, n = semiring.get(srn), BOUNDARY_PAIRS
    k, cuts, top = 2, (n // 2, 4 * n), n
    rng = np.random.default_rng(n + len(srn))

    def keys(idx):
        idx = torch.tensor(idx, dtype=torch.int64, device=DEVICE)
        return (idx // 4096).to(torch.int32), (idx % 4096).to(torch.int32)

    s = np.arange(2, n + 2)
    presets = {0: np.concatenate([[1], s]), 1: np.concatenate([[0, 1], s])}
    states = []
    for _ in range(2):
        h, caps = ops.init_state(k, cuts, top, n, sr, dtype, device=DEVICE)
        states.append(h)
    for i, idx in presets.items():
        r, c = keys(idx)
        v = make_values(torch, np, rng, (k, idx.size), True, dtype)
        for h in states:
            l = h.layers[i]
            l.rows[:, : idx.size], l.cols[:, : idx.size], l.vals[:, : idx.size] = r, c, v
            l.nnz.fill_(idx.size)
    r, c = keys(s)
    R, C = r.expand(k, n).contiguous(), c.expand(k, n).contiguous()
    V = make_values(torch, np, rng, (k, n), True, dtype)
    hk = ops.cascade_update(states[0], R, C, V, cuts, caps, sr)
    hp = plain_update(states[1], R, C, V, cuts, caps, sr)
    torch.cuda.synchronize()
    err = compare(torch, hk, hp, f"boundary {srn} {dtype}")
    casc = hk.cascades.cpu()
    check(bool((casc[:, 1] == 1).all()) and [int(x) for x in hk.layers[1].nnz] == [n + 2] * k,
          ("boundary: layer 1 fired into layer 2, every entry paired", casc, hk.layers[1].nnz))
    log(f"[parity] boundary {srn}/{str(dtype)[6:]}: {n + 1:,} + {n:,} and {n + 2:,} + {n + 1:,} "
        f"entries, a pair across every partition boundary: bit-identical")
    return err


def assoc_same(torch, got, want, what: str) -> float:
    """Bitwise equality of two Assocs (values compared by bit pattern);
    returns the max abs value error (0.0 when identical), raising on any
    difference."""
    for f in ("rows", "cols", "vals", "nnz", "overflow"):
        bits_same(torch, getattr(got, f), getattr(want, f), f"{what}: {f}")
    return 0.0


def bits_same(torch, got, want, what) -> float:
    """Bitwise equality of two tensors (floats by their bits); returns the
    max abs value error (0.0 when identical), raising on any difference."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          (what, got.shape, want.shape, got.dtype, want.dtype))
    if got.dtype.is_floating_point:
        bits = torch.int16 if got.element_size() == 2 else torch.int32
        if torch.equal(got.view(bits), want.view(bits)):
            return 0.0
        both = torch.isfinite(got) & torch.isfinite(want)
        err = float((got[both].float() - want[both].float()).abs().max()) if both.any() else float("inf")
        raise RuntimeError(f"{what}: differs (max abs value error {err})")
    if not torch.equal(got, want):
        raise RuntimeError(f"{what}: differs")
    return 0.0


def random_triples(torch, np, rng, shape, space, special, dtype):
    """int32 rows/cols in ``[0, space)`` and :func:`make_values` on the
    card."""
    r = torch.tensor(rng.integers(0, space, shape), dtype=torch.int32, device=DEVICE)
    c = torch.tensor(rng.integers(0, space, shape), dtype=torch.int32, device=DEVICE)
    return r, c, make_values(torch, np, rng, shape, special, dtype)


FOLDS = ("plus.times", "max.plus", "min.plus", "union.first")
PAD_ROW = 2**31 - 1  # assoc.PAD: a dead key's row

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
    card, bit for bit: every fold code, float32 and bfloat16 (normal and
    special values), float16 and int32 (special values: NaN and -0.0, or
    the int32 extremes), leading batch axes, caps below the union, empty
    inputs, runs up to the whole input, and a mid shape of about 1 M
    entries."""
    from repro_torch.core import assoc, semiring
    from repro_torch.kernels.merge_add import ops as mops
    from repro_torch.kernels.sort_dedup import ops as sops

    err, cases = 0.0, 0
    # (value type, special values, seed offset)
    variants = [(torch.float32, False, 0), (torch.float32, True, 1), (torch.bfloat16, False, 7),
                (torch.bfloat16, True, 8), (torch.float16, True, 14), (torch.int32, True, 21)]
    for srn in FOLDS:
        sr = semiring.get(srn)
        for dtype, special, seed in variants:
            rng = np.random.default_rng(len(srn) * 31 + seed)
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
            for name, r, c, v, valid, cap, is_sorted in sort_edge_cases(torch, np, rng, special, dtype):
                if is_sorted:
                    got = sops.combine_sorted(r, c, v, cap, sr)
                    want = assoc.combine_sorted_plain(r, c, v, cap, sr)
                else:
                    got = sops.from_triples(r, c, v, cap, sr, valid)
                    want = assoc.from_triples_plain(r, c, v, cap, sr, valid)
                err = max(err, assoc_same(torch, got, want, f"sort_dedup {name} {tag}"))
                cases += 1
            # merge_add on sorted unique inputs
            for name, batch, m, n, space, cap in (
                ("small", (), 40, 24, 9, None),
                ("small-cap", (), 40, 24, 9, 10),
                ("batch", (3, 2), 64, 48, 12, None),
                ("disjoint-width", (), 1000, 30, 100, 500),
                ("mid", (), 1_000_000, 300_000, 2048, None),
                ("mid-cap", (2,), 500_000, 500_000, 1024, 600_000),
                ("big", (), 3_000_000, 2_000_000, 4096, None),
                ("big-cap", (2,), 1_500_000, 1_500_000, 2048, 1_000_000),
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
            # an equal-key pair across every merge-path tile edge
            for batch, cap in (((), None), ((2,), None), ((), 1_500_000)):
                a, b = paired_assocs(torch, np, rng, 1_000_000, batch, special, dtype, sr)
                got = mops.merge_add(a, b, cap, sr)
                want = assoc.add_plain(a, b, cap, sr)
                err = max(err, assoc_same(torch, got, want, f"merge_add pairs {batch} {cap} {tag}"))
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


def sort_edge_cases(torch, np, rng, special, dtype):
    """``(name, rows, cols, vals, valid, cap, sorted)`` on the card for
    ``sort_dedup``'s own edges (``sorted``: the fold stage alone):

    * runs from every offset in a 4096-entry tile crossing one tile edge,
      from 456 offsets crossing two, from 16 crossing ~25 (combine_sorted on
      the sorted keys, from_triples on a shuffle of them);
    * the degrees' shape at 1 M: sorted rows of a heavy-tailed degree
      sequence, column 0;
    * groups with no live entry, one, a scattered ``valid`` (some live rows
      PAD) and a live prefix; a sort tile exactly full of live entries."""
    def values(n):
        return make_values(torch, np, rng, (n,), special, dtype)

    def dev(x):
        return torch.tensor(x, dtype=torch.int32, device=DEVICE)

    lens = np.concatenate([np.full(4096, 4097), np.full(456, 8192 + 9), np.full(16, 25 * 4096 + 255)])
    rows = dev(np.repeat(np.arange(lens.size), lens))
    n = rows.numel()
    cols, v = torch.zeros_like(rows), values(n)
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    perm = torch.randperm(n, device=DEVICE, generator=gen)
    yield "run offsets", rows, cols, v, None, n, True
    yield "run offsets shuffled", rows[perm], cols[perm], v[perm], None, lens.size // 3, False
    deg = np.minimum(rng.zipf(1.3, 1_000_000), 2**20)
    drows = dev(np.sort(deg))
    yield "degrees 1M", drows, torch.zeros_like(drows), values(drows.numel()), None, drows.numel(), True
    g, w = 4, 20_000
    r, c, v = random_triples(torch, np, rng, (g, w), 64, special, dtype)
    live = np.zeros((g, w), bool)
    live[1, rng.integers(w)] = True  # group 0: nothing live; group 1: one entry
    live[2] = rng.random(w) < 0.3  # scattered, some live rows PAD
    live[3, : w // 8] = True  # a live prefix
    r[2, torch.tensor(rng.random(w) < 0.05, device=DEVICE)] = PAD_ROW
    yield "dead and scattered groups", r, c, v, torch.tensor(live, device=DEVICE), w, False
    yield "dead and scattered groups, cap", r, c, v, torch.tensor(live, device=DEVICE), 100, False
    n = 3 * 8192
    r, c, v = random_triples(torch, np, rng, (2, n), 256, special, dtype)
    live = np.zeros((2, n), bool)
    live[0] = True
    live[1, 4096:8192] = True  # one sort tile exactly full, the tiles around it dead
    yield "full tiles", r, c, v, torch.tensor(live, device=DEVICE), n, False


def paired_assocs(torch, np, rng, n, batch, special, dtype, sr):
    """``a`` with keys {1} + S, ``b`` with S (S = 2 .. n+1, key index x as
    (x // 4096, x % 4096)), each on the card with the given leading axes:
    every entry of ``b`` pairs with one of ``a``, at odd/even positions of
    the merged order, so every edge of an even merge-path tile cuts a pair."""
    from repro_torch.core.assoc import Assoc

    def make(idx):
        idx = torch.tensor(idx, dtype=torch.int64, device=DEVICE).expand(batch + (idx.size,))
        shape = idx.shape
        return Assoc(
            rows=(idx // 4096).to(torch.int32).contiguous(),
            cols=(idx % 4096).to(torch.int32).contiguous(),
            vals=make_values(torch, np, rng, shape, special, dtype),
            nnz=torch.full(batch, shape[-1], dtype=torch.int32, device=DEVICE),
            overflow=torch.zeros(batch, dtype=torch.bool, device=DEVICE),
        )

    s = np.arange(2, n + 2)
    return make(np.concatenate([[1], s])), make(s)


def counters():
    """The launch counters of the four kernels' wrappers."""
    from repro_torch.kernels.hier_cascade import ops as hc
    from repro_torch.kernels.merge_add import ops as ma
    from repro_torch.kernels.scatter_add import ops as sa
    from repro_torch.kernels.sort_dedup import ops as sd

    return {"hier_cascade": hc, "merge_add": ma, "scatter_add": sa, "sort_dedup": sd}


def zero_counts() -> None:
    for mod in counters().values():
        mod.launch_count = 0
        if hasattr(mod, "cuda_launch_count"):
            mod.cuda_launch_count = 0


def read_counts() -> dict:
    return {name: mod.launch_count for name, mod in counters().items()}


def cuda_launches_per_call(name: str) -> float:
    """CUDA kernel launches a wrapper call of ``name`` made since the counts
    were zeroed, as its CUDA entry counted them."""
    mod = counters()[name]
    return mod.cuda_launch_count / max(mod.launch_count, 1)


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
    from repro_torch.kernels import _launch
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
    check(launches == {"hier_cascade": STEPS, "sort_dedup": STEPS, "merge_add": 0, "scatter_add": 0}, launches)
    cuda_per_call = cuda_launches_per_call("hier_cascade")
    sort_per_call = cuda_launches_per_call("sort_dedup")
    rate = n_edges / wall
    log(f"[main] ingest: {STEPS} groups in {wall:.3f} s = {rate:,.0f} updates/s, "
        f"launches {launches}; CUDA launches a call: hier_cascade {cuda_per_call:g}, "
        f"sort_dedup {sort_per_call:g}")
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

    flat_k, kernel_ms, host_ms, casc_after, scratch = kernel_replay(
        torch, np, batches, fresh(), cuts, caps, sr)

    # the plain version: batches canonicalized by from_triples_plain (held
    # bit-identical to sort_dedup's), then the plain step, timed alone
    flat_p = fresh()
    merges, plain_ms, step_bytes = [], [], []
    for (br, bc, bv), b in zip(routed, batches):
        pb = assoc.from_triples_plain(br, bc, bv, cap=br.shape[-1], sr=sr)
        err_b = assoc_same(torch, b, pb, "canonical batch: sort_dedup vs plain")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n0 = len(merges)
        flat_p = plain_step(flat_p, pb, cuts, caps, sr, merges)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        step_bytes.append(merge_bytes(merges[n0:]) + K * 3 * plan.n_layers * 4)

    err = max(err_b, compare(torch, multistream.from_flat_layer_state(*flat_k), sess.state, "replay vs main path"))
    err = max(err, compare(torch, multistream.from_flat_layer_state(*flat_p), sess.state, "plain vs kernel"))
    log("[main] main-path state == kernel replay == plain version (bit-identical)")

    bound_ms = float(np.mean(step_bytes)) / HBM_BYTES_PER_S * 1e3
    ms = float(np.mean(kernel_ms))
    log(f"[main] hier_cascade: {ms:.4f} ms/step mean (median {np.median(kernel_ms):.4f}, "
        f"max {max(kernel_ms):.4f}); bound {bound_ms:.5f} ms/step "
        f"({np.mean(step_bytes) / 1e6:.2f} MB/step at 3.35 TB/s); plain version "
        f"{np.mean(plain_ms):.3f} ms/step (the step alone)")
    kinds = step_kinds(torch, np, casc_after, kernel_ms, step_bytes)
    for kind, row in kinds.items():
        log(f"[main] hier_cascade {kind} steps: {row['steps']}, {row['ms']:.4f} ms mean "
            f"(median {row['median_ms']:.4f}), bound {row['bound_ms']:.5f} ms")
    tiles = sum(t.nbytes for pair in _launch._merge_scratch.values() for t in pair)
    log(f"[main] hier_cascade scratch kept with a state {scratch / 1e9:.3f} GB (allocator delta "
        f"of its first call), merge tile scratch kept per stream {tiles / 1e6:.3f} MB; state "
        f"{plan.total_bytes / 1e9:.3f} GB")
    return sess, {
        "kinds": kinds,
        "cuda_launches_per_call": cuda_per_call,
        "sort_cuda_launches_per_call": sort_per_call,
        "scratch_bytes": scratch,
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


def kernel_replay(torch, np, batches, flat, cuts, caps, sr):
    """``cascade_step_kernel`` over canonical ``batches`` from the flat
    state ``flat`` (updated in place), each launch behind a spin of the
    card so the wrapper's host work overlaps it and the events time the
    kernel alone; the host time is taken apart, on the host clock, with
    the card's queue emptied before each call (a full launch queue would
    make the host wait).  Each call runs under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync in the
    wrapper raises.  One untimed call on a copy of the state first warms
    the allocator (the scratch).  Returns the state, the kernel and host ms
    of each call, the cascade counters after each call, and the device
    memory that first call kept (the allocator's delta: the scratch the
    wrapper keeps for a state)."""
    from repro_torch.kernels.hier_cascade import ops

    warm = [tuple(t.clone() for t in layer) for layer in flat[0]], *(t.clone() for t in flat[1:])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    ops.cascade_step_kernel(*warm, batches[0], cuts, caps, sr)
    torch.cuda.synchronize()
    scratch = torch.cuda.memory_allocated() - held
    del warm
    s0, s1 = event(torch), event(torch)
    s0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    s1.record()
    torch.cuda.synchronize()
    sleep_ms = s0.elapsed_time(s1)
    marks, host_ms, casc_after = [], [], []
    for b in batches:
        flat[3][:, 0] |= b.overflow
        torch.cuda.synchronize()
        start, end = event(torch), event(torch)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            ops.cascade_step_kernel(*flat, b, cuts, caps, sr)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        end.record()
        marks.append((start, end))
        casc_after.append(flat[2].clone())
    torch.cuda.synchronize()
    kernel_ms = [s.elapsed_time(e) for s, e in marks]
    overruns = sum(h >= sleep_ms for h in host_ms)
    log(f"[replay] {len(batches)} wrapper calls under torch.cuda.set_sync_debug_mode('error'): no "
        f"host sync; wrapper host time {np.mean(host_ms):.4f} ms/call mean (max {max(host_ms):.4f}); "
        f"spin ahead of each launch {sleep_ms:.3f} ms; {overruns} calls where the host outlasted the spin")
    return flat, kernel_ms, host_ms, casc_after, scratch


def merge_bytes(merges) -> int:
    """Least bytes of ``cascade_step_plain``'s merges: each reads its two
    live inputs and writes its live output; a fired cascade also clears its
    source."""
    return sum(
        ENTRY_BYTES * (n_dst + n_src + n_out + (n_src if cleared else 0))
        for n_dst, n_src, n_out, cleared in merges
    )


def step_kinds(torch, np, casc_after, times_ms, step_bytes=None):
    """Steps grouped by the highest cascade that fired in any instance (read
    from the cascade counters after each step): ``layer 1 only``, ``1->2``,
    ``2->3``, ...; per kind the step count, mean and median ms and, given
    each step's bytes, the mean bound."""
    casc = torch.stack(casc_after).cpu().numpy()
    fired = np.diff(casc, axis=0, prepend=np.zeros_like(casc[:1])) > 0  # [steps, K, L]
    level = np.where(fired.any(axis=1), np.arange(casc.shape[-1]), 0).max(axis=1)
    out = {}
    for lv in sorted(set(level.tolist())):
        pick = level == lv
        t = np.asarray(times_ms)[pick]
        row = {"steps": int(pick.sum()), "ms": float(t.mean()), "median_ms": float(np.median(t))}
        if step_bytes is not None:
            row["bound_ms"] = float(np.asarray(step_bytes)[pick].mean()) / HBM_BYTES_PER_S * 1e3
        out["layer 1 only" if lv == 0 else f"{lv}->{lv + 1}"] = row
    return out


def phase_bf16_ingest(torch, np, data):
    """A short bfloat16 ingest of the ``cuda`` engine (K=8, full width):
    through the kernels, then inside ``plain_versions()``, bit-identical."""
    from repro_torch import kernels
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.d4m import D4MStream

    R, C, V, steps = data["R"], data["C"], data["V"], BF16_STEPS
    cfg = CONFIG.to_session(instances_per_device=K, top_capacity=TOP_CAPACITY, dtype="bfloat16")
    states = {}
    for mode in ("kernels", "plain"):
        sess = D4MStream(cfg)
        check(sess.kind == "cuda" and sess.dtype == torch.bfloat16, (sess.kind, sess.dtype))
        sess.state
        torch.cuda.synchronize()
        zero_counts()
        ctx = kernels.plain_versions() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            for g in range(steps):
                sess.ingest(R[g], C[g], V[g])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = read_counts()
        states[mode] = sess.state
        log(f"[bf16] {mode}: {steps} groups in {wall:.3f} s, launches {counts}")
        if mode == "kernels":
            check(counts["hier_cascade"] == steps and counts["sort_dedup"] == steps, counts)
        else:
            check(sum(counts.values()) == 0, ("plain_versions() launched a kernel", counts))
    err = compare(torch, states["kernels"], states["plain"], "bfloat16 cuda engine: kernels vs plain")
    casc = states["kernels"].cascades.cpu()
    check(bool((casc[:, 1] > 0).all()), ("layer 1 -> 2 fired in every instance", casc))
    log(f"[bf16] K=8 bfloat16 ingest through hier_cascade == plain_versions() (bit-identical); "
        f"cascades per layer {casc.sum(0).tolist()}")
    return err


VALUE_TYPE_STEPS = 40  # the float16 and int32 ingests, both engines
# (engine, K, value type, semiring): int32 plus wraps (values anywhere in
# the int32 range), int32 min.plus has the saturated zero INT32_MAX
VALUE_TYPE_RUNS = (("cuda", K, "int32", "plus.times"), ("single", 1, "int32", "min.plus"),
                   ("cuda", K, "float16", "plus.times"), ("single", 1, "float16", "max.plus"))


def phase_value_types(torch, np, data):
    """Short float16 and int32 ingests of both engines at full width, the
    R-MAT keys with values of the type: through the kernels, then inside
    ``plain_versions()``, bit-identical."""
    from repro_torch import kernels
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.d4m import D4MStream

    R, C, steps = data["R"], data["C"], VALUE_TYPE_STEPS
    err, total = 0.0, {}
    for engine, k, dt, srn in VALUE_TYPE_RUNS:
        dtype = getattr(torch, dt)
        V = make_values(torch, np, np.random.default_rng(steps + len(dt) + k), tuple(R[:steps].shape),
                        False, dtype)
        kw = dict(instances_per_device=k, top_capacity=TOP_CAPACITY) if k > 1 else {}
        cfg = CONFIG.to_session(dtype=dt, semiring=srn, **kw)
        states = {}
        for mode in ("kernels", "plain"):
            sess = D4MStream(cfg)
            check(sess.kind == engine and sess.dtype == dtype, (sess.kind, sess.dtype))
            sess.state
            torch.cuda.synchronize()
            zero_counts()
            ctx = kernels.plain_versions() if mode == "plain" else contextlib.nullcontext()
            with ctx:
                for g in range(steps):
                    sess.ingest(R[g], C[g], V[g])
                torch.cuda.synchronize()
            counts = read_counts()
            states[mode] = sess.state
            if mode == "kernels":
                check(counts["sort_dedup"] >= steps and (counts["hier_cascade"] == steps if k > 1
                      else counts["merge_add"] >= steps), counts)
                for name, n in counts.items():
                    total[name] = total.get(name, 0) + n
            else:
                check(sum(counts.values()) == 0, ("plain_versions() launched a kernel", counts))
            del sess
        tag = f"{engine} {dt} {srn}"
        err = max(err, compare(torch, states["kernels"], states["plain"], f"{tag}: kernels vs plain"))
        casc = states["kernels"].cascades.cpu()
        check(int(casc[..., 1].sum()) > 0, (tag, "layer 1 -> 2 fired", casc))
        log(f"[types] {tag}, {steps} groups: kernels == plain_versions() (bit-identical); "
            f"cascades per layer {casc.reshape(-1, casc.shape[-1]).sum(0).tolist()}")
        del states
        gc.collect()
    return err, total


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
        runs[mode] = (sess, wall, counts, cuda_launches_per_call("merge_add"),
                      cuda_launches_per_call("sort_dedup"))
        log(f"[single] {mode}: {STEPS} groups in {wall:.3f} s = {n_edges / wall:,.0f} updates/s, "
            f"launches {counts}")
        if mode == "kernels":
            plan = sess.plan
            log(f"[single] caps {plan.layer_caps}, state {plan.total_bytes / 1e9:.2f} GB planned")
    sess, wall, counts, merge_cuda, sort_cuda = runs["kernels"]
    check(counts["sort_dedup"] >= STEPS and counts["merge_add"] >= STEPS
          and counts["hier_cascade"] == 0, counts)
    check(sum(runs["plain"][2].values()) == 0, ("plain_versions() launched a kernel", runs["plain"][2]))
    casc = sess.state.cascades.cpu()
    check(bool((casc[1:] > 0).all()), ("every cascade level fired", casc))
    check(not sess.overflowed(), "the single instance did not overflow")
    log(f"[single] CUDA launches a call: merge_add {merge_cuda:g}, sort_dedup {sort_cuda:g}")
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
    return sess, {"err": err, "rate": n_edges / wall, "launches": counts,
                  "cuda_launches_per_call": merge_cuda, "sort_cuda_launches_per_call": sort_cuda}


SERVE_EVERY = 50  # checkpoint every 50 microbatches of 100,000 (the kill comes after the first)
SERVE_PUBLISH = 4  # publish a view every 4 microbatches (50 views over the 200 groups)
SINGLE_SERVE_STEPS = 60  # the single engine's serve, at reduced depth
LOOPBACK = (8, (4096, 32768), 262_144, 4096, 40)  # K, cuts, top capacity, batch, batches


def hist_ms(hist) -> dict:
    """p50/p99/max of an obs histogram in ms (the percentiles are its
    power-of-two bucket bounds, clamped to the observed max)."""
    s = hist.summary()
    return {"count": s["count"], **{k[:-3] + "_ms": s[k] / 1e6 for k in ("p50_ns", "p99_ns", "max_ns") if k in s}}


def publish_spans(server) -> list:
    """The publication times (ns) of one serve, oldest first: the spans its
    trace holds, each also recorded in its ``serve.publish_ns`` histogram.
    The first is the start view, published by ``start()`` before the
    stream; the rest come at microbatch boundaries and at the drain."""
    spans = [e["t1_ns"] - e["t0_ns"] for e in server.trace.events() if e["stage"] == "publish"]
    n = server.metrics.histogram("serve.publish_ns").count
    check(len(spans) == n == server.views_published, ("publish spans", len(spans), n, server.views_published))
    return spans


def publish_ms(*span_lists) -> dict:
    """The start views' ms on their own, and the views published while
    serving (every span after each serve's first) as an obs histogram."""
    from repro_torch.obs import LatencyHistogram

    steady = LatencyHistogram("serve.publish_ns")
    for spans in span_lists:
        for ns in spans[1:]:
            steady.record(ns)
    return {"start_ms": [spans[0] / 1e6 for spans in span_lists], **hist_ms(steady)}


def serve_kill_restore(torch, np, cfg, rows, cols, vals, tag, queries=False):
    """Serve ``rows/cols/vals`` (host arrays, in groups of ``batch_size``)
    into a fresh session through ``ArraySource``, kill it with
    ``stop(drain=False)`` after its first checkpoint, restore the
    checkpoint into another fresh session and replay the tail from its
    cursor.  Returns the restored session and what was measured."""
    import shutil
    import tempfile

    from repro_torch import serve
    from repro_torch.d4m import D4MStream, ServeConfig
    from repro_torch.serve import wire

    batch = cfg.batch_size
    n = rows.shape[0]
    ckpt = tempfile.mkdtemp(prefix="d4m-serve-ckpt-")
    out = {}
    try:
        sess = D4MStream(cfg, checkpoint_dir=ckpt, checkpoint_keep=1)
        sess.state
        torch.cuda.synchronize()
        scfg = ServeConfig(max_batch=batch, max_latency_ms=1e9, checkpoint_every=SERVE_EVERY,
                           publish_every=SERVE_PUBLISH, track_degrees=False, metrics=True)
        server = serve.D4MServer(sess, serve.ArraySource(rows, cols, vals, chunk_records=batch), scfg)
        stall = []
        save = sess.checkpoint

        def timed_checkpoint(step, extra=None):  # the feed loop's host-copy stall
            t = time.perf_counter()
            save(step, extra)
            stall.append(time.perf_counter() - t)

        sess.checkpoint = timed_checkpoint
        server.start()
        executor = serve.QueryExecutor(sess, server=server) if queries else None
        asked, deadline = 0, time.monotonic() + 300
        while not server.checkpoints and time.monotonic() < deadline:
            if executor is not None and sess.latest_view() is not None:
                # the query plane at full width, while the stream runs
                for op, args in (("degrees", {}), ("top_k", {"k": 10}), ("row", {"r": 0}),
                                 ("get", {"r": 0, "c": 1})):
                    rep = executor.execute(wire.QueryRequest(op=op, args=args, id=asked))
                    check(rep.ok, (tag, op, rep.error))
                    asked += 1
            else:
                time.sleep(0.005)
        check(server.checkpoints, f"{tag}: no checkpoint within the deadline")
        server.stop(drain=False, timeout=300)
        killed = server.report()
        check(not killed.drained and killed.records_fed < n, (tag, "the kill landed mid-stream"))
        hists = server.metrics
        spans = publish_spans(server)
        out["queries"] = {op: hist_ms(hists.histogram(f"query.{op}.latency_ns"))
                          for op in ("degrees", "top_k", "row", "get") if queries}
        out["killed"] = {"records_fed": killed.records_fed, "wall_s": killed.wall_s,
                         "rate": killed.ingest_rate, "views": server.views_published,
                         "checkpoint_stall_s": stall}
        del server, sess
        gc.collect()

        fresh = D4MStream(cfg, checkpoint_dir=ckpt, checkpoint_keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cursor = fresh.restore()["cursor"]
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        check(0 < cursor < n and cursor % batch == 0, (tag, "cursor", cursor))
        server = serve.D4MServer(
            fresh, serve.ArraySource(rows[cursor:], cols[cursor:], vals[cursor:], chunk_records=batch),
            ServeConfig(max_batch=batch, max_latency_ms=1e9, publish_every=SERVE_PUBLISH,
                        track_degrees=False, metrics=True),
        )
        replay = server.run(timeout=600)
        out["publish"] = publish_ms(spans, publish_spans(server))
        del server
        check(replay.drained and replay.records_fed == n - cursor, (tag, "replay", replay.records_fed))
        check(replay.records_dropped == 0 and replay.telemetry.routing_dropped == 0, (tag, "no drop"))
        out["replay"] = {"cursor": cursor, "records_fed": replay.records_fed, "wall_s": replay.wall_s,
                         "rate": replay.ingest_rate}
        # one more generation, timed whole: host copies, then the write
        t0 = time.perf_counter()
        fresh.checkpoint(n // batch, extra={"cursor": n})
        t1 = time.perf_counter()
        fresh.wait_checkpoint()
        t2 = time.perf_counter()
        step_dir = Path(ckpt) / f"ckpt-{n // batch:09d}"
        manifest = json.loads((step_dir / "manifest.json").read_text())
        out["save_copy_s"], out["save_write_s"] = t1 - t0, t2 - t1
        out["checkpoint_gb"] = manifest["arrays_bytes"] / 1e9
        return fresh, out
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def serve_default(torch, np, cfg, rows, cols, vals, want):
    """The whole stream served uninterrupted into a fresh session with
    ``ServeConfig``'s defaults (``track_degrees=True``: the host degree
    fold on the feed thread, its vectors lifted into each published view),
    publishing every ``SERVE_PUBLISH`` microbatches.  The state equals the
    library-mode session ``want``; the drain view's tracked degrees equal
    host bincounts of the stream and a fresh reduction of its snapshot
    under the plain versions."""
    from repro_torch import kernels, serve
    from repro_torch.core import analytics
    from repro_torch.d4m import D4MStream, ServeConfig

    n, batch = rows.shape[0], cfg.batch_size
    sess = D4MStream(cfg)
    sess.state
    torch.cuda.synchronize()
    scfg = ServeConfig(max_batch=batch, max_latency_ms=1e9, publish_every=SERVE_PUBLISH, metrics=True)
    check(scfg.track_degrees, "the default ServeConfig tracks degrees")
    server = serve.D4MServer(sess, serve.ArraySource(rows, cols, vals, chunk_records=batch), scfg)
    check(server._tracker is not None, "the degree tracker is on")
    zero_counts()
    rep = server.run(timeout=600)
    torch.cuda.synchronize()
    launches = read_counts()
    check(rep.drained and rep.records_fed == n, ("default serve drain", rep.records_fed))
    check(rep.records_dropped == 0 and rep.telemetry.routing_dropped == 0, "default serve: no drop")
    check(launches["hier_cascade"] > 0 and launches["sort_dedup"] > 0 and launches["merge_add"] > 0, launches)
    compare(torch, sess.state, want.state, "served (default ServeConfig) vs library-mode K=8")
    check(sess.nnz() == want.nnz() and not sess.overflowed(), ("default serve nnz/overflow", sess.nnz()))
    publish = publish_ms(publish_spans(server))
    v = sess.latest_view()
    check(v.records == n and v.seq == server.views_published, ("drain view", v.records, v.seq))
    tracked = v.degrees()  # seeded by the tracker at publication
    with kernels.plain_versions():
        fresh = analytics.degrees(v.snap, cap=v.plan.snapshot_cap, sr=v.sr)
    for name, ids, t, f in zip(("out", "in"), (rows, cols), tracked, fresh):
        count = np.bincount(ids)
        live = np.flatnonzero(count)
        nz = int(t.nnz)
        got_ids, got_vals = t.rows[:nz].cpu().numpy(), t.vals[:nz].cpu().numpy()
        check(nz == live.size and np.array_equal(got_ids, live)
              and np.array_equal(got_vals, count[live].astype(np.float32)), (name, "tracked degrees vs bincount"))
        assoc_same(torch, t, f, f"tracked {name}-degrees vs a fresh plain reduction of the drain view")
    m = {"rate": rep.ingest_rate, "wall_s": rep.wall_s, "views": server.views_published,
         "publish": publish, "launches": launches}
    del server, sess, v, tracked, fresh
    log(f"[serve] cuda K=8, default ServeConfig (track_degrees=True), publish every {SERVE_PUBLISH}: "
        f"{rep.records_fed:,} records at {m['rate']:,.0f} records/s (wall until drain {m['wall_s']:.3f} s), "
        f"{m['views']} views, publish {publish}; launches {launches}; state == library-mode K=8 "
        f"(bit-identical); drain view's tracked degrees == host bincounts == a fresh plain reduction")
    return m


def phase_serve(torch, np, data, want):
    """``D4MStream.serve`` on the card: the full-width ``cuda`` engine (K=8,
    ``CONFIG``, 3.82 GB) served the 200 R-MAT groups through
    ``ArraySource``, killed after its first checkpoint, restored and
    replayed to a state bit-identical to the library-mode session ``want``
    (degrees not tracked, so full-width queries reduce each view on the
    card); the whole stream served again with the default ``ServeConfig``
    (degrees tracked on the host); the kill and replay at reduced depth for the ``single`` engine; and a loopback
    ``TCPSource`` run whose ``QueryClient`` answers equal the views they
    name."""
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.d4m import D4MStream

    rows, cols, vals = (data[k].reshape(-1).cpu().numpy() for k in ("R", "C", "V"))
    n, out = rows.shape[0], {}

    # -- the cuda engine at full width ----------------------------------------
    cfg = CONFIG.to_session(instances_per_device=K, top_capacity=TOP_CAPACITY,
                            snapshot_cap=data["n_distinct"])
    zero_counts()
    t0 = time.perf_counter()
    sess, m = serve_kill_restore(torch, np, cfg, rows, cols, vals, "serve", queries=True)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    check(sess.kind == "cuda", sess.kind)
    check(launches["hier_cascade"] > 0 and launches["sort_dedup"] > 0 and launches["merge_add"] > 0,
          ("the serve path launched every kernel of its path", launches))
    err = compare(torch, sess.state, want.state, "served+restored+replayed vs library-mode K=8")
    check(sess.nnz() == want.nnz() and not sess.overflowed(), ("serve nnz/overflow", sess.nnz()))
    snap = sess.snapshot()
    err = max(err, assoc_same(torch, snap, want.snapshot(), "served snapshot"))
    check(int(snap.nnz) == data["n_distinct"], (int(snap.nnz), data["n_distinct"]))
    out["cuda"] = dict(m, launches=launches, wall_s=wall)
    gb = cfg.plan().total_bytes / 1e9
    log(f"[serve] cuda K=8 ({gb:.2f} GB): killed after {m['killed']['records_fed']:,} records "
        f"({m['killed']['rate']:,.0f} records/s to the kill, {m['killed']['views']} views, checkpoint "
        f"host-copy stall {[round(x, 3) for x in m['killed']['checkpoint_stall_s']]} s); restored in "
        f"{m['restore_s']:.3f} s; replayed {m['replay']['records_fed']:,} records from cursor "
        f"{m['replay']['cursor']:,} at {m['replay']['rate']:,.0f} records/s (wall until drain "
        f"{m['replay']['wall_s']:.3f} s); launches {launches}")
    log(f"[serve] cuda checkpoint {m['checkpoint_gb']:.3f} GB (power-of-two widths): host copies "
        f"{m['save_copy_s']:.3f} s + write {m['save_write_s']:.3f} s; publish {m['publish']}; "
        f"queries {m['queries']}")
    log("[serve] cuda: final state and snapshot == library-mode K=8 session (bit-identical), "
        "no drop, no overflow")
    del sess, snap
    gc.collect()
    out["cuda_default"] = serve_default(torch, np, cfg, rows, cols, vals, want)
    gc.collect()

    # -- the single engine, reduced depth ---------------------------------------
    k1 = SINGLE_SERVE_STEPS * CONFIG.group_size
    cfg1 = CONFIG.to_session()
    ref = D4MStream(cfg1)
    for g in range(SINGLE_SERVE_STEPS):
        ref.ingest(data["R"][g], data["C"][g], data["V"][g])
    zero_counts()
    sess1, m1 = serve_kill_restore(torch, np, cfg1, rows[:k1], cols[:k1], vals[:k1], "serve-single")
    torch.cuda.synchronize()
    launches1 = read_counts()
    check(launches1["merge_add"] > 0 and launches1["sort_dedup"] > 0, launches1)
    err = max(err, compare(torch, sess1.state, ref.state, "single served vs library-mode"))
    check(not sess1.overflowed(), "single serve: no overflow")
    out["single"] = dict(m1, launches=launches1)
    log(f"[serve] single K=1, {SINGLE_SERVE_STEPS} groups: killed after {m1['killed']['records_fed']:,}, "
        f"restored in {m1['restore_s']:.3f} s, replay {m1['replay']['rate']:,.0f} records/s; "
        f"checkpoint {m1['checkpoint_gb']:.3f} GB, copies {m1['save_copy_s']:.3f} s + write "
        f"{m1['save_write_s']:.3f} s; launches {launches1}; state == library mode (bit-identical)")
    del sess1, ref
    gc.collect()

    # -- loopback queries while streaming ------------------------------------------
    zero_counts()
    q = phase_loopback(torch, np, rows, cols, vals)
    out["loopback"] = dict(q, launches=read_counts())
    out["err"] = err
    torch.cuda.synchronize()
    return out


def phase_loopback(torch, np, rows, cols, vals):
    """A small K=8 serve over a loopback ``TCPSource``: a ``QueryClient``
    inserts batches and asks degrees, top-k, row and get on the same
    connection while the stream runs; every answer equals the same op on
    the published view whose sequence number it carries: degrees and
    top-k (answered from the tracker's vectors seeded into the view) equal
    a fresh reduction of the view's snapshot under the plain versions."""
    import threading

    from repro_torch import kernels, serve
    from repro_torch.core import analytics
    from repro_torch.d4m import D4MStream, ServeConfig, StreamConfig
    from repro_torch.obs import summarize_state

    k, cuts, top, batch, steps = LOOPBACK
    sess = D4MStream(StreamConfig(cuts=cuts, top_capacity=top, batch_size=batch,
                                  instances_per_device=k))
    published, view = {}, sess.view

    def recording_view(*a, **kw):
        v = view(*a, **kw)
        if kw.get("publish", True):
            published[v.seq] = v
        return v

    sess.view = recording_view
    src = serve.TCPSource(port=0, encoding="binary").start()
    replies, errors = [], []
    ops = (("degrees", {}), ("top_k", {"k": 10}), ("row", {"r": 0}), ("get", {"r": 0, "c": 1}))

    def client():
        try:
            with serve.QueryClient("127.0.0.1", src.port, encoding="binary", timeout_s=60) as qc:
                for t in range(steps):
                    s = slice(t * batch, (t + 1) * batch)
                    qc.insert(rows[s], cols[s], vals[s])
                    for op, args in ops:
                        replies.append((op, args, qc.request(op, **args)))
        except BaseException as e:  # surfaced below
            errors.append(e)

    th = threading.Thread(target=client, daemon=True)
    th.start()
    report = sess.serve(src, ServeConfig(max_latency_ms=1e9, publish_every=2, metrics=True), timeout=120)
    th.join(timeout=60)
    check(not th.is_alive() and not errors, ("loopback client", errors))
    check(report.drained and report.records_fed == steps * batch, ("loopback drain", report.records_fed))
    fresh = {}  # each view's degrees reduced anew, under the plain versions: the
    # answers come from the tracker's vectors seeded into the view

    def degrees(v):
        if v.seq not in fresh:
            with kernels.plain_versions():
                fresh[v.seq] = analytics.degrees(v.snap, cap=v.plan.snapshot_cap, sr=v.sr)
        return fresh[v.seq]

    for op, args, rep in replies:
        check(rep.ok, (op, rep.error))
        v = published[rep.view_seq]
        if op == "degrees":
            for name, a in zip(("out", "in"), degrees(v)):
                nz = int(a.nnz)
                check(np.array_equal(rep.arrays[f"{name}_ids"], a.rows[:nz].cpu().numpy())
                      and np.array_equal(rep.arrays[f"{name}_vals"], a.vals[:nz].cpu().numpy()), (op, rep.view_seq))
        elif op == "top_k":
            with kernels.plain_versions():
                ids, counts = analytics.top_k_vertices(degrees(v)[0], args["k"])
            check(np.array_equal(rep.arrays["ids"], ids.cpu().numpy())
                  and np.array_equal(rep.arrays["vals"], counts.cpu().numpy()), (op, rep.view_seq))
        elif op == "row":
            a = v.row(args["r"])
            nz = int(a.nnz)
            check(np.array_equal(rep.arrays["cols"], a.cols[:nz].cpu().numpy())
                  and np.array_equal(rep.arrays["vals"], a.vals[:nz].cpu().numpy()), (op, rep.view_seq))
        else:
            check(rep.scalars["value"] == float(v.get(args["r"], args["c"])), (op, rep.view_seq))
    seqs = sorted({rep.view_seq for _, _, rep in replies})
    lat = report.telemetry.histograms
    query_ms = {op: {k[:-3] + "_ms": v / 1e6 for k, v in summarize_state(lat[f"query.{op}.latency_ns"]).items()
                     if k.endswith("_ns")} for op, _ in ops}
    log(f"[serve] loopback K={k}: {len(replies)} answers over {len(seqs)} views (seq {seqs[0]}..{seqs[-1]}) "
        f"== the same ops on the views they name; {report.records_fed:,} records at "
        f"{report.ingest_rate:,.0f} records/s; query ms {query_ms}")
    return {"answers": len(replies), "views": len(seqs), "query_ms": query_ms, "rate": report.ingest_rate}


FLEET_WORKERS = (1, 2, 4)  # the full-width sweep: 8, 16 and 32 instances on the card
# the untracked serve of phase_serve: full microbatches, no host degree fold
FLEET_SERVE = dict(track_degrees=False, max_batch=100_000, max_latency_ms=1e9)
# the kill leg at reduced depth: K=8, cuts and top capacity that keep a
# checkpoint at 0.34 GB (the full width writes 5.06 GB) while every
# cascade level fires in each of 2 workers; a checkpoint every 25 batches
FLEET_KILL = ((20_000, 100_000, 400_000), 1_300_000, 25)


def fleet_checks(report, n, n_workers, killed=False):
    """The fleet's ledger: conserved, every record delivered once, no
    restart (at least one after a kill), 8 instances a worker, every worker
    fed, every D4M kernel launched inside every worker (counted by the
    worker over its life, sent with its report)."""
    tel = report.telemetry
    check(report.conserved, "fleet ledger conserved")
    check(report.records_in == report.records_delivered == n,
          ("fleet records", report.records_in, report.records_delivered, n))
    check(report.restarts >= 1 if killed else report.restarts == 0, ("fleet restarts", report.restarts))
    check(tel.n_instances == K * n_workers, ("fleet instances", tel.n_instances))
    check(tel.records_dropped == 0 and tel.routing_dropped == 0, "fleet: no drop")
    check(all(w["records_fed"] > 0 for w in report.per_worker), report.per_worker)
    for w in report.per_worker:
        got = w["launches"] or {}
        check(all(got.get(k, 0) > 0 for k in ("hier_cascade", "sort_dedup", "merge_add")),
              ("kernels launched inside worker", w["worker"], got))


def fleet_launches(report) -> dict:
    """Launches inside the workers of one fleet run, summed."""
    out = {name: 0 for name in counters()}
    for w in report.per_worker:
        for name, n in (w["launches"] or {}).items():
            out[name] += n
    return out


def fleet_merge(torch, report, want, what):
    """``merged_snapshot`` on the card, timed on the host clock (the npz
    triples' upload included), counted, and held bit for bit to the
    library-mode K=8 snapshot ``want``."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = report.merged_snapshot(device=DEVICE)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    check(launches == {"hier_cascade": 0, "merge_add": 0, "scatter_add": 0, "sort_dedup": 1},
          (what, "merged snapshot launches", launches))
    assoc_same(torch, snap, want, f"{what}: merged snapshot vs library-mode K=8")
    return snap, ms, launches


def fleet_run(cfg, n_workers, rows, cols, vals, serve_cfg, metrics, tag):
    """One fleet of ``n_workers`` worker processes on the card, fed the whole
    stream through ``ArraySource`` by ``FleetController.run``; returns the
    report, the spawn seconds and, with ``metrics``, the fleet's merged
    histograms (the controller's ``fleet.push_ns``, the workers' decode,
    route, enqueue-wait and dispatch spans) as ms summaries."""
    import shutil
    import tempfile

    from repro_torch import serve
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.fleet import FleetController
    from repro_torch.obs import summarize_state

    workdir = tempfile.mkdtemp(prefix=f"d4m-fleet-{tag}-")
    ctl = FleetController(cfg, n_workers=n_workers, workdir=workdir, serve_config=serve_cfg,
                          metrics=metrics, report_interval_s=0.5, device=DEVICE)
    try:
        t0 = time.perf_counter()
        ctl.start()
        spawn_s = time.perf_counter() - t0
        report = ctl.run(serve.ArraySource(rows, cols, vals, chunk_records=CONFIG.group_size),
                         finish_timeout_s=900)
        hists = None
        if metrics:  # the controller's push and the workers' serve stages, merged
            hists = {name: {k[:-3] + "_ms" if k.endswith("_ns") else k: v / 1e6 if k.endswith("_ns") else v
                            for k, v in summarize_state(st).items()}
                     for name, st in ctl.metrics()["histograms"].items()}
        return report, spawn_s, hists
    finally:
        ctl.close()
        shutil.rmtree(workdir, ignore_errors=True)


def fleet_host_costs(np, rows, cols, vals, chunks=20):
    """The controller's own work on a chunk, without sockets: median ms of
    ``split_by_host`` over a 100,000-record chunk and of encoding its parts
    in the wire format, at each N of the sweep (host clock)."""
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.fleet.routing import split_by_host
    from repro_torch.serve import wire

    g = CONFIG.group_size
    out = {}
    for n_workers in FLEET_WORKERS:
        split, enc = [], []
        for i in range(chunks):
            s = slice(i * g, (i + 1) * g)
            t0 = time.perf_counter()
            parts = split_by_host(rows[s], cols[s], vals[s], n_workers)
            t1 = time.perf_counter()
            for r, c, v in parts:
                wire.encode(r, c, v, "binary")
            t2 = time.perf_counter()
            split.append((t1 - t0) * 1e3)
            enc.append((t2 - t1) * 1e3)
        out[n_workers] = {"split_ms": float(np.median(split)), "encode_ms": float(np.median(enc))}
    return out


def fleet_kill_leg(torch, np, rows, cols, vals, n_distinct, want):
    """N=2 at reduced depth (``FLEET_KILL``), checkpointing: SIGKILL worker
    1 after its first durable checkpoint, revive it from that checkpoint
    and replay the journal tail; the merged snapshot is still the
    library-mode K=8 snapshot, bit for bit.  Then the acked checkpoint's
    restore and a save of it, timed in this process."""
    import shutil
    import tempfile

    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.d4m import D4MStream, ServeConfig
    from repro_torch.fleet import FleetController

    cuts, top, every = FLEET_KILL
    cfg = CONFIG.to_session(instances_per_device=K, cuts=cuts, top_capacity=top,
                            snapshot_cap=n_distinct)
    n, chunk, victim = rows.shape[0], CONFIG.group_size, 1
    workdir = tempfile.mkdtemp(prefix="d4m-fleet-kill-")
    ctl = FleetController(cfg, n_workers=2, workdir=workdir,
                          serve_config=ServeConfig(checkpoint_every=every, **FLEET_SERVE),
                          report_interval_s=0.2, device=DEVICE)
    out = {"cuts": list(cuts), "top_capacity": top, "checkpoint_every": every}
    try:
        ctl.start()
        n_chunks = n // chunk
        for i in range(n_chunks):
            s = slice(i * chunk, (i + 1) * chunk)
            ctl.push(rows[s], cols[s], vals[s])
            if i == n_chunks // 2:
                deadline = time.monotonic() + 300
                while ctl.workers[victim].last_ckpt is None and time.monotonic() < deadline:
                    time.sleep(0.05)
                acked = ctl.workers[victim].last_ckpt
                check(acked is not None, "kill leg: the victim published a durable checkpoint")
                ctl.kill_worker(victim)
                t0 = time.perf_counter()
                ctl.poll_workers()  # detect, respawn, restore, replay the journal tail
                out["revive_s"] = time.perf_counter() - t0
                out["acked_cursor"] = acked["cursor"]
                out["replayed"] = ctl.workers[victim].journal.total - ctl.workers[victim].cursor_base
                check(ctl.workers[victim].cursor_base == acked["cursor"],
                      ("kill leg: restored cursor", ctl.workers[victim].cursor_base, acked))
        report = ctl.finish(timeout_s=900)
        fleet_checks(report, n, 2, killed=True)
        gens = sorted(os.listdir(os.path.join(workdir, f"w{victim}")))
        check(len(gens) >= 2, ("kill leg: generation dirs", gens))
        for h in ctl.workers:
            casc = np.asarray(h.report.session.cascades_per_instance)
            check((casc[:, 1:] > 0).all(), ("kill leg: every cascade level fired", h.worker_id, casc.tolist()))
        snap, merge_ms, merge_launches = fleet_merge(torch, report, want, "fleet kill leg")
        del snap
        out.update(report=report, merge_ms=merge_ms, merge_launches=merge_launches,
                   generations=gens, launches=fleet_launches(report))

        # the revived incarnation's last acked checkpoint: its size, its
        # restore into a fresh session and a save of it, on this process
        ck = ctl.workers[victim].last_ckpt
        step_dir = os.path.join(ck["dir"], f"ckpt-{ck['step']:09d}")
        with open(os.path.join(step_dir, "manifest.json")) as f:
            out["checkpoint_gb"] = json.load(f)["arrays_bytes"] / 1e9
        fresh = D4MStream(cfg, device=DEVICE, checkpoint_dir=ck["dir"])
        fresh.state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local = int(fresh.restore(step=ck["step"])["cursor"])  # the incarnation's own cursor
        check(ctl.workers[victim].cursor_base + local == ck["cursor"], "kill leg: restore cursor")
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        check(fresh.nnz() == ctl.workers[victim].report.session.nnz_total, "kill leg: restored nnz")
        t0 = time.perf_counter()
        fresh.checkpoint(ck["step"] + 1, extra={"cursor": ck["cursor"]})
        t1 = time.perf_counter()
        fresh.wait_checkpoint()
        out["save_copy_s"], out["save_write_s"] = t1 - t0, time.perf_counter() - t1
        del fresh
        gc.collect()
        return out
    finally:
        ctl.close()
        shutil.rmtree(workdir, ignore_errors=True)


def phase_fleet(torch, np, data, want):
    """``repro_torch.fleet`` on the card: N worker processes, each a
    full-width ``cuda`` session (K=8, ``CONFIG``, 3.82 GB) serving its
    shard of the 200 R-MAT groups behind the controller's host-tier hash
    router, at N = 1, 2 and 4 (8 to 32 instances); N=4 again with the
    default ``ServeConfig``; and the kill leg at reduced depth.  Every
    merged snapshot (one ``sort_dedup`` call in this process over the
    workers' snapshots) is the library-mode K=8 snapshot ``want``, bit for
    bit; at N=4 also inside ``kernels.plain_versions()``.  The workers'
    launch counts come back with their reports."""
    from repro_torch import kernels
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.core import assoc
    from repro_torch.d4m import ServeConfig

    rows, cols, vals = (data[k].reshape(-1).cpu().numpy() for k in ("R", "C", "V"))
    n, n_distinct = rows.shape[0], data["n_distinct"]
    cfg = CONFIG.to_session(instances_per_device=K, top_capacity=TOP_CAPACITY, snapshot_cap=n_distinct)
    cores = len(os.sched_getaffinity(0))
    out = {"cores": cores, "sweep": {}, "launches": {name: 0 for name in counters()}}
    log(f"[fleet] host cores usable {cores}; state a worker {cfg.plan().total_bytes / 1e9:.2f} GB")

    def add(launches):
        for name, c in launches.items():
            out["launches"][name] += c

    out["host_costs"] = fleet_host_costs(np, rows, cols, vals)
    log(f"[fleet] the controller's work a 100,000-record chunk, sockets apart (median ms, host): "
        f"{out['host_costs']}")

    for n_workers in FLEET_WORKERS:
        t0 = time.perf_counter()
        report, spawn_s, hists = fleet_run(cfg, n_workers, rows, cols, vals,
                                           ServeConfig(**FLEET_SERVE), True, f"n{n_workers}")
        push = hists["fleet.push_ns"]
        fleet_checks(report, n, n_workers)
        snap, merge_ms, merge_launches = fleet_merge(torch, report, want, f"fleet N={n_workers}")
        worker_launches = fleet_launches(report)
        add(worker_launches)
        add(merge_launches)
        row = {
            "aggregate_rate": report.aggregate_rate, "wall_s": report.wall_s, "spawn_s": spawn_s,
            "worker_rates": [w["ingest_rate"] for w in report.per_worker],
            "worker_records": [w["records_fed"] for w in report.per_worker],
            "merged_snapshot_ms": merge_ms, "push": push, "histograms": hists,
            "launches": worker_launches,
            "phase_s": time.perf_counter() - t0,
        }
        if n_workers == max(FLEET_WORKERS):
            zero_counts()
            with kernels.plain_versions():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                plain = report.merged_snapshot(device=DEVICE)
                torch.cuda.synchronize()
                row["merged_snapshot_plain_ms"] = (time.perf_counter() - t1) * 1e3
            check(read_counts() == {name: 0 for name in counters()}, "plain versions launch nothing")
            assoc_same(torch, snap, plain, "fleet N=4: merged snapshot, kernel vs plain_versions()")
            del plain
            # the merge's sort_dedup call alone, on the card-resident triples
            r, c, v = (torch.from_numpy(np.concatenate(x)).to(DEVICE)
                       for x in zip(*report.snapshot_triples))
            m = r.shape[0]
            nbytes = ENTRY_BYTES * (m + int(snap.nnz))
            keys = assoc.pack_keys(r, c)
            row["merge_kernel"] = {
                "entries": m, "runs": n_workers,
                "ms": time_kernel(torch, np, lambda: assoc.from_triples(r, c, v, cap=m), reps=5),
                "plain_ms": time_host(torch, np, lambda: assoc.from_triples_plain(r, c, v, cap=m), reps=3),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
                "torch_sort_ms": time_kernel(torch, np, lambda: torch.sort(keys, stable=True), reps=5),
            }
            del r, c, v, keys
        del snap, report
        gc.collect()
        out["sweep"][n_workers] = row
        log(f"[fleet] N={n_workers} ({K * n_workers} instances): {n:,} records at "
            f"{row['aggregate_rate']:,.0f} records/s aggregate (wall {row['wall_s']:.3f} s after "
            f"{spawn_s:.2f} s of spawn); workers {[round(x) for x in row['worker_rates']]} records/s "
            f"over {row['worker_records']}; merged_snapshot {merge_ms:.2f} ms; push {push}; "
            f"launches in the workers {worker_launches}; merged == library-mode K=8 (bit-identical)")
        log(f"[fleet] N={n_workers} spans (count, p50/p99 ms, merged over the workers): " + "; ".join(
            f"{name} {h['count']}, {h.get('p50_ms', 0):.3f}/{h.get('p99_ms', 0):.3f}"
            for name, h in sorted(hists.items())))
    mk = out["sweep"][max(FLEET_WORKERS)]["merge_kernel"]
    log(f"[fleet] merged snapshot's sort_dedup alone ({mk['entries']:,} entries in {mk['runs']} "
        f"sorted runs): {mk['ms']:.4f} ms, bound {mk['bound_ms']:.5f} ms, plain {mk['plain_ms']:.3f} ms "
        f"(the whole call under plain_versions() "
        f"{out['sweep'][max(FLEET_WORKERS)]['merged_snapshot_plain_ms']:.2f} ms); torch.sort of the "
        f"keys {mk['torch_sort_ms']:.4f} ms (reference only); kernel == plain_versions() (bit-identical)")

    # -- the default ServeConfig, N=4 ---------------------------------------------
    n_workers = max(FLEET_WORKERS)
    report, spawn_s, _ = fleet_run(cfg, n_workers, rows, cols, vals, None, None, "default")
    check(report.telemetry is not None and cfg.serve is None, "the fleet's default ServeConfig")
    fleet_checks(report, n, n_workers)
    snap, merge_ms, merge_launches = fleet_merge(torch, report, want, "fleet default ServeConfig")
    add(fleet_launches(report))
    add(merge_launches)
    out["default"] = {"aggregate_rate": report.aggregate_rate, "wall_s": report.wall_s, "spawn_s": spawn_s,
                      "worker_rates": [w["ingest_rate"] for w in report.per_worker],
                      "merged_snapshot_ms": merge_ms, "launches": fleet_launches(report)}
    del snap, report
    gc.collect()
    d = out["default"]
    log(f"[fleet] N={n_workers}, default ServeConfig: {d['aggregate_rate']:,.0f} records/s aggregate "
        f"(wall {d['wall_s']:.3f} s); workers {[round(x) for x in d['worker_rates']]} records/s; "
        f"merged_snapshot {merge_ms:.2f} ms; launches in the workers {d['launches']}; "
        f"merged == library-mode K=8 (bit-identical)")

    # -- the kill leg, N=2 at reduced depth ----------------------------------------
    kill = fleet_kill_leg(torch, np, rows, cols, vals, n_distinct, want)
    report = kill.pop("report")
    add(kill["launches"])
    add(kill["merge_launches"])
    kill.update(aggregate_rate=report.aggregate_rate, wall_s=report.wall_s, restarts=report.restarts)
    out["kill"] = kill
    del report
    gc.collect()
    log(f"[fleet] kill leg N=2, cuts {kill['cuts']}, top {kill['top_capacity']:,}: worker 1 killed after "
        f"its checkpoint at cursor {kill['acked_cursor']:,}, revived (spawn, restore, replay of "
        f"{kill['replayed']:,} records) in {kill['revive_s']:.3f} s; {kill['restarts']} restart(s), "
        f"generations {kill['generations']}; {kill['aggregate_rate']:,.0f} records/s aggregate "
        f"(wall {kill['wall_s']:.3f} s); checkpoint {kill['checkpoint_gb']:.3f} GB: restore "
        f"{kill['restore_s']:.3f} s, save {kill['save_copy_s']:.3f} s copies + {kill['save_write_s']:.3f} s "
        f"write; merged == library-mode K=8 (bit-identical)")
    return out


BENCH_SPEC = ROOT / "src" / "repro_torch" / "benchmarks" / "experiments" / "chip.json"
BENCH_TIMEOUT_S = 600
#: the kernels each bench section's path runs (all must launch)
BENCH_KERNELS = {
    "hier_update": ("sort_dedup", "merge_add"),
    "kernels": ("merge_add", "sort_dedup", "scatter_add"),
    "cascade_kernel": ("hier_cascade", "sort_dedup", "merge_add"),
    "scaling": ("hier_cascade", "sort_dedup", "merge_add"),
    "embed_grad": ("scatter_add",),
    "serve": ("hier_cascade", "sort_dedup", "merge_add"),
    "query": ("hier_cascade", "sort_dedup", "merge_add"),
    "obs": ("hier_cascade", "sort_dedup", "merge_add"),
    "fleet": ("hier_cascade", "sort_dedup", "merge_add"),
}
#: the correctness fields of each section: every one must appear and be true
BENCH_CORRECT = {
    "hier_update": ("nnz_exact", "values_exact"),
    "kernels": ("bit_identical",),
    "cascade_kernel": ("engines_agree",),
    "scaling": ("nnz_exact",),
    "embed_grad": ("nnz_exact", "allclose"),
    "serve": ("conserved", "nnz_exact", "values_exact"),
    "query": ("bit_identical", "conserved"),
    "obs": ("bit_identical", "scrape_exact", "conserved"),
    "fleet": ("conserved", "nnz_exact", "values_exact"),
}
#: the params that name a rate in the [bench-metrics] line
BENCH_LABEL_KEYS = ("k", "k_per_device", "engine", "schedule", "hosts", "n", "V")


def _bench_label(m) -> str:
    keys = ",".join(f"{k}={m.params[k]}" for k in BENCH_LABEL_KEYS if k in m.params)
    return f"{m.name}[{keys}]" if keys else m.name


def phase_bench(torch, np):
    """The port's benchmark suite on the card: ``python -m
    repro_torch.benchmarks.run --experiment .../chip.json`` in a subprocess
    (all nine sections at the full-width sizes the spec names, ``hier`` at
    the paper's 100 M edges), its ``BENCH_<section>.json`` read back through the port's
    parsers, the port's gate run against an empty history (a clean pass),
    every section's correctness fields true, its kernels launched, its
    verdicts and rates returned for the ``[bench-metrics]`` line."""
    import shutil
    import tempfile

    from repro_torch.bench import gate_run, normalize_dir

    out_dir = tempfile.mkdtemp(prefix="d4m-bench-")
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.benchmarks.run", "--experiment", str(BENCH_SPEC),
             "--json-dir", out_dir],
            cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
        )
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"[bench] {line}")
        check(proc.returncode == 0, f"the bench suite exited {proc.returncode}: {proc.stderr[-4000:]}")
        record, problems = normalize_dir(out_dir, strict=True)
        check(not problems, problems)
        sections = record.sections()
        check(set(sections) == set(BENCH_KERNELS), ("bench sections", sections))
        gate = gate_run(record, [])
        check(gate.baseline_established and gate.passed and not gate.failed,
              "the port's gate on an empty history is a clean pass")
        out = {"wall_s": wall, "sections": {}, "launches": {}}
        for section in sections:
            ms = [m for m in record.measurements if m.section == section]
            launches = {name: 0 for name in counters()}
            for m in ms:
                for name, n in (m.extras.get("launches") or {}).items():
                    launches[name] += n
            for name in BENCH_KERNELS[section]:
                check(launches[name] > 0, f"bench {section}: {name} launched ({launches})")
            for field in BENCH_CORRECT[section]:
                seen = [m.extras[field] for m in ms if field in m.extras]
                check(seen and all(v is True for v in seen), f"bench {section}: {field} {seen}")
            check(not any(m.extras.get("overflow") for m in ms), f"bench {section}: no overflow")
            rates = {_bench_label(m): m.updates_per_sec for m in ms if m.updates_per_sec is not None}
            check(all(np.isfinite(r) and r > 0 for r in rates.values()), f"bench {section}: rates {rates}")
            verdicts = {
                _bench_label(m): {"passed": m.passed, **{k: v for k, v in m.extras.items()
                                                         if k not in ("launches",)}}
                for m in ms if m.passed is not None
            }
            out["sections"][section] = {"rates": rates, "verdicts": verdicts}
            out["launches"][section] = launches
        log(f"[bench] {len(record.measurements)} measurements in {len(sections)} sections, "
            f"{wall:.1f} s; the port's gate on an empty history: baseline established (pass)")
        return out
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


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


def wrapper_costs(torch, np, mod, fn, reps=5):
    """CUDA launches a call of the kernel wrapper ``mod`` makes (as its
    CUDA entry counts them; None where it does not count them), and the
    wrapper's host ms a call, each call behind a spin of the card so the
    host never waits on it."""
    zero_counts()
    fn()
    launches = (mod.cuda_launch_count / max(mod.launch_count, 1)
                if hasattr(mod, "cuda_launch_count") else None)
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return launches, float(np.mean(host))


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
        launches, host = wrapper_costs(torch, np, sops, lambda: sops.from_triples(r, c, v, r.shape[-1], sr))
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bytes": nbytes, "torch_sort_ms": ref, "cuda_launches_per_call": launches,
                      "host_ms": host}
        log(f"[times] sort_dedup {name}: {ms:.4f} ms, bound {rows[name]['bound_ms']:.5f} ms "
            f"({nbytes / 1e6:.2f} MB), plain {plain:.3f} ms; torch.sort of the same keys "
            f"{ref:.4f} ms (reference only); {launches:g} CUDA launches a call, wrapper host "
            f"time {host:.4f} ms a call")
    # the fold stage at the degrees' shape (the snapshot's rows with column
    # 0: runs as long as a vertex's out-degree), and the longest such run
    # alone
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
        launches, host = wrapper_costs(torch, np, sops, lambda: sops.combine_sorted(r, c, v, cap, sr))
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bytes": nbytes, "cuda_launches_per_call": launches, "host_ms": host}
        log(f"[times] sort_dedup fold stage, {name}: {ms:.4f} ms, bound "
            f"{rows[name]['bound_ms']:.5f} ms, plain {plain:.3f} ms; {launches:g} CUDA launches "
            f"a call, wrapper host time {host:.4f} ms a call")
    for name, (a, b, cap) in merge_add_cases(torch, data, single).items():
        out = mops.merge_add(a, b, cap, sr)
        n_out = int(out.nnz)
        nbytes = ENTRY_BYTES * (int(a.nnz) + int(b.nnz) + n_out)
        tail = ENTRY_BYTES * (cap - n_out)  # fill_tail's PAD rows, apart
        ms = time_kernel(torch, np, lambda: mops.merge_add(a, b, cap, sr), reps=5)
        plain = time_host(torch, np, lambda: assoc.add_plain(a, b, cap, sr), reps=3)
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bytes": nbytes, "tail_bytes": tail,
                      "tail_bound_ms": tail / HBM_BYTES_PER_S * 1e3}
        log(f"[times] merge_add {name} ({int(a.nnz):,} + {int(b.nnz):,} -> {n_out:,}, cap {cap:,}): "
            f"{ms:.4f} ms, bound {rows[name]['bound_ms']:.5f} ms live + "
            f"{rows[name]['tail_bound_ms']:.5f} ms dead tail ({tail / 1e9:.3f} GB), plain {plain:.3f} ms")
    return rows


def merge_add_cases(torch, data, single):
    """``{name: (a, b, cap)}``: ``merge_add``'s inputs on the main paths.
    The ``single`` engine's layer-1 merge (layer 1 holding one batch, a
    second batch into it), the snapshot's merges of the full-width
    ``single`` state (the top layer + layer 3, then + 2, + 1), and the last
    cascade merge of each level (:func:`cascade_merges`)."""
    from repro_torch.core import assoc

    sr = single.sr
    layers = single.state.layers
    b0, b1 = (assoc.from_triples(data["R"][g], data["C"][g], data["V"][g], data["R"].shape[1], sr)
              for g in (0, 1))
    cap1 = layers[0].capacity
    cases = {"layer-1 merge": (assoc.add(assoc.empty(cap1, sr, device=DEVICE), b0, cap1, sr), b1, cap1)}
    snap = layers[-1]
    for i in range(len(layers) - 2, -1, -1):  # hierarchical.snapshot's order
        cases[f"snapshot merge +layer {i + 1}"] = (snap, layers[i], data["n_distinct"])
        snap = assoc.add(snap, layers[i], cap=data["n_distinct"], sr=sr)
    cases.update(cascade_merges(torch, data))
    return cases


def cascade_merges(torch, data):
    """``{name: (dst, src, cap)}``: the inputs of the last merge of each
    cascade level of the ``single`` engine's full-width run (1->2, 2->3,
    3->4), caught by a stand-in ``assoc.add`` on a fresh run of the same
    stream (the engine keeps no reference to them)."""
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.core import assoc
    from repro_torch.d4m import D4MStream

    sess = D4MStream(CONFIG.to_session(snapshot_cap=data["n_distinct"]))
    caps = sess.plan.layer_caps
    last = {}
    add = assoc.add

    def catch(a, b, cap=None, sr=None):
        if b.capacity in caps[:-1] and a.capacity == caps[caps.index(b.capacity) + 1]:
            i = caps.index(b.capacity) + 1
            last[f"cascade merge {i}->{i + 1}"] = (a, b, cap)
        return add(a, b, cap, sr)

    assoc.add = catch
    try:
        for g in range(STEPS):
            sess.ingest(data["R"][g], data["C"][g], data["V"][g])
    finally:
        assoc.add = add
    torch.cuda.synchronize()
    check(len(last) == len(caps) - 1, ("every cascade level fired", sorted(last)))
    return dict(sorted(last.items()))


# granite-3-8b's table rows and width, the flushed accumulator's slots
# (its top layer's capacity) and about its live ids
SCATTER_PATH = (49_664, 4096, 127_488, 25_000)
# (name, V, d, live ids, PAD slots, row 0 live, negative/out-of-range ids)
SCATTER_CASES = [
    ("k0", 16, 4096, 0, 0, False, False),
    ("d1", 64, 1, 20, 8, True, False),
    ("d3", 64, 3, 20, 8, False, False),
    ("d4096", 1000, 4096, 300, 100, True, False),
    ("no-pad", 64, 24, 30, 0, False, False),
    ("pad-row0-dead", 64, 24, 30, 10, False, False),
    ("pad-row0-live", 64, 24, 30, 10, True, False),
    ("all-pad", 64, 24, 0, 12, False, False),
    ("wrap-drop", 64, 40, 30, 10, True, True),
    ("wrap-drop-d4096", 512, 4096, 200, 50, False, True),
]


def scatter_inputs(torch, np, rng, v, d, live, pads, row0, wrap, rows_dtype, table_dtype):
    """Sorted unique ids (``live`` of them, row 0 among them or not; with
    ``wrap``, negative ids, some landing on rows a non-negative id adds to,
    and ids >= V) and a PAD tail; NaN and -0.0 in the table and the live
    rows, NaN in every PAD row, -0.0 and NaN in row 0."""
    from repro_torch.core.assoc import PAD

    pool = np.arange(1, v)
    ids = rng.choice(pool, size=min(live, v - 1), replace=False)
    if row0 and live:
        ids[0] = 0
    if wrap and live:
        k = max(1, live // 5)
        ids[:k] = -rng.choice(np.arange(1, v + 1), size=k, replace=False)  # -V .. -1
        ids[k:2 * k] = v + rng.integers(0, 3 * v, size=k)  # dropped
    ids = np.unique(ids)
    ids = np.concatenate([ids, np.full(pads, PAD)]).astype(np.int32)
    k = ids.size
    vals = lambda shape: special_values(torch, np, rng, shape)
    rows = vals((k, d))
    rows[ids.size - pads:] = float("nan")
    table = vals((v, d))
    table[0, : (d + 1) // 2] = -0.0
    table[0, (d + 1) // 2:] = float("nan") if d > 1 else -0.0
    return torch.tensor(ids, device=DEVICE), rows.to(rows_dtype), table.to(table_dtype)


def phase_parity_scatter(torch, np):
    """``scatter_add`` against its plain version on the card, bit for bit:
    float32, bfloat16 and float16 tables, each with rows of each type; PAD
    tails with NaN in the PAD rows; -0.0 and NaN in the table and in live
    rows, row 0 live or dead, with PADs present or not (C10); negative ids
    (some onto rows a non-negative id adds to) and ids >= V; k = 0; d of 1,
    3 and 4096; a misaligned table (the scalar path); and the embedding
    path's own shape, 127,488 slots of which ~25,000 live into
    [49,664, 4096]."""
    from repro_torch.core.assoc import PAD
    from repro_torch.kernels.scatter_add import ops as sa

    rng = np.random.default_rng(1313)
    cases = 0
    dts = (torch.float32, torch.bfloat16, torch.float16)
    for table_dtype in dts:
        for rows_dtype in dts:
            tag = f"table {str(table_dtype)[6:]}, rows {str(rows_dtype)[6:]}"
            for name, v, d, live, pads, row0, wrap in SCATTER_CASES:
                ids, rows, table = scatter_inputs(torch, np, rng, v, d, live, pads, row0, wrap, rows_dtype, table_dtype)
                want = sa.scatter_add_plain(ids, rows, table.clone())
                got = sa.scatter_add(ids, rows, table)
                bits_same(torch, got, want, f"scatter_add {name} {tag}")
                cases += 1
            # a table one element off 16-byte alignment: the scalar path at d % 8 == 0
            ids, rows, table = scatter_inputs(torch, np, rng, 64, 24, 30, 10, True, False, rows_dtype, table_dtype)
            store = torch.empty(table.numel() + 1, dtype=table_dtype, device=DEVICE)
            shifted = store[1:].view(table.shape)
            shifted.copy_(table)
            want = sa.scatter_add_plain(ids, rows, table.clone())
            bits_same(torch, sa.scatter_add(ids, rows, shifted), want, f"scatter_add misaligned {tag}")
            cases += 1
            torch.cuda.synchronize()
            log(f"[parity-scatter] {tag}: bit-identical")
    # the embedding path's shape (what hier_flush hands to_dense)
    v, d, k, live = SCATTER_PATH
    ids = np.sort(rng.choice(v - 1, size=live, replace=False))
    ids = torch.tensor(np.concatenate([ids, np.full(k - live, PAD)]).astype(np.int32), device=DEVICE)
    rows = torch.randn((k, d), generator=torch.Generator(device=DEVICE).manual_seed(7), device=DEVICE)
    rows[live:] = float("nan")
    table = torch.zeros((v, d), device=DEVICE)
    want = sa.scatter_add_plain(ids, rows, table.clone())
    bits_same(torch, sa.scatter_add(ids, rows, table), want, "scatter_add path shape")
    cases += 1
    torch.cuda.synchronize()
    log(f"[parity-scatter] {cases} cases bit-identical to the plain version, the path's shape "
        f"[{k:,} slots, {live:,} live] into [{v:,}, {d}] among them")
    return 0.0


EMBED_ARCH = "granite_3_8b"
EMBED_MICRO = 256  # microbatches a window: train_4k's batch of 256 on one device
EMBED_SEQ = 4096  # one 4096-token sequence a microbatch
EMBED_SEED = 0


def accum_leaves(h):
    out = []
    for l in h.layers:
        out += [l.ids, l.rows, l.nnz, l.overflow]
    return out + [h.cascades]


def phase_embed_grad(torch, np):
    """The hierarchical embedding-gradient path at granite-3-8b's full
    width: one optimizer window of 256 microbatches of 4096 tokens into the
    row accumulator, the flush, the dense gradient through ``scatter_add``
    and lazy AdamW on the bfloat16 table; through the kernel and again
    inside ``plain_versions()``, bit-identical; against the dense baseline
    ``index_add_``, summed in float64 (checked) and in float32 (reported)."""
    from repro_torch import configs, kernels
    from repro_torch.core.hierarchical import telescoped_caps
    from repro_torch.data.tokens import TokenStream
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sparse import hier_grad as HG
    from repro_torch.sparse import row_accum as RA

    cfg = configs.get_config(EMBED_ARCH)
    vocab, rows_n, d = cfg.vocab, cfg.vocab_padded, cfg.d_model
    hcfg = HG.HierGradConfig(top_capacity=min(rows_n, 1 << 16))  # train_lm.py's rule
    opt = AdamWConfig()
    t0 = time.perf_counter()
    stream = TokenStream(vocab=vocab, batch=1, seq=EMBED_SEQ, zipf=1.3, seed=EMBED_SEED)
    tokens = np.stack([stream.batch_at(s)["tokens"] for s in range(EMBED_MICRO)])
    n_distinct = int(np.unique(tokens).size)
    hottest = int(np.bincount(tokens.reshape(-1)).max())
    ids = torch.tensor(tokens, device=DEVICE)  # [M, 1, S]
    n_tok = EMBED_MICRO * EMBED_SEQ
    caps = telescoped_caps(hcfg.cuts, hcfg.top_capacity, EMBED_SEQ)
    log(f"[embed] {cfg.name}: V={vocab:,}, table rows {rows_n:,}, d={d}, table {cfg.dtype}; window "
        f"{EMBED_MICRO} microbatches x {EMBED_SEQ} tokens = {n_tok:,} tokens, {n_distinct:,} distinct ids, "
        f"the hottest {hottest:,} times "
        f"(made and counted on the host in {time.perf_counter() - t0:.2f} s); cuts {hcfg.cuts}, "
        f"top capacity {hcfg.top_capacity:,}, layer caps {caps} "
        f"({[round(c * d * 4 / 1e9, 2) for c in caps]} GB of float32 rows); no reductions")
    gen = torch.Generator(device=DEVICE)
    table0 = (torch.randn((rows_n, d), generator=gen.manual_seed(EMBED_SEED + 2), device=DEVICE) * 0.02).to(torch.bfloat16)

    # the plain run first, so that the kernel run, whose times are
    # reported, finds the allocator warm
    runs = {}
    for mode in ("plain", "kernels"):
        gen.manual_seed(EMBED_SEED + 1)
        acc = HG.init_accumulator(hcfg, EMBED_SEQ, d, device=DEVICE)
        baseline = torch.zeros((rows_n, d), device=DEVICE) if mode == "kernels" else None
        exact = torch.zeros((rows_n, d), dtype=torch.float64, device=DEVICE) if mode == "kernels" else None
        table, m, v = table0.clone(), torch.zeros((rows_n, d), device=DEVICE), torch.zeros((rows_n, d), device=DEVICE)
        torch.cuda.synchronize()
        zero_counts()
        ctx = kernels.plain_versions() if mode == "plain" else contextlib.nullcontext()
        acc_marks, base_marks = [], []
        with ctx:
            t_win = time.perf_counter()
            for mb in range(EMBED_MICRO):
                rows = torch.randn((1, EMBED_SEQ, d), generator=gen, device=DEVICE) * 0.01
                e0, e1 = event(torch), event(torch)
                e0.record()
                acc = HG.accumulate_microbatch(acc, ids[mb], rows, hcfg)
                e1.record()
                acc_marks.append((e0, e1))
                if baseline is not None:  # bench_embed_grad.py's dense baseline
                    b0, b1 = event(torch), event(torch)
                    b0.record()
                    baseline.index_add_(0, ids[mb].reshape(-1), rows.reshape(-1, d))
                    b1.record()
                    base_marks.append((b0, b1))
                    # the same sums in float64 (untimed): the reference the
                    # gradient is checked against
                    exact.index_add_(0, ids[mb].reshape(-1), rows.reshape(-1, d).double())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_win
            e = [event(torch) for _ in range(4)]
            e[0].record()
            flushed = RA.hier_flush(acc)
            e[1].record()
            grad = HG.dense_grad_of(flushed, rows_n)
            e[2].record()
            table, m, v = HG.sparse_adamw_row_update(
                flushed, table, m, v, torch.zeros((), dtype=torch.int32, device=DEVICE), opt
            )
            e[3].record()
            torch.cuda.synchronize()
        counts = read_counts()
        acc_ms = sum(a.elapsed_time(b) for a, b in acc_marks)
        runs[mode] = {
            "acc": acc, "flushed": flushed, "grad": grad, "table": table, "m": m, "v": v,
            "counts": counts, "acc_ms": acc_ms, "rate": n_tok / (acc_ms / 1e3), "wall": wall,
            "flush_ms": e[0].elapsed_time(e[1]), "dense_ms": e[1].elapsed_time(e[2]),
            "adamw_ms": e[2].elapsed_time(e[3]),
            "base_ms": sum(a.elapsed_time(b) for a, b in base_marks), "baseline": baseline,
            "exact": exact,
        }
        r = runs[mode]
        log(f"[embed] {mode}: accumulate_microbatch {acc_ms:.1f} ms for the window = {r['rate']:,.0f} "
            f"updates/s (CUDA events around each call; loop wall {wall:.3f} s with the row draws"
            f"{' and the dense baseline' if baseline is not None else ''}); hier_flush "
            f"{r['flush_ms']:.3f} ms, dense_grad_of (to_dense) {r['dense_ms']:.3f} ms, "
            f"sparse_adamw_row_update {r['adamw_ms']:.3f} ms; launches {counts}")
    k, p = runs["kernels"], runs["plain"]
    check(k["counts"]["scatter_add"] == 1 and sum(k["counts"].values()) == 1, k["counts"])
    check(sum(p["counts"].values()) == 0, ("plain_versions() launched a kernel", p["counts"]))
    acc = k["acc"]
    check(not bool(RA.hier_overflowed(acc)), "no layer of the accumulator overflowed")
    casc = acc.cascades.tolist()
    check(casc[1] > 0 and casc[2] == 0, ("layer 1 -> 2 fires, 2 -> 3 cannot", casc))
    nnz = int(k["flushed"].nnz)
    check(nnz == n_distinct, ("flushed nnz equals numpy's distinct count", nnz, n_distinct))
    err = 0.0
    for i, (a, b) in enumerate(zip(accum_leaves(acc), accum_leaves(p["acc"]))):
        err = max(err, bits_same(torch, a, b, f"embed accumulator leaf {i}"))
    for f in ("ids", "rows", "nnz", "overflow"):
        err = max(err, bits_same(torch, getattr(k["flushed"], f), getattr(p["flushed"], f), f"embed flushed {f}"))
    for f in ("grad", "table", "m", "v"):
        err = max(err, bits_same(torch, k[f], p[f], f"embed {f}"))
    # the dense baseline summed in float64, then the float32 one: a float32
    # index_add_ folds the hottest id's rows (over a quarter of the window)
    # one by one in the atomics' order, so its own rounding exceeds
    # atol=1e-5 on small sums
    exact = k["exact"]
    grad64 = k["grad"].double()
    close = torch.allclose(grad64, exact, rtol=1e-4, atol=1e-5)
    base_err = float((grad64 - exact).abs().max())
    check(close, ("dense_grad_of matches the float64 dense baseline at rtol=1e-4, atol=1e-5", base_err))
    f32_err = float((k["baseline"].double() - exact).abs().max())
    f32_vs_grad = float((k["grad"] - k["baseline"]).abs().max())
    check(bool(torch.isfinite(k["table"]).all()), "finite table after the update")
    touched = int((k["table"] != table0).any(dim=1).sum())
    log(f"[embed] cascades per layer {casc} (layer 2 -> 3 cannot fire: {n_distinct:,} distinct ids "
        f"< cut {hcfg.cuts[1]:,}); nnz per layer {[int(l.nnz) for l in acc.layers]}; flushed nnz "
        f"{nnz:,} == numpy's distinct count; no overflow")
    log(f"[embed] kernels == plain_versions() (bit-identical): accumulator, flushed rows, dense "
        f"gradient, table, m, v; dense_grad_of vs the float64 index_add_ baseline: max abs diff "
        f"{base_err:.3e} (checked at rtol=1e-4, atol=1e-5); the float32 index_add_ baseline vs "
        f"float64 {f32_err:.3e}, vs dense_grad_of {f32_vs_grad:.3e} (reported); float32 baseline "
        f"index_add_ {k['base_ms']:.1f} ms for the window; {touched:,} table rows changed by lazy AdamW")

    # how far the accumulator's merges sit from their byte bound: the flush
    # (two merges into the top layer) and one layer 1 -> 2 merge alone
    layers = acc.layers
    flush_bytes = 0
    out = layers[-1]
    for layer in reversed(layers[:-1]):
        nxt = RA.merge(out, layer, cap=layers[-1].capacity)
        flush_bytes += (int(out.nnz) + int(layer.nnz) + int(nxt.nnz)) * d * 4
        out = nxt
    # a layer 1 like the ones that cascaded: twelve microbatches' distinct ids
    src = RA.from_pairs(ids[:12].reshape(-1), torch.randn((12 * EMBED_SEQ, d), generator=gen, device=DEVICE),
                        layers[0].capacity)
    check(not bool(src.overflow), "the stand-in layer 1 fits its capacity")
    merged = RA.merge(layers[1], src, cap=layers[1].capacity)
    merge_bytes = (int(layers[1].nnz) + int(src.nnz) + int(merged.nnz)) * d * 4
    merge_ms = time_host(torch, np, lambda: RA.merge(layers[1], src, cap=layers[1].capacity), reps=3)
    flush_bound = flush_bytes / HBM_BYTES_PER_S * 1e3
    merge_bound = merge_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[embed] hier_flush {k['flush_ms']:.3f} ms vs its byte bound {flush_bound:.4f} ms "
        f"({flush_bytes / 1e9:.3f} GB: live rows read and written); one layer 1 -> 2 merge "
        f"({int(layers[1].nnz):,} + {int(src.nnz):,} -> {int(merged.nnz):,} rows) {merge_ms:.3f} ms "
        f"(host clock, synchronized) vs its bound {merge_bound:.4f} ms")
    return {
        "err": err, "launches": k["counts"], "flushed": k["flushed"], "rows_n": rows_n,
        "rate": k["rate"], "plain_rate": p["rate"], "acc_ms": k["acc_ms"], "flush_ms": k["flush_ms"],
        "dense_ms": k["dense_ms"], "plain_dense_ms": p["dense_ms"], "adamw_ms": k["adamw_ms"],
        "base_ms": k["base_ms"], "base_err": base_err, "f32_base_err": f32_err, "flush_bound_ms": flush_bound, "merge_ms": merge_ms,
        "merge_bound_ms": merge_bound, "cascades": casc, "n_distinct": n_distinct,
    }


def phase_scatter_times(torch, np, embed):
    """``scatter_add`` alone at the path's shape (the flushed accumulator
    into a zero float32 [49,664, 4096] table): kernel, bound, plain version
    and ``index_add_`` of the live prefix, the one PyTorch call that
    computes the same function (timed as a yardstick only)."""
    from repro_torch.kernels.scatter_add import ops as sa

    fl = embed["flushed"]
    ids, rows = fl.ids, fl.rows
    n, k, d = int(fl.nnz), ids.shape[0], rows.shape[1]
    table = torch.zeros((embed["rows_n"], d), device=DEVICE)
    ms = time_kernel(torch, np, lambda: sa.scatter_add(ids, rows, table))
    plain = time_host(torch, np, lambda: sa.scatter_add_plain(ids, rows, table), reps=3)
    live_ids, live_rows = ids[:n].contiguous(), rows[:n].contiguous()
    lib = time_kernel(torch, np, lambda: table.index_add_(0, live_ids, live_rows))
    # each live row: table row read and written, gradient row read; the ids
    # read once; row 0 read and written for the PAD slots' "+ 0.0" when no
    # live id owns it
    nbytes = n * d * 4 * 3 + k * 4 + (0 if int(ids[0]) == 0 else 2 * d * 4)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[times] scatter_add [{k:,} slots, {n:,} live] x {d} float32 into [{embed['rows_n']:,}, {d}]: "
        f"{ms:.4f} ms, bound {bound:.5f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s), plain {plain:.3f} ms, "
        f"index_add_ of the live prefix {lib:.4f} ms (yardstick only)")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound, "bytes": nbytes}


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[device] {name}, torch {torch.__version__}, CUDA {torch.version.cuda}; {card}")

    phase_build()
    parity_err = phase_parity(torch, np)
    ops_err = phase_parity_ops(torch, np)
    scatter_err = phase_parity_scatter(torch, np)
    data = phase_data(torch, np)
    sess8, main_run = phase_main(torch, np, data)
    bf16_err = phase_bf16_ingest(torch, np, data)
    types_err, types_launches = phase_value_types(torch, np, data)
    read = phase_read_side(torch, np, sess8, data)
    served = phase_serve(torch, np, data, sess8)
    # the fleet's workers hold their own state: free this process's first
    fleet_want = sess8.snapshot()
    del sess8
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fleet = phase_fleet(torch, np, data, fleet_want)
    del fleet_want
    gc.collect()
    torch.cuda.empty_cache()
    bench = phase_bench(torch, np)
    single_sess, single = phase_single(torch, np, data)
    times = phase_kernel_times(torch, np, data, main_run, single_sess)
    del single_sess
    algebra = phase_algebra(torch, np)
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    # free the streaming phases' state before the embedding path
    del data
    main_run.pop("routed")
    gc.collect()  # the sessions hold reference cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[embed] device memory held before the phase {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    embed = phase_embed_grad(torch, np)
    scatter_times = phase_scatter_times(torch, np, embed)
    log(f"[embed] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    paths = {"cuda": main_run["launches"], "single": single["launches"], "read": read["launches"],
             "serve": served["cuda"]["launches"], "serve_default": served["cuda_default"]["launches"],
             "serve_single": served["single"]["launches"],
             "serve_loopback": served["loopback"]["launches"], "value_types": types_launches,
             "algebra": algebra["launches"], "embed_grad": embed["launches"],
             "fleet": fleet["launches"],
             **{f"bench_{sec}": c for sec, c in bench["launches"].items()}}
    err = max(ops_err, main_run["err"], read["err"], single["err"], algebra["err"], served["err"],
              types_err)

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
        "max_abs_err": max(parity_err, main_run["err"], bf16_err, types_err),
        "ms": main_run["ms"],
        "plain_ms": main_run["plain_ms"],
        "bound_ms": main_run["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "host_ms": main_run["host_ms"],
        "by_step_kind": main_run["kinds"],
        "cuda_launches_per_call": main_run["cuda_launches_per_call"],
        "scratch_bytes": main_run["scratch_bytes"],
        "value_types": ["float32", "bfloat16", "float16", "int32"],
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
        "cascade_merges": {k: v for k, v in times.items() if k.startswith("cascade merge")},
        "tail_bytes": {k: v["tail_bytes"] for k, v in times.items() if "tail_bytes" in v},
        "cuda_launches_per_call": single["cuda_launches_per_call"],
        "value_types": ["float32", "bfloat16", "float16", "int32"],
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
        "fleet_merge": fleet["sweep"][max(FLEET_WORKERS)]["merge_kernel"],
        "cuda_launches_per_call": {"cuda": main_run["sort_cuda_launches_per_call"],
                                   "single": single["sort_cuda_launches_per_call"]},
        "host_ms": {"[8, 100000]": sd8["host_ms"], "[100000]": sd1["host_ms"]},
        "value_types": ["float32", "bfloat16", "float16", "int32"],
        "parity": "bit-identical",
    }, {
        "name": "scatter_add",
        "route": "cuda",
        "source": "src/repro_torch/csrc/scatter_add.cu",
        "replaces": "src/repro/kernels/scatter_add/kernel.py:45",
        "launches": launches("scatter_add")[0],
        "launches_by_path": launches("scatter_add")[1],
        "max_abs_err": max(scatter_err, embed["err"]),
        "ms": scatter_times["ms"],
        "plain_ms": scatter_times["plain_ms"],
        "bound_ms": scatter_times["bound_ms"],
        "bound_by": "bytes",
        "library_ms": scatter_times["library_ms"],
        "bytes": scatter_times["bytes"],
        "value_types": ["float32", "bfloat16", "float16"],
        "parity": "bit-identical",
    }]
    log(f"[rates] cuda engine K=8 {main_run['rate']:,.0f} updates/s; single engine K=1 "
        f"{single['rate']:,.0f} updates/s; embedding window {embed['rate']:,.0f} updates/s "
        f"(plain_versions() {embed['plain_rate']:,.0f})")
    sc = served["cuda"]
    sd = served["cuda_default"]
    log("[serve-metrics] " + json.dumps({
        "card": card,
        "publish_every": SERVE_PUBLISH,
        "serve_rate_records_per_s": {"to_the_kill": sc["killed"]["rate"], "replay_until_drain": sc["replay"]["rate"],
                                     "default_until_drain": sd["rate"],
                                     "single_replay": served["single"]["replay"]["rate"],
                                     "loopback": served["loopback"]["rate"]},
        "replay_wall_s": sc["replay"]["wall_s"],
        "default_wall_s": sd["wall_s"],
        "publish_ms": {"untracked": sc["publish"], "default": sd["publish"]},
        "query_ms_full_width": sc["queries"],
        "query_ms_loopback": served["loopback"]["query_ms"],
        "checkpoint": {"gb": sc["checkpoint_gb"], "host_copy_s": sc["save_copy_s"],
                       "write_s": sc["save_write_s"], "restore_s": sc["restore_s"],
                       "serve_stall_s": sc["killed"]["checkpoint_stall_s"]},
        "checkpoint_single": {"gb": served["single"]["checkpoint_gb"],
                              "host_copy_s": served["single"]["save_copy_s"],
                              "write_s": served["single"]["save_write_s"],
                              "restore_s": served["single"]["restore_s"]},
        "launches": {"serve": sc["launches"], "serve_default": sd["launches"],
                     "serve_single": served["single"]["launches"],
                     "serve_loopback": served["loopback"]["launches"]},
    }))
    log("[fleet-metrics] " + json.dumps({
        "card": card,
        "host_cores": fleet["cores"],
        "serve": FLEET_SERVE,
        "sweep": {f"N={n}": {k: v for k, v in row.items() if k != "merge_kernel"}
                  for n, row in fleet["sweep"].items()},
        "default_serve_config_N=4": fleet["default"],
        "kill_leg_N=2": fleet["kill"],
        "merge_kernel": fleet["sweep"][max(FLEET_WORKERS)]["merge_kernel"],
        "controller_chunk_ms": fleet["host_costs"],
        "launches": fleet["launches"],
    }))
    log("[bench-metrics] " + json.dumps({
        "card": card,
        "wall_s": bench["wall_s"],
        "sections": bench["sections"],
        "launches": bench["launches"],
    }))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
