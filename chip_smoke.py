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
4. LM serving (``phase_lm``, ``repro_torch.models`` and the
   ``serve_lm`` example's path): h2o-danube3-4b at its published width and
   depth (24 layers, d_model 3840, bfloat16 compute over 15.8 GB of
   float32 master weights made on the card) generates 128 tokens for 16
   prompts of 16 (timed, beside ``analysis.flops.decode_bytes`` over the
   HBM rate); the example's telemetry leg serves the generated bigram
   graph over a loopback socket into a K=4 ``cuda`` ``D4MStream.serve``
   (``sort_dedup``, ``hier_cascade``, ``merge_add`` counted), drained,
   checkpointed, restored bit-identically, its snapshot numpy's counts;
   decode against forward in float32 at full width (h2o-danube3-4b,
   mamba2-1.3b, deepseek-v3 at 3 layers with MLA both ways, phi3.5-moe at
   2 layers) by the reference's criterion; the ten architectures at
   ``reduced()`` size, the card's logits against the CPU port's;
5. LM training (``phase_train``: ``launch.steps``, the losses, remat and
   the ``train_lm`` example): qwen2-0.5b at its published width and depth
   (bfloat16 compute over float32 master weights) through
   ``make_train_step``, 4 steps of 4 x 2048 ``TokenStream`` tokens
   (Zipf 1.3, as ``train_lm`` draws them) in two microbatches, timed (ms a step, tokens/s, the model-FLOP share of the 989 TFLOP/s
   dense bfloat16 peak), the loss falling and every gradient finite; top-k
   compression's bookkeeping exact; a checkpoint after step 2 restored and
   run on, against the uninterrupted run (whisper-tiny at its published
   config: a 0.44 GB checkpoint); the embedding gather's backward
   (``scatter_add``, once a microbatch: the ``lm_train`` path) through the
   kernel and inside ``plain_versions()``, the table gradient
   bit-identical; the ``train_lm`` loop at mamba2-1.3b's published config
   with the hierarchical sparse embedding gradient (the ``train_lm``
   path), its flushed rows' dense table bit-identical to the plain
   version's and equal to count x the dense gradient's rows (ROADMAP C25);
   the ten architectures at ``reduced()`` size, the card's loss and
   gradients against the CPU port's;
6. the sharded LM path (``phase_shard``: ``models/sharding.py``'s plans,
   ``launch.steps``' sharded step, the expert-parallel MoE, the dry run):
   qwen2-0.5b at its published width and depth, ``phase_train``'s batch
   (4 x 2048, two microbatches, remat), on a 2 x 2 ``(data, model)`` mesh
   of ``cuda:0``: one "fsdp_flat" (ZeRO-3) and one "tp" step (head-split:
   heads, FFN columns and vocabulary blocks over "model"), each against
   the unsharded step under the same launch context (loss within 5e-3,
   each moment leaf within 2^-5 of its max) and timed beside it, their
   collectives (the backward's included) equal to the dry run's formula,
   ``scatter_add`` once a microbatch on each data shard holding rows (and
   under "tp" on each of its model shards), the ZeRO-3 step inside
   ``plain_versions()`` too; both again in float32 at 4 layers within
   1e-4; a "tp" step with top-k compression in float32 at 4 layers
   against the unsharded compressed step (masks equal away from 1e-6 of
   each threshold, ``sparse + residual == g + r`` exactly over the
   blocks); phi3.5-moe at full width (1 layer: 2 do not fit
   with AdamW state) on ``TokenStream``'s Zipf(1.3) ids: the
   expert-parallel MoE at 1 x 4 against the local path on the embedding of
   those tokens (load and drops exact), one "ep" step at 1 x 4 (head-split
   attention) and one "ep_fsdp" step at 2 x 2; head-split "tp" steps at
   2 x 2 for deepseek-v3 (MLA, one dense layer), mamba2-1.3b (4 of 48
   layers) and phi3.5-moe (1 layer, the local MoE path) at published width,
   each against the unsharded step run first; the dry run's qwen2-0.5b ``train_4k`` cell at 16 x 16
   under each strategy, and ``dryrun_assoc`` at 512 shards (group
   10,000, cut from 100,000); a ``[shard-metrics]`` line holds the
   numbers, the ``kernels`` line its launches as ``shard_*`` paths;
   then sharded serving (``phase_shard_serve``, leg (d): heads split over
   "model", ``place_serve_state``, ``make_serve_step`` and
   ``make_prefill_step`` over the mesh): h2o-danube3-4b at its published
   width and depth on the 2 x 2 mesh, ``decode_32k``-shaped decode at
   batch 16 (the batch over "data"), ``long_500k`` at batch 1 (the slot
   axis over "data"), 8 greedy steps each, and a 2 x 4,096 prefill,
   against the unsharded steps (bfloat16 within 2^-5, float32 at 4 layers
   within 1e-4, ``kpos`` and ``pos`` exact); the head-split paths at
   published width: deepseek-v3's MLA (3 dense layers) absorbed and naive,
   on the sequence-parallel branch too, with FSDP rows under "tp";
   mamba2-1.3b's Mamba-2 (48 layers); qwen2-0.5b's "hd" split on 2 x 4 and
   replicated cache on 2 x 3; every step's collectives
   equal to ``dryrun.serve_collectives``, and the dry run's 30 serve cells
   at 16 x 16; a ``[serve-shard-metrics]`` line holds the numbers, the
   ``kernels`` line its launches (none) as ``shard_serve``;
   then the D4M examples (``phase_examples``): ``quickstart`` and
   ``streaming_analytics --devices 4`` (the mesh engine over ``cuda:0``
   repeated, two checkpoints and the restore drill) through the kernels
   and inside ``plain_versions()``: snapshots, top-k and cascade counters
   bit-identical, the launches as ``example_*`` paths;
7. make the R-MAT stream once (200 groups of 100,000 scale-20 edges,
   ``configs/d4m_stream.CONFIG``) and count it with numpy;
8. the ``cuda`` engine at full width: K=8 hash-routed instances of the
   paper's instance shape (cuts 100k/1M/10M, top capacity 16,000,000
   each) through ``D4MStream(cfg).ingest``, 200 ``sort_dedup`` calls and
   200 ``hier_cascade`` launches; replay the same routed batches through
   the kernel alone (timed on the card by step kind, the wrapper's host
   time apart, each call under ``torch.cuda.set_sync_debug_mode("error")``)
   and through the plain versions, and require all three states
   bit-identical; then 120 groups in bfloat16 through the kernels and
   inside ``kernels.plain_versions()``, bit-identical;
9. the mesh engine (``MultiStreamEngine`` through ``D4MStream(cfg,
   mesh=Mesh(...))``): D=4 shards on ``cuda:0`` (``cuda:0..3`` on a machine
   with four cards).  D=4 x K=2 over the stream, bit-identical to step 8's
   K=8 state and, inside ``kernels.plain_versions()``, to the plain
   versions (state and global snapshot); D=4 x K=8 (32 instances, 15.3 GB)
   over the stream, its updates/s beside the ``cuda`` engine's at K=32 in
   the same call, both states bit-identical, the global snapshot numpy's
   keys with their counts; ``ShardedAssoc`` at D=4 over the stream as 50
   steps of 100,000 records a shard (key space 2^20): no drop, ``get``
   numpy's counts on 100,000 sampled keys and 100,000 absent ones, 3
   ``all-to-all`` and 1 ``all-reduce`` an update, kernels against plain
   versions bit for bit; no collective on the mesh's update path; a
   ``[mesh-metrics]`` line holds the rates;
10. the read side: the K=8 snapshot and ``query.degrees`` through the
   kernels and inside ``kernels.plain_versions()``, bit-identical, checked
   against numpy's distinct count and ``bincount``;
11. the ``single`` engine (K=1, ``CONFIG`` unchanged: top capacity 140 M)
   at full width, through the kernels and inside ``plain_versions()``,
   bit-identical, every cascade level firing;
12. per-call times of ``sort_dedup`` and ``merge_add`` at the main paths'
   shapes (``sort_dedup``: both engines' batches, the degrees' fold stage
   and its longest run, with the CUDA launches and the wrapper's host ms a
   call; ``merge_add``: the layer-1 merge, the snapshot merges and the
   ``single`` engine's last 1->2, 2->3 and 3->4 cascade merges), with
   their byte bounds (dead-tail bytes apart), plain versions and
   ``torch.sort`` of the same keys as a reference;
13. the algebra and graph queries on a uniform random graph (2^16
   vertices, 500,000 edges, ``max_fanout`` 64), kernels against plain bit
   for bit, triangles against scipy's ``trace(A^3)/6``;
14. the embedding-gradient path at granite-3-8b's full width (after the
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
15. the fleet (``repro_torch.fleet``, after the serve phases, with this
    process's streaming state freed first): N = 4 worker
    processes, each a full-width ``cuda`` session (K=8, ``CONFIG``, the
    default ``ServeConfig``) fed its host-tier shard of the 200 groups by
    ``FleetController.run``; and a kill leg (N=2 at reduced
    depth, checkpointing: SIGKILL after the first durable checkpoint,
    revive, replay).  Every merged snapshot (one ``sort_dedup`` call over
    the workers' snapshots) is bit-identical to the library-mode K=8
    snapshot, at N=4 also inside ``plain_versions()``; every worker
    reports its own ``hier_cascade``, ``sort_dedup`` and ``merge_add``
    launches; a ``[fleet-metrics]`` line holds the rates;
16. the port's benchmark suite (after the fleet, this process's streaming
    state freed): ``python -m repro_torch.benchmarks.run --experiment``
    over ``src/repro_torch/benchmarks/experiments/chip.json`` with the
    depth cuts of ``BENCH_CUTS`` in a subprocess, all nine sections at
    full width (``hier`` on 50 M of the paper's 100 M edges; the fleet on
    the 20 M-record stream at N = 1 and 4, serve, query and obs on its
    first 10 M, at ``CONFIG``'s cuts, K=8, microbatches of 100,000; the
    kernels at the main paths' shapes), each section's seconds; every ``BENCH_<section>.json`` read back through the port's
    parsers, the port's gate clean on an empty history, every section's
    correctness fields true (kernels bit-identical to their plain
    versions, every snapshot's values the stream's counts) and its kernels
    launched; a ``[bench-metrics]`` line holds
    its rates and verdicts, and the ``kernels`` line its launches as
    ``bench_<section>`` paths;
17. print a ``[timing]`` line (every phase's seconds and the whole run's),
    a ``{"kernels": [...]}`` line, the card's name and power limit,
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
    keys, counts = np.unique(src.astype(np.int64) * 2**32 + dst.astype(np.int64), return_counts=True)
    n_distinct = int(keys.size)
    out_deg = np.bincount(src)
    log(f"[data] {n_edges:,} R-MAT scale-{CONFIG.scale} edges, {n_distinct:,} distinct, "
        f"made in {t_gen:.1f} s, counted in {time.perf_counter() - t0 - t_gen:.1f} s (host)")
    return {
        "n_edges": n_edges,
        "n_distinct": n_distinct,
        "keys": keys,  # the distinct keys, sorted, and each one's count of edges (host)
        "counts": counts,
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


MESH_D = 4  # shards: on the cards in turn (cuda:0..3 on four cards, all on cuda:0 on one)
MESH_K = 2  # D x K = phase_main's K=8 instances, held to that state bit for bit
MESH_FULL_K = 8  # D x K = 32 instances at full width, beside the cuda engine at K=32
SHARDED_STEPS = 50  # ShardedAssoc: 50 steps of D x 100,000 records = the whole stream
SHARDED_KEY_SPACE = 1 << 20  # rows of the scale-20 stream
SHARDED_TOP = 16_000_000  # shard 0 owns ~58% of the R-MAT rows' records (a + b)^2
SHARDED_QUERIES = 100_000  # sampled keys for get, and as many absent ones


def shards_vs_packed(torch, shards, packed, what) -> float:
    """Shard ``d`` of a mesh state (``[K]``) against instances
    ``d*K .. d*K+K-1`` of a packed state, bit for bit, with no copy of the
    whole state."""
    k = shards[0].cascades.shape[0]
    want = leaves(packed)
    for d, h in enumerate(shards):
        for i, (g, w) in enumerate(zip(leaves(h), want)):
            bits_same(torch, g, w[d * k:(d + 1) * k].to(g.device), f"{what}: shard {d} leaf {i}")
    return 0.0


def free(torch) -> None:
    gc.collect()  # sessions hold reference cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def setting(target, key, value):
    """``target[key]`` (a dict) or ``target.key`` (a module) set to
    ``value`` for the block, restored after it."""
    get, put = ((target.__getitem__, target.__setitem__) if isinstance(target, dict)
                else (lambda k: getattr(target, k), lambda k, v: setattr(target, k, v)))
    was = get(key)
    put(key, value)
    try:
        yield
    finally:
        put(key, was)


def snapshot_holds_counts(torch, np, snap, data, what) -> None:
    """The global snapshot holds numpy's distinct keys, each with its
    count of records, and nothing else."""
    n = data["n_distinct"]
    check(int(snap.nnz) == n and not bool(snap.overflow), (what, int(snap.nnz), n))
    dev = snap.rows.device
    keys = (snap.rows[:n].to(torch.int64) << 32) | snap.cols[:n].to(torch.int64)
    check(torch.equal(keys, torch.from_numpy(data["keys"]).to(dev)), f"{what}: keys")
    check(torch.equal(snap.vals[:n], torch.from_numpy(data["counts"]).to(dev, torch.float32)),
          f"{what}: each key's value is its count of records")
    check(bool((snap.rows[n:] == PAD_ROW).all()), f"{what}: dead tail")


def mesh_ingest(torch, sess, R, C, V):
    """The stream through ``sess.ingest``: ``(wall_s, dropped)``."""
    dropped = torch.zeros((), dtype=torch.int64, device=sess.device)
    sess.synchronize()
    t0 = time.perf_counter()
    for g in range(STEPS):
        dropped += sess.ingest(R[g], C[g], V[g])
    sess.synchronize()
    return time.perf_counter() - t0, int(dropped)


def phase_mesh(torch, np, data, sess8):
    """The mesh engine: D=4 shards over ``cuda:0`` (or four cards).

    1. D=4 x K=2 over phase_main's stream, bit-identical to the ``cuda``
       engine's K=8 state (the same hash route); the same run inside
       ``plain_versions()`` bit-identical to it, state and global snapshot;
    2. D=4 x K=8 (32 instances of ``CONFIG``'s shape) over the stream, its
       updates/s beside the ``cuda`` engine's at K=32 in this call, the
       global snapshot numpy's keys and counts, both states bit-identical;
    3. ``ShardedAssoc`` at D=4, key space 2^20: the stream as 50 steps of
       100,000 records a shard, no drop, ``get`` numpy's counts on sampled
       keys, 3 ``all-to-all`` and 1 ``all-reduce`` an update, kernels
       against plain versions bit for bit.
    """
    from repro_torch import kernels
    from repro_torch.benchmarks import bench_scaling
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.core import distributed
    from repro_torch.core.mesh import Mesh
    from repro_torch.d4m import D4MStream

    R, C, V, n_edges = data["R"], data["C"], data["V"], data["n_edges"]
    n = data["n_distinct"]
    mesh = Mesh.over("cuda", MESH_D, repeat=True)
    devs = mesh.device_list
    log(f"[mesh] D={MESH_D} shards on {[str(d) for d in devs]} ({mesh.distinct_devices()} distinct)")
    t_phase = time.perf_counter()

    # -- 1. D=4 x K=2 against the cuda engine at K=8, and the plain versions
    cfg2 = CONFIG.to_session(instances_per_device=MESH_K, top_capacity=TOP_CAPACITY, snapshot_cap=n)
    runs = {}
    for mode in ("kernels", "plain"):
        sess = D4MStream(cfg2, mesh=mesh)
        check(sess.kind == "mesh" and sess.n_instances == K, (sess.kind, sess.n_instances))
        sess.state
        zero_counts()
        mesh.reset_collectives()
        ctx = kernels.plain_versions() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            wall, dropped = mesh_ingest(torch, sess, R, C, V)
            check(dropped == 0 and not sess.overflowed(), (mode, dropped))
            t0 = time.perf_counter()
            snap = sess.snapshot(cap=n)
            torch.cuda.synchronize()
            snap_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        runs[mode] = (sess, snap, counts, wall, snap_ms, dict(mesh.collectives))
        log(f"[mesh] D={MESH_D} x K={MESH_K} {mode}: {STEPS} groups in {wall:.3f} s = "
            f"{n_edges / wall:,.0f} updates/s; global snapshot {snap_ms:.1f} ms; launches {counts}; "
            f"collectives {dict(mesh.collectives)}")
    (ks, ksnap, kcounts, kwall, _, kcoll), (ps, psnap, pcounts, _, _, _) = runs["kernels"], runs["plain"]
    check(kcounts["hier_cascade"] == MESH_D * STEPS and kcounts["sort_dedup"] == MESH_D * STEPS
          and kcounts["merge_add"] > 0, kcounts)
    check(sum(pcounts.values()) == 0, ("plain_versions() launched a kernel", pcounts))
    check(sum(kcoll.values()) == 0, ("collectives on the update path", kcoll))
    err = shards_vs_packed(torch, ks.state, sess8.state, "mesh D=4 x K=2 vs cuda K=8")
    err = max(err, shards_vs_packed(torch, ps.state, sess8.state, "plain mesh vs cuda K=8"))
    err = max(err, assoc_same(torch, ksnap, psnap, "mesh global snapshot: kernels vs plain"))
    snapshot_holds_counts(torch, np, ksnap, data, "mesh D=4 x K=2")
    log(f"[mesh] D={MESH_D} x K={MESH_K} state == cuda engine K={K} state == plain versions "
        f"(bit-identical); global snapshot == plain == numpy's keys and counts")
    small = {"rate": n_edges / kwall, "launches": kcounts}
    del runs, ks, ps, ksnap, psnap, sess, snap
    free(torch)

    # -- 2. full width: D=4 x K=8 beside the cuda engine at K=32 -----------
    cfg8 = CONFIG.to_session(instances_per_device=MESH_FULL_K, top_capacity=TOP_CAPACITY, snapshot_cap=n)
    full = D4MStream(cfg8, mesh=mesh)
    check(full.n_instances == MESH_D * MESH_FULL_K, full.n_instances)
    full.state
    zero_counts()
    mesh.reset_collectives()
    wall_mesh, dropped = mesh_ingest(torch, full, R, C, V)
    ingest_coll = dict(mesh.collectives)
    t0 = time.perf_counter()
    snap = full.snapshot()
    torch.cuda.synchronize()
    snap_ms = (time.perf_counter() - t0) * 1e3
    mesh_counts = read_counts()
    check(dropped == 0 and not full.overflowed(), dropped)
    check(sum(ingest_coll.values()) == 0, ("collectives on the update path", ingest_coll))
    check(mesh_counts["hier_cascade"] == MESH_D * STEPS and mesh_counts["sort_dedup"] >= MESH_D * STEPS
          and mesh_counts["merge_add"] > 0, mesh_counts)
    snapshot_holds_counts(torch, np, snap, data, f"mesh D={MESH_D} x K={MESH_FULL_K}")
    casc = full.engine.cascades_per_instance(full.state).cpu()
    check(bool((casc[:, 1] > 0).all()), casc)
    log(f"[mesh] D={MESH_D} x K={MESH_FULL_K} ({full.plan.total_bytes / 1e9:.2f} GB): {STEPS} groups "
        f"in {wall_mesh:.3f} s = {n_edges / wall_mesh:,.0f} updates/s, launches {mesh_counts}; "
        f"global snapshot {snap_ms:.1f} ms == numpy's keys and counts; cascades per layer "
        f"{casc.sum(0).tolist()}")
    del snap
    free(torch)
    cfg32 = CONFIG.to_session(instances_per_device=MESH_D * MESH_FULL_K, top_capacity=TOP_CAPACITY,
                              snapshot_cap=n)
    flat = D4MStream(cfg32)
    check(flat.kind == "cuda", flat.kind)
    flat.state
    zero_counts()
    wall_flat, dropped = mesh_ingest(torch, flat, R, C, V)
    flat_counts = read_counts()
    check(dropped == 0 and flat_counts["hier_cascade"] == STEPS, (dropped, flat_counts))
    err = max(err, shards_vs_packed(torch, full.state, flat.state,
                                    f"mesh D={MESH_D} x K={MESH_FULL_K} vs cuda K={MESH_D * MESH_FULL_K}"))
    log(f"[mesh] cuda engine K={MESH_D * MESH_FULL_K}: {STEPS} groups in {wall_flat:.3f} s = "
        f"{n_edges / wall_flat:,.0f} updates/s, launches {flat_counts}; its state == the mesh's "
        f"(bit-identical)")
    del full, flat
    free(torch)

    # -- 3. ShardedAssoc: one global array, key-range sharded ------------------
    sa = distributed.ShardedAssoc(mesh, "data", CONFIG.cuts, SHARDED_TOP, CONFIG.group_size,
                                  key_space=SHARDED_KEY_SPACE)
    steps = [(R[g:g + MESH_D], C[g:g + MESH_D], V[g:g + MESH_D]) for g in range(0, STEPS, MESH_D)]
    check(len(steps) == SHARDED_STEPS, len(steps))
    states = {}
    for mode in ("kernels", "plain"):
        h = sa.init_state()
        torch.cuda.synchronize()
        zero_counts()
        mesh.reset_collectives()
        ctx = kernels.plain_versions() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            dropped = torch.zeros((), dtype=torch.int64, device=devs[0])
            t0 = time.perf_counter()
            for r, c, v in steps:
                h, d = sa.update(h, r, c, v)
                dropped += d
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        coll = dict(mesh.collectives)
        counts = read_counts()
        check(int(dropped) == 0, (mode, int(dropped)))
        check(coll["all-to-all"] == 3 * SHARDED_STEPS and coll["all-reduce"] == SHARDED_STEPS
              and sum(coll.values()) == 4 * SHARDED_STEPS, coll)
        states[mode] = (h, wall, counts)
        log(f"[sharded] {mode}: {SHARDED_STEPS} steps of {MESH_D} x {CONFIG.group_size:,} records in "
            f"{wall:.3f} s = {n_edges / wall:,.0f} updates/s, launches {counts}, collectives {coll}")
    h, sa_wall, sa_counts = states["kernels"]
    check(sa_counts["sort_dedup"] >= MESH_D * SHARDED_STEPS and sa_counts["merge_add"] > 0, sa_counts)
    check(sum(states["plain"][2].values()) == 0, ("plain_versions() launched a kernel", states["plain"][2]))
    for d in range(MESH_D):
        err = max(err, compare(torch, h[d], states["plain"][0][d], f"ShardedAssoc shard {d}: kernels vs plain"))
    del states["plain"]
    per_shard = [int(sum(l.nnz for l in hd.layers)) for hd in h]
    # get against numpy's counts, on sampled keys and as many absent ones
    rng = np.random.default_rng(1)
    pick = rng.choice(n, SHARDED_QUERIES, replace=False)
    keys = data["keys"][pick]
    qr = np.concatenate([keys >> 32, rng.integers(0, SHARDED_KEY_SPACE, SHARDED_QUERIES)]).astype(np.int32)
    qc = np.concatenate([keys & 0xFFFFFFFF, SHARDED_KEY_SPACE + rng.integers(0, 1000, SHARDED_QUERIES)]
                        ).astype(np.int32)
    want = np.concatenate([data["counts"][pick], np.zeros(SHARDED_QUERIES)]).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sa.get(h, torch.from_numpy(qr), torch.from_numpy(qc))
    torch.cuda.synchronize()
    get_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(got.cpu().numpy(), want), "ShardedAssoc.get == numpy's counts")
    # the exchange alone: one step's buckets through the three all_to_alls
    r, c, v = steps[0]
    buckets = [distributed.bucket_by_owner_sorted(r[i].to(devs[i]), c[i].to(devs[i]), v[i].to(devs[i]),
                                                   MESH_D, SHARDED_KEY_SPACE, sa.slot_cap, sa.sr)
               for i in range(MESH_D)]
    mesh.reset_collectives()
    a2a_ms = time_host(torch, np, lambda: [mesh.all_to_all([b[j] for b in buckets], "data")
                                           for j in range(3)])
    step_ms = sa_wall / SHARDED_STEPS * 1e3
    log(f"[sharded] distinct keys a shard {per_shard} (sum {sum(per_shard):,} >= {n:,} distinct: "
        f"layers may repeat a key); get of {2 * SHARDED_QUERIES:,} keys {get_ms:.1f} ms == numpy's "
        f"counts; the three all_to_alls {a2a_ms:.3f} ms of a {step_ms:.3f} ms step "
        f"({a2a_ms / step_ms:.1%}); shards == plain versions (bit-identical)")
    del h, states, buckets
    free(torch)

    colls = bench_scaling.update_path_collectives(MESH_D, k_per_device=4)
    check(sum(colls.values()) == 0, colls)
    wall_phase = time.perf_counter() - t_phase
    log(f"[mesh] update_path_collectives (D={MESH_D}, K=4) {colls}; phase {wall_phase:.1f} s")
    return {
        "err": err,
        "devices": [str(d) for d in devs],
        "distinct_devices": mesh.distinct_devices(),
        "rates": {f"mesh_D{MESH_D}_K{MESH_K}": small["rate"],
                  f"mesh_D{MESH_D}_K{MESH_FULL_K}": n_edges / wall_mesh,
                  f"cuda_K{MESH_D * MESH_FULL_K}": n_edges / wall_flat,
                  "sharded_assoc": n_edges / sa_wall},
        "mesh_snapshot_ms": snap_ms,
        "sharded": {"step_ms": step_ms, "all_to_all_ms": a2a_ms, "all_to_all_share": a2a_ms / step_ms,
                    "get_ms": get_ms, "keys_per_shard": per_shard},
        "update_path_collectives": colls,
        "launches": {"mesh": mesh_counts, "mesh_parity": small["launches"], "sharded_assoc": sa_counts},
        "phase_s": wall_phase,
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
SERVE_DEFAULT_STEPS = 30  # the default-ServeConfig serve, at reduced depth (cut from 200 groups, then 60)
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
    """The given records served uninterrupted into a fresh session with
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
    card); its first ``SERVE_DEFAULT_STEPS`` groups served again with the
    default ``ServeConfig`` (degrees tracked on the host), against a
    library-mode session of those groups; the kill and replay at reduced
    depth for the ``single`` engine; and a loopback
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
    # the default ServeConfig at reduced depth: its host degree fold runs
    # at a few hundred thousand records a second
    kd = SERVE_DEFAULT_STEPS * CONFIG.group_size
    ref_d = D4MStream(cfg)
    for g in range(SERVE_DEFAULT_STEPS):
        ref_d.ingest(data["R"][g], data["C"][g], data["V"][g])
    out["cuda_default"] = serve_default(torch, np, cfg, rows[:kd], cols[:kd], vals[:kd], ref_d)
    del ref_d
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


# the full-width fleet: 32 instances on the card (the sweep over N = 1, 2
# and 4 cut to N = 4: phase_bench's fleet section runs N = 1, 2 and 4)
FLEET_WORKERS = (4,)
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
    router, at N = 4 (32 instances; the bench's fleet section runs N = 1
    and 4 untracked) with the default ``ServeConfig`` (degrees tracked in
    the workers); and the kill leg (N = 2) at reduced depth.  Every
    merged snapshot (one ``sort_dedup`` call in this process over the
    workers' snapshots) is the library-mode K=8 snapshot ``want``, bit for
    bit; at N=4 also inside ``kernels.plain_versions()``.  The workers'
    launch counts come back with their reports."""
    from repro_torch import kernels
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.core import assoc

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
        report, spawn_s, hists = fleet_run(cfg, n_workers, rows, cols, vals, None, True, f"n{n_workers}")
        push = hists["fleet.push_ns"]
        check(report.telemetry is not None and cfg.serve is None, "the fleet's default ServeConfig")
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
#: depth cuts of ``chip.json`` for this script's time limit (section: {param:
#: value}); ``chip.json`` itself stays at full depth
BENCH_CUTS = {
    "hier": {"total_edges": 50_000_000},  # from the paper's 100,000,000 (scale 26 kept)
    "serve": {"batches": 100, "socket_records": 500_000},  # from 200 microbatches; 2,000,000 socket records
    "query": {"batches": 100},  # from 200 microbatches of 100,000
    "obs": {"batches": 100},  # from 200, each of its three repeats
    "fleet": {"hosts_values": [1, 4]},  # from 1, 2, 4 (phase_fleet's kill leg runs N = 2)
}
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
BENCH_LABEL_KEYS = ("k", "k_per_device", "n_devices", "engine", "schedule", "hosts", "n", "V")


def _bench_label(m) -> str:
    keys = ",".join(f"{k}={m.params[k]}" for k in BENCH_LABEL_KEYS if k in m.params)
    return f"{m.name}[{keys}]" if keys else m.name


def phase_bench(torch, np):
    """The port's benchmark suite on the card: ``python -m
    repro_torch.benchmarks.run --experiment`` over ``chip.json`` with the
    depth cuts of ``BENCH_CUTS`` in a subprocess (all nine sections at the
    full-width sizes the spec names, ``hier`` at 50 M edges),
    each section's seconds from its output's arrival, its
    ``BENCH_<section>.json`` read back through the port's
    parsers, the port's gate run against an empty history (a clean pass),
    every section's correctness fields true, its kernels launched, its
    verdicts and rates returned for the ``[bench-metrics]`` line."""
    import shutil
    import tempfile
    import threading

    from repro_torch.bench import gate_run, normalize_dir

    out_dir = tempfile.mkdtemp(prefix="d4m-bench-")
    try:
        spec = json.loads(BENCH_SPEC.read_text())
        reduced = {}
        for leg in spec["legs"]:
            for k, v in BENCH_CUTS.get(leg["section"], {}).items():
                reduced[f"{leg['section']}.{k}"] = [leg["params"][k], v]
                leg["params"][k] = v
        spec_path = Path(out_dir) / "spec" / "chip_cut.json"
        spec_path.parent.mkdir()
        spec_path.write_text(json.dumps(spec))
        log(f"[bench] {BENCH_SPEC.name}, reduced: {reduced}")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        lines, stderr = [], tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.benchmarks.run", "--experiment", str(spec_path),
             "--json-dir", out_dir],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=stderr, text=True,
        )

        def read():
            for line in proc.stdout:
                lines.append((time.perf_counter() - t0, line.rstrip("\n")))

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        try:
            proc.wait(timeout=BENCH_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            reader.join()
        wall = time.perf_counter() - t0
        stderr.seek(0)
        err_text = stderr.read()
        stderr.close()
        sections_s, last = {}, (0.0, None)
        for at, line in lines:
            log(f"[bench] {line}")
            if line.startswith("experiment,"):  # a section begins
                if last[1] is not None:
                    sections_s[last[1]] = at - last[0]
                last = (at, dict(kv.split("=", 1) for kv in line.split(",") if "=" in kv).get("leg"))
        if last[1] is not None:
            sections_s[last[1]] = wall - last[0]
        check(proc.returncode == 0, f"the bench suite exited {proc.returncode}: {err_text[-4000:]}")
        record, problems = normalize_dir(out_dir, strict=True)
        check(not problems, problems)
        sections = record.sections()
        check(set(sections) == set(BENCH_KERNELS), ("bench sections", sections))
        gate = gate_run(record, [])
        check(gate.baseline_established and gate.passed and not gate.failed,
              "the port's gate on an empty history is a clean pass")
        out = {"wall_s": wall, "sections_s": sections_s, "reduced": reduced, "sections": {}, "launches": {}}
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
            f"{wall:.1f} s ({ {k: round(v, 1) for k, v in sections_s.items()} } s a leg, from the output's "
            f"arrival); the port's gate on an empty history: baseline established (pass)")
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


def scatter_times(torch, np, ids, rows, nnz, table_rows, tag):
    """``scatter_add`` alone: sorted-unique ``ids`` (PAD past ``nnz``) and
    their ``rows`` into a zero ``[table_rows, d]`` table of the rows' dtype:
    kernel, bound, plain version and ``index_add_`` of the live prefix, the
    one PyTorch call that computes the same function (timed as a yardstick
    only)."""
    from repro_torch.kernels.scatter_add import ops as sa

    k, d, el = ids.shape[0], rows.shape[1], rows.element_size()
    table = torch.zeros((table_rows, d), dtype=rows.dtype, device=DEVICE)
    ms = time_kernel(torch, np, lambda: sa.scatter_add(ids, rows, table))
    plain = time_host(torch, np, lambda: sa.scatter_add_plain(ids, rows, table), reps=3)
    live_ids, live_rows = ids[:nnz].contiguous(), rows[:nnz].contiguous()
    lib = time_kernel(torch, np, lambda: table.index_add_(0, live_ids, live_rows))
    # each live row: table row read and written, gradient row read; the ids
    # read once; row 0 read and written for the PAD slots' "+ 0.0" when no
    # live id owns it
    pad_row = 0 if nnz == k or int(ids[0]) == 0 else 2 * d * el
    nbytes = nnz * d * el * 3 + k * 4 + pad_row
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] scatter_add [{k:,} slots, {nnz:,} live] x {d} {str(rows.dtype)[6:]} into [{table_rows:,}, {d}]: "
        f"{ms:.4f} ms, bound {bound:.5f} ms ({nbytes / 1e6:.2f} MB at 3.35 TB/s), plain {plain:.3f} ms, "
        f"index_add_ of the live prefix {lib:.4f} ms (yardstick only)")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound, "bytes": nbytes,
            "slots": k, "live": nnz}


LM_ARCH = "h2o_danube3_4b"  # serve_lm's default architecture, at its published config
LM_BATCH, LM_PROMPT, LM_GEN = 16, 16, 128  # 16 sequences, 16-token prompts, 128 new tokens
LM_SEED = 0
LM_SEQ = 12  # decode against forward over 12 positions, as the reference's test
# the decode-against-forward legs, float32 compute at full width; depth cut
# where the whole model would not fit the card (printed as ``reduced``)
LM_LEGS = (
    ("h2o_danube3_4b", {}),
    ("mamba2_1_3b", {}),
    ("deepseek_v3", {"n_layers": 3, "first_dense": 3}),  # MLA, absorbed and naive; no routed experts
    ("phi3_5_moe", {"n_layers": 2}),  # 16 experts, top-2
)
LM_REL = 1e-4  # the card's logits against the CPU port's, reduced archs, float32


def tree_bytes(tree) -> int:
    from repro_torch.models.transformer import tree_map

    sizes = []
    tree_map(lambda t: sizes.append(t.numel() * t.element_size()), tree)
    return sum(sizes)


def lm_inputs(torch, cfg, gen, batch, seq, device):
    """Tokens and (whisper, paligemma) stub frontend embeddings from ``gen``."""
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=gen.device, dtype=torch.int32)
    fe = None
    if cfg.frontend == "vision" or cfg.encoder_layers:
        n = cfg.frontend_tokens if cfg.frontend == "vision" else cfg.encoder_tokens
        fe = torch.randn((batch, n, cfg.d_model), generator=gen, device=gen.device) * 0.02
    return tokens.to(device), None if fe is None else fe.to(device)


def decode_logits(torch, SV, params, cfg, tokens, fe):
    """Teacher-forced decode logits [B, S, V] through the static cache."""
    B, S = tokens.shape
    cache = SV.init_cache(cfg, B, S, torch.float32, tokens.device)
    if cfg.encoder_layers:
        cache = SV.prefill_encoder(params, cfg, fe, cache)
    outs = []
    for t in range(S):
        lg, cache = SV.decode_step(params, cfg, cache, tokens[:, t : t + 1], ep_axis=None)
        outs.append(lg)
    return torch.cat(outs, dim=1)


def decode_vs_forward(torch, np, cfg, full, dec, what) -> dict:
    """The reference's criterion (``tests/models/test_models.py``): per
    position, max |decode - forward| over max|forward| <= 5e-3 everywhere
    (at all but 2 positions for MoE), median < 5e-4."""
    scale = float(full.abs().max()) + 1e-9
    per_pos = ((full - dec).abs().amax(dim=(0, 2)) / scale).cpu().numpy()
    n_bad = int((per_pos > 5e-3).sum())
    allowed = 2 if cfg.moe is not None else 0
    check(n_bad <= allowed and float(np.median(per_pos)) < 5e-4, (what, per_pos.tolist()))
    return {"max": float(per_pos.max()), "median": float(np.median(per_pos)), "n_over_5e-3": n_bad}


LM_PROFILE_STEPS = 8


def device_kernels(prof) -> list:
    """The kernels' own rows of a ``torch.profiler`` trace (an operator's
    row repeats its kernels' time), with their device time."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.self_device_time_total > 0]


def top_kernels(events, n, per=1) -> dict:
    """The ``n`` costliest kernels' device ms (over ``per``), summed by the
    first 90 characters of their names."""
    ms = {}
    for e in events:
        ms[e.key[:90]] = ms.get(e.key[:90], 0.0) + e.self_device_time_total / 1e3 / per
    return dict(sorted(ms.items(), key=lambda kv: -kv[1])[:n])


def profile_decode(torch, SV, params, cfg, prompts, s_cap) -> dict:
    """``torch.profiler`` over ``LM_PROFILE_STEPS`` decode steps: the
    device's busy time (its kernels' time summed) against the wall time
    under the profiler, the host's time to queue a step, and the five
    costliest kernels.  Device times read "not measured" where the trace
    holds none."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import compute_dtype

    cache = SV.init_cache(cfg, prompts.shape[0], s_cap, compute_dtype(cfg), prompts.device)
    tok = prompts[:, :1]
    SV.decode_step(params, cfg, cache, tok, ep_axis=None)  # outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_PROFILE_STEPS):
            SV.decode_step(params, cfg, cache, tok, ep_axis=None)
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    return {
        "steps": LM_PROFILE_STEPS,
        "wall_ms_per_step": wall / LM_PROFILE_STEPS * 1e3,
        "host_queue_ms_per_step": queued / LM_PROFILE_STEPS * 1e3,
        "device_busy_ms_per_step": busy_ms / LM_PROFILE_STEPS if events else "not measured",
        "device_idle_share": 1 - busy_ms / (wall * 1e3) if events else "not measured",
        "top_kernels_ms_per_step": top_kernels(events, 5, LM_PROFILE_STEPS),
    }


def phase_lm(torch, np):
    """LM serving on the card (``repro_torch.models`` and the serve_lm
    example's path).

    1. h2o-danube3-4b at its published width and depth (24 layers, d_model
       3840, SWA 4096, bfloat16 compute over float32 master weights made on
       the card from a seed): ``greedy_generate`` for 16 prompts of 16
       tokens and 128 new tokens each, timed; then the example's telemetry
       leg: the generated bigram graph over a loopback socket into a K=4
       ``D4MStream.serve`` on the ``cuda`` engine, drained, checkpointed and
       restored bit-identically, its snapshot numpy's counts of the pairs;
       ``sort_dedup``, ``hier_cascade`` and ``merge_add`` counted on it;
    2. decode against forward at full width in float32 (h2o-danube3-4b,
       mamba2-1.3b, deepseek-v3 and phi3.5-moe, depth cut where printed),
       the reference's criterion; deepseek's MLA both ways;
    3. the ten architectures at ``reduced()`` size: the card's logits
       against the CPU port's on the same weights, and decode against
       forward on the card."""
    import dataclasses
    import tempfile

    from repro_torch.analysis import flops
    from repro_torch.configs import ARCH_IDS, get_config, reduced
    from repro_torch.examples import serve_lm
    from repro_torch.models import serving as SV
    from repro_torch.models import transformer as TF

    t_phase = time.perf_counter()
    out = {}
    # ---- 1. the main path: generate at full width, serve the telemetry
    cfg = get_config(LM_ARCH)
    nbytes = tree_bytes(TF.init_params(None, cfg, device="meta"))
    s_cap = LM_PROMPT + LM_GEN
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, SWA {cfg.sliding_window}, "
        f"{cfg.dtype} compute; float32 master weights {nbytes / 1e9:.2f} GB ({nbytes // 4:,} params); "
        f"batch {LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} new tokens; no reductions")
    params, prompts, _ = serve_lm.make_model(cfg, LM_BATCH, LM_PROMPT, DEVICE, seed=LM_SEED)
    check(tree_bytes(params) == nbytes, "the tree on the card holds the meta tree's bytes")
    with torch.no_grad():
        SV.greedy_generate(params, cfg, prompts, steps=2, s_cap=s_cap)  # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_out = SV.greedy_generate(params, cfg, prompts, steps=LM_GEN, s_cap=s_cap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = profile_decode(torch, SV, params, cfg, prompts, s_cap)
    tokens = gen_out.cpu().numpy()
    check(tokens.shape == (LM_BATCH, LM_GEN) and tokens.dtype == np.int32, ("tokens", tokens.shape))
    check(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab, "tokens in the vocabulary")
    n_steps = LM_PROMPT + LM_GEN - 1  # prefill by repeated decode, as the reference
    step_ms = wall / n_steps * 1e3
    step_bytes = flops.decode_bytes(cfg, LM_BATCH, s_cap)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, prompts, gen_out
    free(torch)
    out["generate"] = {"wall_s": wall, "decode_steps": n_steps, "ms_per_step": step_ms,
                       "tokens_per_s": LM_BATCH * LM_GEN / wall,
                       "decode_tokens_per_s": LM_BATCH * n_steps / wall,
                       "decode_bytes": step_bytes, "bound_ms_per_step": bound_ms, "peak_gb": peak,
                       "profile": prof}
    log(f"[lm] greedy_generate: {n_steps} decode steps in {wall:.3f} s: {step_ms:.3f} ms a step "
        f"(bound {bound_ms:.3f} ms: decode_bytes {step_bytes / 1e9:.3f} GB at 3.35 TB/s), "
        f"{LM_BATCH * LM_GEN / wall:,.0f} generated tokens/s ({LM_BATCH * n_steps / wall:,.0f} "
        f"decoded tokens/s incl. the prompt); peak device memory {peak:.2f} GB")
    log(f"[lm] decode step under torch.profiler: {prof}")

    zero_counts()
    with tempfile.TemporaryDirectory(prefix="serve_lm_ckpt_") as ckpt_dir:
        served = serve_lm.serve_bigrams(tokens, DEVICE, ckpt_dir)
    launches = read_counts()
    cuda_launches = {k: mod.cuda_launch_count for k, mod in counters().items() if hasattr(mod, "cuda_launch_count")}
    check(served["kind"] == "cuda", ("engine", served["kind"]))
    for name in ("sort_dedup", "hier_cascade", "merge_add"):
        check(launches[name] > 0, f"the LM telemetry path launched no {name}")
    prev, nxt = serve_lm.bigrams_of(tokens)
    keys, counts = np.unique(prev.astype(np.int64) * 2**32 + nxt, return_counts=True)
    rows, cols, vals = served["snapshot"]
    check(np.array_equal(rows.astype(np.int64) * 2**32 + cols, keys), "served keys are the bigrams")
    check(np.array_equal(vals, counts.astype(np.float32)), "each bigram's value is its count")
    rep = served["report"]
    out["serve"] = {"records": rep.records_fed, "distinct": int(keys.size), "rate": rep.ingest_rate,
                    "wall_s": rep.wall_s, "batches": rep.batches_fed,
                    "checkpoints": [c["step"] for c in rep.checkpoints]}
    out["launches"] = launches
    out["cuda_launches"] = cuda_launches
    log(f"[lm] telemetry: {rep.records_fed:,} bigrams ({keys.size:,} distinct) served in {rep.batches_fed} "
        f"microbatches at {rep.ingest_rate:,.0f} records/s on the K=4 cuda engine, restored bit-identically, "
        f"snapshot == numpy's counts; wrapper launches {launches}, CUDA launches {cuda_launches}")

    # ---- 2. decode against forward at full width, float32
    out["legs"] = {}
    for arch, cut in LM_LEGS:
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut)
        nbytes = tree_bytes(TF.init_params(None, cfg, device="meta"))
        log(f"[lm] leg {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} layers, float32, "
            f"{nbytes / 1e9:.2f} GB of weights; " + (f"reduced: {cut}" if cut else "no reductions"))
        t0 = time.perf_counter()
        gen = torch.Generator(device=DEVICE).manual_seed(LM_SEED + 1)
        params = TF.init_params(gen, cfg, DEVICE)
        tokens_t, fe = lm_inputs(torch, cfg, gen, 2, LM_SEQ, DEVICE)
        with torch.no_grad():
            full, _, _ = TF.forward(params, cfg, tokens_t, fe, ep_axis=None)
            modes = (True, False) if cfg.mla is not None else (SV.MLA_ABSORBED["enabled"],)
            res = {}
            for absorbed in modes:
                SV.MLA_ABSORBED["enabled"] = absorbed
                try:
                    dec = decode_logits(torch, SV, params, cfg, tokens_t, fe)
                finally:
                    SV.MLA_ABSORBED["enabled"] = True
                key = ("absorbed" if absorbed else "naive") if cfg.mla is not None else "decode"
                res[key] = decode_vs_forward(torch, np, cfg, full, dec, f"{cfg.name} {key}")
        torch.cuda.synchronize()
        res.update(gb=nbytes / 1e9, reduced=cut, s=time.perf_counter() - t0)
        out["legs"][cfg.name] = res
        log(f"[lm] leg {cfg.name}: decode vs forward {res} ")
        del params, full, dec
        free(torch)

    # ---- 3. the ten archs at reduced size: the card against the CPU port
    out["reduced"] = {}
    for arch in ARCH_IDS:
        cfg = reduced(get_config(arch))  # float32
        gen = torch.Generator().manual_seed(LM_SEED + 2)
        params = TF.init_params(gen, cfg, "cpu")
        tokens_t, fe = lm_inputs(torch, cfg, gen, 2, 16, "cpu")
        with torch.no_grad():
            want, _, _ = TF.forward(params, cfg, tokens_t, fe, ep_axis=None)
            dparams = TF.tree_map(lambda t: t.to(DEVICE), params)
            dtok, dfe = tokens_t.to(DEVICE), None if fe is None else fe.to(DEVICE)
            got, _, _ = TF.forward(dparams, cfg, dtok, dfe, ep_axis=None)
            rel = float((got.cpu() - want).abs().max() / want.abs().max())
            check(rel <= LM_REL, (cfg.name, "card against CPU", rel))
            row = {"card_vs_cpu": rel}
            if cfg.frontend != "vision":  # as the reference's test: the VLM's decode has no prefix path
                dec = decode_logits(torch, SV, dparams, cfg, dtok[:, :LM_SEQ], dfe)
                full, _, _ = TF.forward(dparams, cfg, dtok[:, :LM_SEQ], dfe, ep_axis=None)
                row["decode_vs_forward"] = decode_vs_forward(torch, np, cfg, full, dec, f"{cfg.name} reduced")
        out["reduced"][cfg.name] = row
    log(f"[lm] reduced archs on the card: {out['reduced']}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[lm] phase_lm {out['wall_s']:.1f} s")
    return out


TRAIN_ARCH = "qwen2_0_5b"  # full width and depth: 24 layers, d_model 896, vocab 151,936, tied table
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 2048, 2, 4  # S = FLASH_MIN_SEQ: the blockwise path
TRAIN_SEED = 0
TRAIN_LM_ARCH = "mamba2_1_3b"  # the train_lm loop on an untied table, at its published config
TRAIN_LM = dict(steps=4, batch=4, seq=1024)
# depth cut: at 48 layers the loop's one checkpoint is 17.4 GB (params, m, v), and the loop
# took 42.7 s of a 104 s phase; the sparse embedding path depends on d_model and the vocab
TRAIN_LM_CUT = {"n_layers": 8}
RESTART_ARCH = "whisper_tiny"  # the restart leg's model, at its published config
RESTART_BATCH, RESTART_SEQ = 4, 448  # whisper's decoder context
RESTART_MAX_GB = 1.5  # the restart checkpoint (params, m, v) at most
TRAIN_REL = 1e-4  # the card's loss and gradients against the CPU port's, reduced archs, float32
BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bfloat16, NVIDIA data sheet (no sparsity)


def phase_train(torch, np):
    """LM training on the card (``launch.steps``, the losses, remat, the
    embedding gather's backward through ``scatter_add``, and the
    ``train_lm`` example's loop).

    (a) qwen2-0.5b at its published width and depth (float32 master
        weights, bfloat16 compute): ``make_train_step`` with two
        microbatches of 2 x 2048 (the blockwise attention path and its
        backward), remat, AdamW, 4 steps on one batch of ``TokenStream``'s
        Zipf(1.3) ids (``train_lm``'s traffic), timed; the loss
        falls and every gradient is finite; one step with top-k
        compression (``sparse + residual == g + old residual`` exactly);
        then the restart: whisper-tiny at its published config (its
        checkpoint 0.44 GB; qwen2-0.5b's is 5.93 GB, and its tied table
        alone 1.63 GB) trained 4 steps, a checkpoint after step 2 restored
        into fresh state and run to step 4 against the uninterrupted run;
    (b) one microbatch's gradient through the kernel and inside
        ``plain_versions()``, the table's bit-identical; ``scatter_add``
        alone at that shape, its live rows the microbatch's distinct ids;
    (c) the ``train_lm`` loop at mamba2-1.3b's published config (untied
        table, the hierarchical sparse embedding gradient): 4 steps of 4 x
        1024; ``dense_grad_of`` the last flushed rows through the kernel and
        inside ``plain_versions()`` bit-identical and equal to each token's
        count times its row of the dense gradient (ROADMAP C25); the
        checkpoint's cursor;
    (d) the ten architectures at ``reduced()`` size, float32: the card's
        ``train_loss`` and every gradient leaf against the CPU port's."""
    import dataclasses
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.analysis import flops
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import ARCH_IDS, get_config, reduced
    from repro_torch.examples import train_lm
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw, compression
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.data.tokens import TokenStream
    from repro_torch.sparse import hier_grad as HG
    from repro_torch.sparse import row_accum

    t_phase = time.perf_counter()
    out = {"legs_s": {}}

    def leg_done(name, t0=[t_phase]):
        now = time.perf_counter()
        out["legs_s"][name] = now - t0[0]
        t0[0] = now

    # ---- (a) make_train_step at full width
    cfg = get_config(TRAIN_ARCH)
    nbytes = tree_bytes(TF.init_params(None, cfg, device="meta"))
    fwd = flops.fwd_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    step_bytes = flops.train_bytes(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO)
    bound_ms = max(3 * fwd / BF16_PEAK_FLOPS, step_bytes / HBM_BYTES_PER_S) * 1e3
    log(f"[train] (a) {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab:,} (tied), "
        f"{cfg.dtype} compute; float32 weights {nbytes / 1e9:.2f} GB, + gradients, m and v "
        f"{4 * nbytes / 1e9:.2f} GB; batch {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO} microbatches, remat, "
        f"{TRAIN_STEPS} steps; no reductions")
    gen = torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED)
    state = ST.init_train_state(gen, cfg, DEVICE)
    # train_lm's traffic: TokenStream's Zipf(1.3) ids and next-token labels
    host = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=TRAIN_SEED).batch_at(0)
    batch = {k: torch.from_numpy(x).to(DEVICE) for k, x in host.items()}
    tokens, labels = batch["tokens"], batch["labels"]
    micro = TRAIN_BATCH // TRAIN_MICRO
    live = [int(np.unique(host["tokens"][i:i + micro]).size) for i in range(0, TRAIN_BATCH, micro)]
    log(f"[train] (a) batch: TokenStream (Zipf 1.3, seed {TRAIN_SEED}) step 0; distinct ids "
        f"{int(np.unique(host['tokens']).size):,} of {host['tokens'].size:,} tokens, a microbatch {live}")
    opt_cfg = adamw.AdamWConfig(warmup_steps=0)
    step = ST.make_train_step(cfg, opt_cfg, n_micro=TRAIN_MICRO, ep_axis=None)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, step_ms, gnorms = [], [], []
    s = state
    for t in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, m = step(s, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(launches["scatter_add"] == TRAIN_STEPS * TRAIN_MICRO,
          ("the gather's backward launches scatter_add once a microbatch", launches))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], ("loss finite and falling", losses))
    check(all(np.isfinite(gnorms)), ("every gradient finite (the global norm)", gnorms))
    steady = float(np.mean(step_ms[1:]))
    out["train_step"] = {
        "losses": losses, "grad_norms": gnorms, "step_ms": step_ms, "ms_per_step": steady,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady * 1e3,
        "model_flops": 3 * fwd, "mfu_bf16_dense_989T": 3 * fwd / (steady / 1e3) / BF16_PEAK_FLOPS,
        "bound_ms": bound_ms, "train_bytes": step_bytes, "peak_gb": peak, "weights_gb": nbytes / 1e9,
    }
    log(f"[train] (a) losses {losses}; steps {[round(x, 1) for x in step_ms]} ms (the first builds cuBLAS "
        f"plans); {steady:.1f} ms a step, {TRAIN_BATCH * TRAIN_SEQ / steady * 1e3:,.0f} tokens/s, "
        f"model FLOPs (3 x fwd_flops) {3 * fwd / 1e12:.2f} T: {out['train_step']['mfu_bf16_dense_989T']:.3f} of "
        f"the 989 TFLOP/s dense bfloat16 peak; bound {bound_ms:.2f} ms; peak memory {peak:.2f} GB; "
        f"launches {launches}")

    leg_done("a_steps")
    # restart: checkpoint after step 2, restore into fresh state, steps 3-4,
    # on whisper-tiny at its published config (qwen2-0.5b's tied table with
    # its two moments is 1.63 GB alone: no depth of it keeps the checkpoint
    # within RESTART_MAX_GB)
    rcfg = get_config(RESTART_ARCH)
    rbytes = tree_bytes(TF.init_params(None, rcfg, device="meta"))
    check(3 * rbytes <= RESTART_MAX_GB * 1e9, ("the restart checkpoint's size", 3 * rbytes))
    rgen = torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED)
    rstate = ST.init_train_state(rgen, rcfg, DEVICE)
    rhost = TokenStream(rcfg.vocab, RESTART_BATCH, RESTART_SEQ, seed=TRAIN_SEED).batch_at(0)
    rbatch = {k: torch.from_numpy(x).to(DEVICE) for k, x in rhost.items()}
    rbatch["frontend"] = torch.randn((RESTART_BATCH, rcfg.encoder_tokens, rcfg.d_model), generator=rgen,
                                     device=DEVICE) * 0.02
    rstep = ST.make_train_step(rcfg, opt_cfg, n_micro=TRAIN_MICRO, ep_axis=None)
    rs, mid = rstate, None
    for t in range(TRAIN_STEPS):
        rs, _ = rstep(rs, rbatch)
        if t == 1:
            mid = rs
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(2, mid, extra={"cursor": 2})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, extra = mgr.restore(mid)
        restore_s = time.perf_counter() - t0
    del mid
    r = TF.tree_map(lambda a: torch.from_numpy(a).to(DEVICE), restored)
    del restored
    check(extra["cursor"] == 2, ("checkpoint cursor", extra))
    for _ in range(extra["cursor"], TRAIN_STEPS):
        r, _ = rstep(r, rbatch)
    pairs = list(zip(tree_leaves(r), tree_leaves(rs)))
    restart_bits = all(torch.equal(a, b) for a, b in pairs)
    check(all(torch.allclose(a, b, rtol=1e-6, atol=0) for a, b in pairs), "restart within rtol 1e-6")
    del r, rs, rstate, pairs
    out["restart"] = {"arch": rcfg.name, "bit_identical": restart_bits, "save_s": save_s, "restore_s": restore_s,
                      "checkpoint_gb": 3 * rbytes / 1e9,
                      "reduced": {"arch": [TRAIN_ARCH, RESTART_ARCH], "checkpoint_gb": [3 * nbytes / 1e9,
                                                                                        3 * rbytes / 1e9]}}
    log(f"[train] (a) restart on {rcfg.name} ({rcfg.n_layers} + {rcfg.encoder_layers} encoder layers, d_model "
        f"{rcfg.d_model}, batch {RESTART_BATCH} x {RESTART_SEQ} and {rcfg.encoder_tokens} frames) after step 2: "
        f"steps 3-4 from the restored state {'bit-identical to' if restart_bits else 'within rtol 1e-6 of'} the "
        f"uninterrupted run; save {save_s:.1f} s, restore {restore_s:.1f} s ({3 * rbytes / 1e9:.2f} GB; reduced "
        f"from {TRAIN_ARCH}'s {3 * nbytes / 1e9:.2f} GB)")

    leg_done("a_restart")
    # ---- (b) one microbatch's gradient: the kernel against plain_versions()
    grad_fn = ST.value_and_grad(cfg, ep_axis=None)
    mb_tok, mb_lab = tokens[: TRAIN_BATCH // TRAIN_MICRO], labels[: TRAIN_BATCH // TRAIN_MICRO]
    zero_counts()
    # under torch.profiler (kernels only: a whole step's CPU operator
    # events took ~40 s to reduce on the host)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, g_k = grad_fn(s["params"], mb_tok, mb_lab, None)
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k_launches = read_counts()["scatter_add"]
    events = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    out["profile"] = {
        "what": f"one microbatch's value_and_grad, {mb_tok.shape[0]} x {mb_tok.shape[1]} tokens",
        "wall_ms": wall * 1e3, "host_queue_ms": queued * 1e3,
        "device_busy_ms": busy_ms if events else "not measured",
        "device_idle_share": 1 - busy_ms / (wall * 1e3) if events else "not measured",
        "top_kernels_ms": top_kernels(events, 8),
    }
    del prof, events
    log(f"[train] (b) one microbatch's value_and_grad under torch.profiler: {out['profile']}")
    zero_counts()
    with kernels.plain_versions():
        _, _, g_p = grad_fn(s["params"], mb_tok, mb_lab, None)
        torch.cuda.synchronize()
    p_launches = read_counts()["scatter_add"]
    check(k_launches == 1 and p_launches == 0, ("scatter_add launches: kernel 1, plain 0", k_launches, p_launches))
    table_k, table_p = g_k["embed"]["table"], g_p["embed"]["table"]
    check(torch.equal(table_k, table_p), "table gradient: kernel against plain_versions(), bit-identical")
    leaves_k = tree_leaves(g_k)
    check(all(bool(torch.isfinite(x).all()) for x in leaves_k), "every gradient leaf finite")
    all_bits = all(torch.equal(a, b) for a, b in zip(leaves_k, tree_leaves(g_p)))
    del g_p, table_p
    # the microbatch's ids and folded random bfloat16 rows, as the backward folds its cotangent
    ids = mb_tok.reshape(-1)
    folded = row_accum.from_pairs(ids, torch.randn((ids.shape[0], cfg.d_model), device=DEVICE).to(torch.bfloat16),
                                  cap=ids.shape[0])
    times = scatter_times(torch, np, folded.ids, folded.rows, int(folded.nnz), cfg.vocab_padded, "train")
    check(times["live"] == live[0], ("live rows equal the microbatch's distinct ids", times["live"], live))
    del folded
    out["gather_backward"] = {"table_bit_identical": True, "all_leaves_bit_identical": all_bits,
                              "rows": int(mb_tok.numel()), "table": [cfg.vocab_padded, cfg.d_model],
                              "scatter_add": times}
    log(f"[train] (b) one microbatch's table gradient, kernel against plain_versions(): bit-identical "
        f"(every leaf: {all_bits}); every leaf finite")

    # compression: sparse + residual == g + old residual, twice; one step
    comp = compression.CompressionConfig(enabled=True)
    res = compression.init_error_feedback(s["params"])
    t0 = time.perf_counter()
    for _ in range(2):
        sparse, new_res = compression.compress(g_k, res, comp)
        for a, b, g, r0 in zip(tree_leaves(sparse), tree_leaves(new_res), leaves_k, tree_leaves(res)):
            check(torch.equal(a + b, g.float() + r0), "compression: sparse + residual == g + old residual")
        res = new_res
    torch.cuda.synchronize()
    comp_ms = (time.perf_counter() - t0) / 2 * 1e3
    del sparse, new_res, g_k, leaves_k
    cstep = ST.make_train_step(cfg, opt_cfg, n_micro=TRAIN_MICRO, ep_axis=None, comp_cfg=comp)
    cs, cm = cstep({**s, "residual": res}, batch)
    check(set(cs) == {"params", "opt", "residual"} and np.isfinite(float(cm["loss"])), "a compressed step")
    out["compression"] = {"ms_per_compress": comp_ms, "loss": float(cm["loss"]),
                          "bytes_saved": compression.comm_bytes_saved(s["params"], comp)}
    del cs, cm, res, s, state, step, cstep
    free(torch)
    log(f"[train] (a) compression (top 1%): exact bookkeeping twice, {comp_ms:.1f} ms a compress, "
        f"one compressed step: loss {out['compression']['loss']:.4f}")

    leg_done("b_and_compression")
    # ---- (c) the train_lm loop at mamba2-1.3b's published config
    lcfg = dataclasses.replace(get_config(TRAIN_LM_ARCH), **TRAIN_LM_CUT)
    lbytes = tree_bytes(TF.init_params(None, lcfg, device="meta"))
    log(f"[train] (c) train_lm {lcfg.name}: {lcfg.n_layers} layers, d_model {lcfg.d_model}, vocab "
        f"{lcfg.vocab:,} (untied), float32 weights {lbytes / 1e9:.2f} GB, + gradients, m and v "
        f"{4 * lbytes / 1e9:.2f} GB; {TRAIN_LM}; --hier-embed-grad; reduced: {TRAIN_LM_CUT}")
    with tempfile.TemporaryDirectory(prefix="train_lm_ckpt_") as ckpt_dir:
        zero_counts()
        t0 = time.perf_counter()
        res = train_lm.train(lcfg, **TRAIN_LM, hier_embed_grad=True, ckpt_every=TRAIN_LM["steps"],
                             ckpt_dir=ckpt_dir, device=DEVICE)
        loop_s = time.perf_counter() - t0
        lm_launches = read_counts()
        with open(os.path.join(ckpt_dir, f"ckpt-{TRAIN_LM['steps']:09d}", "manifest.json")) as f:
            manifest = json.load(f)
    check(lm_launches["scatter_add"] == TRAIN_LM["steps"], ("train_lm: one scatter_add a step", lm_launches))
    check(all(np.isfinite(res["losses"])), ("train_lm losses", res["losses"]))
    check(res["cursor"] == manifest["extra"]["cursor"] == TRAIN_LM["steps"], ("cursor", manifest["extra"]))
    last = res["last"]
    v = last["emb_g"].shape[0]
    zero_counts()
    dense_k = HG.dense_grad_of(last["flushed"], v)
    n_k = read_counts()["scatter_add"]
    with kernels.plain_versions():
        dense_p = HG.dense_grad_of(last["flushed"], v)
    check(n_k == 1 and read_counts()["scatter_add"] == 1, "dense_grad_of: one launch, none inside plain_versions()")
    check(torch.equal(dense_k, dense_p), "dense_grad_of: kernel against plain_versions(), bit-identical")
    counts = torch.bincount(last["tokens"].reshape(-1).long(), minlength=v)[:, None].float()
    c25 = float((dense_k - counts * last["emb_g"]).abs().max() / last["emb_g"].abs().max())
    check(c25 <= 1e-5, ("C25: the accumulated rows are count x the dense gradient's", c25))
    out["train_lm"] = {"losses": res["losses"], "step_ms": res["step_ms"], "loop_s": loop_s,
                       "weights_gb": lbytes / 1e9, "reduced": TRAIN_LM_CUT, "cursor": res["cursor"], "c25_rel_err": c25,
                       "flushed_nnz": int(last["flushed"].nnz), "launches": lm_launches}
    log(f"[train] (c) train_lm: losses {res['losses']}, steps {[round(x, 1) for x in res['step_ms']]} ms, "
        f"loop {loop_s:.1f} s with its checkpoint; cursor {res['cursor']}; dense_grad_of bit-identical to "
        f"plain; C25 max error {c25:.2e} of max|row|; launches {lm_launches}")
    del res, last, dense_k, dense_p, counts
    free(torch)

    leg_done("c_train_lm")
    # ---- (d) the ten archs at reduced size: the card against the CPU port
    out["reduced"] = {}
    for arch in ARCH_IDS:
        rcfg = reduced(get_config(arch))  # float32
        gen = torch.Generator().manual_seed(TRAIN_SEED + 2)
        params = TF.init_params(gen, rcfg, "cpu")
        tok, fe = lm_inputs(torch, rcfg, gen, 2, 16, "cpu")
        lab = torch.cat([tok[:, 1:], torch.full((2, 1), -100, dtype=torch.int32)], 1)
        rfn = ST.value_and_grad(rcfg, ep_axis=None)
        want_loss, _, want = rfn(params, tok, lab, fe)
        dparams = TF.tree_map(lambda x: x.to(DEVICE), params)
        got_loss, _, got = rfn(dparams, tok.to(DEVICE), lab.to(DEVICE), None if fe is None else fe.to(DEVICE))
        loss_err = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
        worst = 0.0
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            check(bool(torch.isfinite(a).all()), (rcfg.name, "non-finite gradient on the card"))
            scale = float(b.abs().max())
            worst = max(worst, float((a.cpu() - b).abs().max()) / (scale if scale else 1.0))
        check(loss_err <= TRAIN_REL and worst <= TRAIN_REL, (rcfg.name, "card against CPU", loss_err, worst))
        out["reduced"][rcfg.name] = {"loss": loss_err, "grads": worst}
    log(f"[train] (d) reduced archs, card against CPU (loss, worst gradient leaf): {out['reduced']}")
    leg_done("d_reduced")
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[train] phase_train {out['wall_s']:.1f} s: {out['legs_s']}")
    return out


SHARD_MESH = (2, 2)  # (data, model): cuda:0 repeated (cuda:0..3 where there are four cards)
SHARD_LOSS_REL = 5e-3  # bfloat16 compute: the sharded step's loss against the unsharded step's
SHARD_LEAF_REL = 2.0 ** -5  # bfloat16: each first-moment leaf, of its max |value| (two correct orders differ by a few epsilons)
SHARD_FP32_REL = 1e-4  # the float32 legs: loss and each moment leaf
SHARD_FP32_CUT = {"n_layers": 4, "dtype": "float32"}  # qwen2-0.5b at full width, 4 of its 24 layers
SHARD_EP_ARCH = "phi3_5_moe"  # d_model 4096, 16 experts, top-2, d_expert 6400, vocab 32,064
SHARD_EP_BATCH, SHARD_EP_SEQ = 2, 2048  # one sequence a data shard at 2 x 2, two microbatches
SHARD_ASSOC = (512, 10_000)  # dryrun_assoc: the reference's 512 shards; group cut from 100,000


def live_shards(ST, rows: int, n: int) -> int:
    """The data shards that hold rows of a microbatch of ``rows`` split
    ``n`` ways as GSPMD splits it (the others hold its padding alone)."""
    lo, hi = ST.shard_rows(rows, n)
    return sum(1 for a, b in zip(lo, hi) if b > a)


def phase_shard(torch, np, legs=("a", "b", "e", "c")):
    """The sharded LM path on the card (``models/sharding.py``'s plans,
    ``launch.steps``' sharded step, the expert-parallel MoE, the dry run).

    (a) qwen2-0.5b at its published width and depth (bfloat16 compute over
        float32 master weights), ``train_lm``'s batch of 4 x 2048 tokens in
        two microbatches with remat, on a 2 x 2 ``(data, model)`` mesh of
        ``cuda:0``: one ZeRO-3 step ("fsdp_flat": four data shards) and one
        "tp" step (head-split compute over "model"; two data shards), each against
        the unsharded ``make_train_step`` under the same launch context on
        the same state (loss within 5e-3, each first-moment leaf within
        2^-5 of its max), timed beside it; the mesh's collectives equal
        ``dryrun.step_collectives``; ``scatter_add`` once a microbatch on
        each data shard that holds rows of it (a microbatch of 2 rows over
        4 data shards: two hold a row, two GSPMD's padding alone), under
        "tp" on each model shard of it; the ZeRO-3 step again inside
        ``plain_versions()``; then both at full width and 4 layers in
        float32 within 1e-4, and :func:`compression_leg`;
    (b) phi3.5-moe at full width (depth cut to fit with AdamW state) on
        ``TokenStream``'s Zipf(1.3) ids (``train_lm``'s traffic), 4 x 2048
        tokens in two microbatches: the expert-parallel MoE at
        ``data=1 x model=4`` against the local path on the first layer's
        input for those tokens, their embedding (load and dropped count
        exactly, output within 1e-4 in float32); one "ep" step at 1 x 4
        (head-split attention, the experts by ``moe._ep_shard``) and one
        "ep_fsdp" step at 2 x 2, their collectives equal to the formula;
    (e) head-split "tp" steps on 2 x 2 for the families (a) and (b)
        bypass: MLA, Mamba-2 and the local MoE path (:func:`tp_train_legs`);
    (c) the dry run's qwen2-0.5b ``train_4k`` cell at the production
        16 x 16 mesh under each strategy, and ``dryrun_assoc`` at 512
        shards (the group cut), its bytes printed first.

    Each sharded step runs after the unsharded one it is held to (one step
    each: the timing repeats were cut).  ``legs`` picks among "a", "b",
    "e" and "c"."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import dryrun_assoc as DA
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharding as SD
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves

    t_phase = time.perf_counter()
    out = {"legs_s": {}, "launches": {}, "steps": {}}

    def leg_done(name, t0=[t_phase]):
        now = time.perf_counter()
        out["legs_s"][name] = now - t0[0]
        t0[0] = now

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def rel(a, b) -> float:
        scale = float(b.abs().max())
        return float((a.float() - b.float()).abs().max()) / (scale if scale else 1.0)

    opt_cfg = adamw.AdamWConfig(warmup_steps=0)
    mesh = make_local_mesh(data=SHARD_MESH[0], model=SHARD_MESH[1], device=DEVICE)

    def sharded_leg(cfg, state, batch, strategy, tag, leaf_rel, loss_rel, n_micro=TRAIN_MICRO, keep=False):
        """One strategy on ``mesh`` against the unsharded step (same launch
        context, same state; ``state`` a state or a function making it
        afresh, which lets each step hold it alone): the unsharded step
        first, its loss and first moments kept on the host and its new
        state freed before the sharded step runs; the checks (each moment
        leaf gathered in turn), the times, the launches, the peak memory;
        with ``keep`` also the whole new state gathered, the placed state
        and the step."""
        seq = batch["tokens"].shape[1]
        made = state if callable(state) else (lambda: state)
        torch.cuda.reset_peak_memory_stats()
        with ST.strategy_context(mesh, strategy) as (plan, ep_axis):
            want_step = ST.make_train_step(cfg, opt_cfg, n_micro=n_micro, ep_axis=ep_axis)
            (want, wm), w_ms = timed(want_step, made(), batch)
            w_loss = float(wm["loss"])
            w_m = [x.cpu() for x in tree_leaves(want["opt"]["m"])]
            del want, wm
            free(torch)
            w_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            placed = ST.place_train_state(made(), cfg, mesh, plan)
            free(torch)
            bx = SD.batch_axes(cfg, mesh, plan)
            step = ST.make_train_step(cfg, opt_cfg, n_micro=n_micro, ep_axis=ep_axis, dp_spec=bx)
            split = ST.head_split(mesh, bx)
            mesh.reset_collectives()
            zero_counts()
            (new, m), s_ms = timed(step, placed, batch)
            launches = read_counts()
            counted = dict(mesh.collectives), dict(mesh.collective_bytes)
        s_peak = torch.cuda.max_memory_allocated()
        d = mesh.axis_size(bx)
        live = live_shards(ST, batch["tokens"].shape[0] // n_micro, d)
        per = mesh.shape["model"] if split else 1  # head-split: each model shard's vocabulary block
        per *= 2 if cfg.mtp_depth else 1  # the MTP block gathers the shifted tokens' embedding too
        check(launches["scatter_add"] == live * n_micro * per,
              (tag, "scatter_add once a data shard holding rows (and model shard) a microbatch and gather",
               launches, d, live, n_micro, per))
        check(counted == DR.step_collectives(cfg, mesh, strategy, n_micro, batch["tokens"].shape[0], seq),
              (tag, "the mesh's collectives equal the dry run's formula", counted))
        loss_err = abs(float(m["loss"]) - w_loss) / abs(w_loss)
        worst = 0.0
        for sh, want_m in zip(tree_leaves(new["opt"]["m"]), w_m):
            got_m = sh.gather()
            worst = max(worst, rel(got_m, want_m.to(got_m.device)))
            del got_m
        check(all(bool(torch.isfinite(b).all()) for sh in tree_leaves(new["params"]) for b in sh.shards),
              (tag, "finite params"))
        check(loss_err <= loss_rel and worst <= leaf_rel, (tag, "sharded against unsharded", loss_err, worst))
        res = {"strategy": strategy, "mesh": dict(mesh.shape), "head_split": split, "data_shards": d,
               "data_shards_with_rows": live, "loss": float(m["loss"]), "unsharded_loss": w_loss,
               "loss_rel_err": loss_err, "worst_moment_leaf_rel_err": worst, "sharded_ms": [s_ms],
               "unsharded_ms": [w_ms], "collectives": counted[0], "collective_bytes": counted[1],
               "launches": launches, "peak_gb": {"unsharded": w_peak / 1e9, "sharded": s_peak / 1e9}}
        log(f"[shard] {tag}: loss {float(m['loss']):.5f} (unsharded {w_loss:.5f}, rel {loss_err:.2e}); "
            f"worst moment leaf {worst:.2e}; sharded {s_ms:.1f} ms against unsharded {w_ms:.1f} ms; collectives "
            f"{counted[0]} ({counted[1]} bytes a device); launches {launches}; peak {w_peak / 1e9:.2f} GB "
            f"unsharded, {s_peak / 1e9:.2f} GB sharded")
        if not keep:
            return res, None, None, None
        return res, ST.gather_train_state(new), placed, step

    if "a" in legs:
        # ---- (a) qwen2-0.5b at full width and depth
        cfg = get_config(TRAIN_ARCH)
        host = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=TRAIN_SEED).batch_at(0)
        batch = {k: torch.from_numpy(x).to(DEVICE) for k, x in host.items()}
        state = ST.init_train_state(torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED), cfg, DEVICE)
        nbytes = tree_bytes(state["params"])
        log(f"[shard] (a) {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype} compute over "
            f"{nbytes / 1e9:.2f} GB of float32 weights; batch {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO} "
            f"microbatches, remat; mesh {mesh.shape} of {mesh.device_list[0]}; no reductions")
        for strategy in ("fsdp_flat", "tp"):
            res, got, placed, step = sharded_leg(cfg, state, batch, strategy, f"(a) {strategy}", SHARD_LEAF_REL,
                                                 SHARD_LOSS_REL, keep=strategy == "fsdp_flat")
            out["steps"][strategy] = res
            out["launches"][f"shard_{strategy}"] = res["launches"]
            if strategy == "fsdp_flat":  # the path inside plain_versions()
                with ST.strategy_context(mesh, strategy):
                    zero_counts()
                    with kernels.plain_versions():
                        plain, _ = step(placed, batch)
                        torch.cuda.synchronize()
                    p_launches = read_counts()
                check(sum(p_launches.values()) == 0, ("no launch inside plain_versions()", p_launches))
                plain = ST.gather_train_state(plain)
                pairs = list(zip(tree_leaves(got), tree_leaves(plain)))
                bits = all(torch.equal(a, b) for a, b in pairs)
                check(all(torch.allclose(a, b, rtol=1e-6, atol=0) for a, b in pairs),
                      "(a) fsdp_flat: the kernels against plain_versions(), within rtol 1e-6")
                res["plain_versions_bit_identical"] = bits
                log(f"[shard] (a) fsdp_flat inside plain_versions(): "
                    f"{'bit-identical to' if bits else 'within rtol 1e-6 of'} the kernels' step")
                del plain, pairs
            del got, placed, step
            free(torch)
        del state
        free(torch)
        leg_done("a_bf16")
        fcfg = dataclasses.replace(cfg, **SHARD_FP32_CUT)
        fstate = ST.init_train_state(torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED), fcfg, DEVICE)
        out["launches"]["shard_fp32"] = {}
        for strategy in ("fsdp_flat", "tp"):
            res, got, placed, step = sharded_leg(fcfg, fstate, batch, strategy, f"(a) float32 {strategy}",
                                                 SHARD_FP32_REL, SHARD_FP32_REL)
            out["steps"][f"float32_{strategy}"] = res
            for k, v in res["launches"].items():
                out["launches"]["shard_fp32"][k] = out["launches"]["shard_fp32"].get(k, 0) + v
            del got, placed, step
        leg_done("a_fp32")
        out["compression"], out["launches"]["shard_compress"] = compression_leg(
            torch, np, ST, SD, DR, mesh, fcfg, fstate, batch, opt_cfg, timed)
        del fstate
        free(torch)
        leg_done("a_compress")

    if "b" in legs:
        # ---- (b) phi3.5-moe at full width: expert parallelism
        ecfg = get_config(SHARD_EP_ARCH)
        total = torch.cuda.get_device_properties(0).total_memory
        for layers in (2, 1):
            pb = tree_bytes(TF.init_params(None, dataclasses.replace(ecfg, n_layers=layers), device="meta"))
            # the placed params, m and v, the new ones, two data shards' float32
            # gradients, the gathered weights, and room to run
            need = 9 * pb + 8e9
            if need <= total:
                break
        ecfg = dataclasses.replace(ecfg, n_layers=layers)
        log(f"[shard] (b) {ecfg.name}: d_model {ecfg.d_model}, {ecfg.moe.n_experts} experts, top-{ecfg.moe.top_k}, "
            f"d_expert {ecfg.moe.d_expert}, vocab {ecfg.vocab:,}; float32 weights {pb / 1e9:.2f} GB at {layers} "
            f"layer(s) (needs {need / 1e9:.1f} of {total / 1e9:.1f} GB with AdamW state and two data shards' "
            f"gradients); reduced: n_layers {get_config(SHARD_EP_ARCH).n_layers} -> {layers}")

        def fresh():
            return ST.init_train_state(torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED), ecfg, DEVICE)

        # train_lm's traffic: TokenStream's Zipf(1.3) ids, as leg (a) and phase_train take
        ehost = TokenStream(ecfg.vocab, 2 * SHARD_EP_BATCH, SHARD_EP_SEQ, seed=TRAIN_SEED).batch_at(0)
        ebatch = {k: torch.from_numpy(v).to(DEVICE) for k, v in ehost.items()}
        distinct = int(torch.unique(ebatch["tokens"]).numel())
        estate = fresh()
        eplan = TF.build_plan(ecfg)
        si, gi = next((si, gi) for si, st in enumerate(eplan) for gi, g in enumerate(st.specs) if g.has_moe)
        moe_p = estate["params"]["stages"][si][gi]["moe"]  # the first MoE layer's
        if eplan[si].reps > 1:
            moe_p = TF.layer_of(moe_p, 0)
        with torch.no_grad():
            # the first layer's input for the step's tokens: their embedding, in float32
            x = L.embed_tokens(estate["params"]["embed"], ecfg, ebatch["tokens"], torch.float32)
            want, waux = MOE.apply_moe(moe_p, ecfg, x, ep_axis=None)
            emesh = make_local_mesh(data=1, model=4, device=DEVICE)
            MOE.EP_CONTEXT.update(mesh=emesh, dp="data")
            try:
                got_out, gaux = MOE.apply_moe(moe_p, ecfg, x, ep_axis="model")
            finally:
                MOE.EP_CONTEXT.update(mesh=None, dp=None)
        ep_err = rel(got_out, want)
        check(torch.equal(gaux["expert_load"], waux["expert_load"]), "(b) EP load equals the local path's")
        check(int(gaux["moe_dropped"]) == int(waux["moe_dropped"]), "(b) EP dropped count equals the local path's")
        check(ep_err <= SHARD_FP32_REL, ("(b) EP output against the local path", ep_err))
        n_tok = x.shape[0] * x.shape[1]
        out["ep_vs_local"] = {"rel_err": ep_err, "expert_load": waux["expert_load"].tolist(),
                              "moe_dropped": int(waux["moe_dropped"]), "tokens": n_tok, "distinct_ids": distinct,
                              "assignments": n_tok * ecfg.moe.top_k}
        log(f"[shard] (b) EP at 1 x 4 against the local path on the embedding of {2 * SHARD_EP_BATCH} x "
            f"{SHARD_EP_SEQ} TokenStream tokens ({distinct:,} distinct ids of {ecfg.vocab:,}), float32: output within "
            f"{ep_err:.2e} of its max; load {out['ep_vs_local']['expert_load']} and dropped "
            f"{out['ep_vs_local']['moe_dropped']} of {n_tok * ecfg.moe.top_k} assignments equal")
        del got_out, want, x, estate, moe_p
        free(torch)
        for strategy, (dd, mm) in (("ep", (1, 4)), ("ep_fsdp", (2, 2))):
            smesh = make_local_mesh(data=dd, model=mm, device=DEVICE)
            with ST.strategy_context(smesh, strategy) as (plan, ep_axis):
                estate = fresh()
                placed = ST.place_train_state(estate, ecfg, smesh, plan)
                del estate  # the placed copy alone
                bx = SD.batch_axes(ecfg, smesh, plan)
                step = ST.make_train_step(ecfg, opt_cfg, n_micro=TRAIN_MICRO, ep_axis=ep_axis, dp_spec=bx)
                split = ST.head_split(smesh, bx)
                smesh.reset_collectives()
                zero_counts()
                (new, m), ms = timed(step, placed, ebatch)
                launches = read_counts()
            counted = dict(smesh.collectives), dict(smesh.collective_bytes)
            live = live_shards(ST, 2 * SHARD_EP_BATCH // TRAIN_MICRO, smesh.axis_size(bx))
            per = smesh.shape["model"] if split else 1
            check(launches["scatter_add"] == live * TRAIN_MICRO * per, (strategy, "scatter_add", launches, per))
            check(counted == DR.step_collectives(ecfg, smesh, strategy, TRAIN_MICRO, 2 * SHARD_EP_BATCH, SHARD_EP_SEQ),
                  (strategy, "collectives equal the formula", counted))
            check(np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])), (strategy, "finite loss", m))
            out["steps"][strategy] = {"mesh": dict(smesh.shape), "head_split": split, "loss": float(m["loss"]), "ms": ms,
                                      "collectives": counted[0], "collective_bytes": counted[1], "launches": launches}
            out["launches"][f"shard_{strategy}"] = launches
            log(f"[shard] (b) {strategy} step at {smesh.shape}: loss {float(m['loss']):.4f}, {ms:.1f} ms, collectives "
                f"{counted[0]}, launches {launches}")
            del placed, new, step
            free(torch)
        leg_done("b_ep")

    if "e" in legs:
        tp_train_legs(torch, out, sharded_leg, leg_done)
    if "c" in legs:
        # ---- (c) the dry run at the production mesh, and dryrun_assoc
        pmesh = make_production_mesh(device=DEVICE)
        out["dryrun"] = {}
        for strategy in ST.STRATEGIES:
            cell = DR.plan_cell(TRAIN_ARCH, "train_4k", pmesh, strategy)
            r = cell["roofline"]
            out["dryrun"][strategy] = {"memory": cell["memory"], "n_micro": cell["n_micro"],
                                       "collectives": cell["collectives"]["calls"],
                                       "collective_bytes": cell["collectives"]["bytes"],
                                       "t_compute_ms": r["t_compute_s"] * 1e3, "t_memory_ms": r["t_memory_s"] * 1e3,
                                       "t_collective_ms": r["t_collective_s"] * 1e3, "bottleneck": r["bottleneck"],
                                       "executor_only": cell["executor_only"]}
            log(f"[shard] (c) dry run {TRAIN_ARCH} train_4k at {pmesh.shape} under {strategy}: "
                f"{json.dumps(out['dryrun'][strategy])}")
        zero_counts()
        d, g = SHARD_ASSOC
        assoc = DA.run(d, g, DEVICE, log=lambda s: log(f"[shard] (c) dryrun_assoc {s}"))
        a_launches = read_counts()
        par, sh = assoc[f"parallel_hier_{d}"], assoc[f"sharded_assoc_{d}"]
        check(par["update_path_collective_free"], ("(c) the paper design's update holds no collective", par))
        check(sh["routes_via_all_to_all"], ("(c) ShardedAssoc routes by all-to-all", sh))
        check(a_launches["hier_cascade"] + a_launches["sort_dedup"] > 0, ("(c) dryrun_assoc's kernels", a_launches))
        out["dryrun_assoc"] = {**assoc, "reduced": {"group": [100_000, g]}, "launches": a_launches}
        out["launches"]["shard_assoc"] = a_launches
        log(f"[shard] (c) dryrun_assoc at D={d}, group {g} (cut from 100,000): parallel {par['collectives']} "
            f"in {par['update_s']:.2f} s, sharded {sh['collectives']} in {sh['update_s']:.2f} s, dropped "
            f"{sh['dropped']}; launches {a_launches}")
        free(torch)
        leg_done("c_dryrun")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[shard] phase_shard {out['wall_s']:.1f} s: {out['legs_s']}")
    return out


# (e): head-split "tp" training for the families (a) and (b) bypass, at
# published width, depth cut to fit with AdamW state (arch, the cuts tried
# in order, the first whose estimate fits taken)
SHARD_TP_LEGS = (
    ("deepseek_v3", ({"n_layers": 1, "first_dense": 1}, {"n_layers": 1, "first_dense": 1, "mtp_depth": 0})),
    ("mamba2_1_3b", ({"n_layers": 4},)),
    ("phi3_5_moe", ({"n_layers": 1},)),
)
# the larger step's peak, in float32 weights: the unsharded step's params,
# m, v, gradients and new state (the sharded step's, with one placed copy of
# the state, is below it)
SHARD_TP_STATE = 7


def tp_train_legs(torch, out, sharded_leg, leg_done):
    """``phase_shard``'s (e): a head-split "tp" step on the 2 x 2 mesh
    against the unsharded step for deepseek-v3 (MLA heads split, one dense
    layer and its MTP block where the bytes allow), mamba2-1.3b (state
    heads and conv channels split, 4 of 48 layers) and phi3.5-moe (1 of 32
    layers: the local MoE path over two data shards, ``moe.ShardStats``'
    gradient-free first pass), each at published width, bfloat16 compute
    over float32 master weights, ``TokenStream`` Zipf(1.3) tokens in two
    microbatches, remat and AdamW.  The unsharded step runs first and is
    freed (``sharded_leg``); ``scatter_add`` launches once a microbatch on
    each model shard's vocabulary block."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF

    total = torch.cuda.get_device_properties(0).total_memory
    for arch, cuts in SHARD_TP_LEGS:
        full = get_config(arch)
        for cut in cuts:
            cfg = dataclasses.replace(full, **cut)
            pb = tree_bytes(TF.init_params(None, cfg, device="meta"))
            need = SHARD_TP_STATE * pb + 8e9
            if need <= total:
                break
        check(need <= total, (arch, "no depth cut fits", need, total))
        reduced = {k: [getattr(full, k), v] for k, v in cut.items()}
        log(f"[shard] (e) {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab:,}; float32 "
            f"weights {pb / 1e9:.2f} GB (needs about {need / 1e9:.1f} of {total / 1e9:.1f} GB: the unsharded "
            f"step's state, gradients and new state); reduced: {reduced}")
        host = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=TRAIN_SEED).batch_at(0)
        batch = {k: torch.from_numpy(x).to(DEVICE) for k, x in host.items()}

        def fresh(cfg=cfg):
            return ST.init_train_state(torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED), cfg, DEVICE)

        tag = f"(e) tp {arch}"
        res, got, placed, step = sharded_leg(cfg, fresh, batch, "tp", tag, SHARD_LEAF_REL, SHARD_LOSS_REL)
        check(res["head_split"], (tag, "head-split"))
        res.update(reduced=reduced, weights_gb=pb / 1e9)
        out["steps"][f"tp_{arch}"] = res
        out["launches"][f"shard_tp_{arch}"] = res["launches"]
        del got, placed, step, batch
        free(torch)
        leg_done(f"e_{arch}")


def compression_leg(torch, np, ST, SD, DR, mesh, cfg, state, batch, opt_cfg, timed):
    """Top-k compression of a sharded step (``make_train_step(comp_cfg=,
    dp_spec=)``), float32: (1) ``steps.compress_blocks`` over the unsharded
    step's ``g`` and a seeded residual placed by "tp" on ``mesh`` against
    ``compression.compress`` on the whole leaves: bit-identical, ``sparse +
    residual == g + r`` exactly; (2) one "tp" step with compression
    against the unsharded compressed step: loss and moments within 1e-4,
    the kept entries equal except within 1e-6 (of the leaf's max ``|g +
    r|``) of a leaf's threshold, the collectives (the thresholds'
    all-gathers) equal to the formula."""
    from repro_torch.core.mesh import device_put
    from repro_torch.optim import compression
    from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

    comp = compression.CompressionConfig(enabled=True)
    gen = torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED + 1)
    residual = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=DEVICE) * 1e-3, state["params"])
    params = state["params"]
    tokens, labels = batch["tokens"], batch["labels"]
    mb = tokens.shape[0] // TRAIN_MICRO
    vg = ST.value_and_grad(cfg, None)
    g = None  # the unsharded step's gradient: the microbatches' mean
    for i in range(TRAIN_MICRO):
        _, _, gi = vg(params, tokens[i * mb:(i + 1) * mb], labels[i * mb:(i + 1) * mb], None)
        g = gi if g is None else tree_unflatten(params, [a + b for a, b in zip(tree_leaves(g), tree_leaves(gi))])
    g = tree_map(lambda x: x / TRAIN_MICRO, g)
    want_s, want_r = compression.compress(g, residual, comp)
    specs = SD.shardings_of(mesh, SD.param_specs(cfg, mesh, params, "tp"))
    gs, rs = device_put(g, specs, copy=True, pad=True), device_put(residual, specs, copy=True, pad=True)
    named = ST._named_leaves(gs)
    sparse, res = ST.compress_blocks(mesh, named, [list(sh.shards) for _, sh in named], ST._named_leaves(rs), comp)
    exact = True
    for (_, sh), s_blocks, r_sh, ws, wr, gg, rr in zip(named, sparse, res, tree_leaves(want_s), tree_leaves(want_r),
                                                       tree_leaves(g), tree_leaves(residual)):
        got_s = ST.Sharded(sh.sharding, tuple(s_blocks), sh.shape).gather()
        got_r = r_sh.gather()
        exact &= bool(torch.equal(got_s, ws) and torch.equal(got_r, wr) and torch.equal(got_s + got_r, gg + rr))
    check(exact, "(a) compression: compress_blocks over the blocks is compress over the leaves, sparse + r exact")
    del gs, rs, sparse, res, want_s, want_r

    cstate = dict(state, residual=residual)
    with ST.strategy_context(mesh, "tp") as (plan, ep_axis):
        (want, wm), w_ms = timed(ST.make_train_step(cfg, opt_cfg, n_micro=TRAIN_MICRO, ep_axis=ep_axis,
                                                    comp_cfg=comp), cstate, batch)
        placed = ST.place_train_state(cstate, cfg, mesh, plan)
        step = ST.make_train_step(cfg, opt_cfg, n_micro=TRAIN_MICRO, ep_axis=ep_axis, comp_cfg=comp,
                                  dp_spec=SD.batch_axes(cfg, mesh, plan))
        mesh.reset_collectives()
        zero_counts()
        (new, m), s_ms = timed(step, placed, batch)
        launches = read_counts()
        counted = dict(mesh.collectives), dict(mesh.collective_bytes)
    check(counted == DR.step_collectives(cfg, mesh, "tp", TRAIN_MICRO, tokens.shape[0], tokens.shape[1],
                                         comp_cfg=comp), ("(a) compression: collectives equal the formula", counted))
    loss_err = abs(float(m["loss"]) - float(wm["loss"])) / abs(float(wm["loss"]))
    got = ST.gather_train_state(new)
    worst = 0.0
    for a, b in zip(tree_leaves(got["opt"]["m"]), tree_leaves(want["opt"]["m"])):
        worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    mism = near = 0
    for (names, _), gr, wr, gg, rr in zip(ST._named_leaves(params), tree_leaves(got["residual"]),
                                          tree_leaves(want["residual"]), tree_leaves(g), tree_leaves(residual)):
        y = gg + rr
        if y.numel() < comp.min_size:
            continue
        k = max(1, int(y.numel() * comp.top_k_frac))
        thresh = torch.topk(y.abs().reshape(-1), k).values[-1]
        # the two steps' gradients differ in float32's last places: an entry
        # within 1e-6 of the leaf's max |g + r| of the threshold may fall
        # either way; a kept entry is one whose new residual is 0, which
        # tells kept from dropped only where |g + r| is not ~0
        scale = float(y.abs().max())
        sure = ((y.abs() - thresh).abs() > 1e-6 * scale) & (y.abs() > 1e-6 * scale)
        bad = ((gr != 0) != (wr != 0)) & sure
        if bad.any():
            both = (gr != 0) & (wr != 0)  # dropped by both: each residual is its own step's g + r
            noise = float((gr - wr)[both].abs().max()) if both.any() else float("nan")
            idx = bad.nonzero()[:4].tolist()
            log(f"[shard] (a) compression: {'/'.join(names)}: {int(bad.sum())} masks differ; threshold "
                f"{float(thresh):.6e}, max |g + r| {scale:.6e}, g + r noise between the steps {noise:.3e}; "
                f"entries {[(i, float(y[tuple(i)]), float(gr[tuple(i)]), float(wr[tuple(i)])) for i in idx]}")
        mism += int(bad.sum())
        near += int((~sure).sum())
    check(loss_err <= SHARD_FP32_REL and worst <= SHARD_FP32_REL and mism == 0,
          ("(a) compression: the sharded compressed step against the unsharded one", loss_err, worst, mism))
    out = {"sparse_plus_residual_exact": exact, "loss": float(m["loss"]), "unsharded_loss": float(wm["loss"]),
           "loss_rel_err": loss_err, "worst_moment_leaf_rel_err": worst, "mask_mismatches_away_from_threshold": mism,
           "entries_within_1e-6_of_a_threshold": near, "sharded_ms": s_ms, "unsharded_ms": w_ms,
           "collectives": counted[0], "collective_bytes": counted[1], "launches": launches}
    log(f"[shard] (a) compression, float32 at {cfg.n_layers} layers: loss {float(m['loss']):.5f} (unsharded "
        f"{float(wm['loss']):.5f}); worst moment leaf {worst:.2e}; masks equal away from the thresholds "
        f"({near} entries within 1e-6 of a leaf's max of one); sparse + residual exact; {s_ms:.1f} ms against {w_ms:.1f} ms; "
        f"all-gathers {counted[0]['all-gather']}")
    del want, new, placed, got, g, residual, cstate
    return out, launches


EXAMPLES_DEVICES = 4  # streaming_analytics' default: the mesh engine over cuda:0 repeated on one card


def phase_examples(torch, np):
    """The port's D4M examples on the card, each through the kernels and
    again inside ``plain_versions()``: ``quickstart`` (the algebra, the
    ``single`` cascade, the query namespace: ``sort_dedup`` and
    ``merge_add``) and ``streaming_analytics --devices 4`` (the mesh
    engine: ``sort_dedup`` and ``hier_cascade``; two checkpoints and the
    restore drill, which the example checks).  Snapshots, top-k and
    cascade counters bit-identical; the examples' own output goes to
    stderr."""
    from repro_torch import kernels
    from repro_torch.examples import quickstart, streaming_analytics

    def same(a, b, what):
        if isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{what}.{k}")
        elif isinstance(a, (tuple, list)) and a and isinstance(a[0], np.ndarray):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{what}[{i}]")
        elif isinstance(a, np.ndarray):
            check(a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8)), (what, "bit-identical"))
        elif not isinstance(a, float):  # rates and walls differ from run to run
            check(a == b, (what, a, b))

    runs = {
        "quickstart": (lambda: quickstart.run(DEVICE), ("sort_dedup", "merge_add")),
        "streaming_analytics": (lambda: streaming_analytics.run(DEVICE, devices=EXAMPLES_DEVICES),
                                ("sort_dedup", "hier_cascade")),
    }
    out = {"launches": {}}
    for name, (fn, need) in runs.items():
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            got = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        check(all(launches[k] > 0 for k in need), (name, "launches its kernels", launches))
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr), kernels.plain_versions():
            plain = fn()
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
        check(sum(read_counts().values()) == 0, (name, "no launch inside plain_versions()"))
        same({k: v for k, v in got.items() if k != "rate"}, plain, name)
        out[name] = {"wall_s": wall, "plain_wall_s": p_wall, "launches": launches,
                     **{k: got[k] for k in ("kind", "cascades") if k in got},
                     **({"rate": got["rate"], "plain_rate": plain["rate"], "updates": got["updates"],
                         "drill": got["drill"]} if "rate" in got else {}),
                     "snapshot_nnz": int(got["snapshot"][0].size)}
        out["launches"][f"example_{name}"] = launches
        log(f"[examples] {name}: {wall:.2f} s (plain_versions() {p_wall:.2f} s), launches {launches}; "
            f"bit-identical inside plain_versions(): snapshot ({out[name]['snapshot_nnz']:,} entries), top-k, "
            f"cascades {out[name].get('cascades')}")
    return out


SERVE_ARCH = "h2o_danube3_4b"  # published width and depth: 24 layers, d_model 3840, 32/8 heads, SWA 4096
SERVE_MESH = (2, 2)  # (data, model) of cuda:0, "tp"
# (cell, batch, cache capacity, first position): decode_32k with its batch
# cut from 128 to 16, and long_500k (batch 1: the slot axis over "data")
SERVE_DECODE = (("decode_32k", 16, 32768, 32640), ("long_500k", 1, 524288, 524160))
SERVE_STEPS = 8  # cut from 16
SERVE_PREFILL = (2, 4096)  # prefill_32k cut from 32 x 32,768
SERVE_BF16_REL = 2.0 ** -5  # bfloat16 logits and cache slots, of max |value|
SERVE_FP32_REL = 1e-4
SERVE_FP32_CUT = {"n_layers": 4, "dtype": "float32"}  # the same legs at 4 of 24 layers in float32
SERVE_FP32_STEPS = 4
SERVE_SEED = 0
# (d5)-(d7): the head-split serve paths (d1)-(d3) bypass, each at its
# published width; the KV caches 4,096-slot rings from the seed
SERVE_RING = (4096, 32640)  # slots, first decoded position
SERVE_SPLIT_STEPS = 8
SERVE_SEQ_STEPS = 2  # batch 1 on the sequence-parallel branch
SERVE_MLA_ARCH = "deepseek_v3"  # 128 heads, kv_lora_rank 512, vocab 129,280
SERVE_MLA_CUT = {"n_layers": 3, "first_dense": 3}  # its dense layers (no routed experts), as phase_lm's leg
SERVE_SSM_ARCH = "mamba2_1_3b"  # 48 layers, 64 state heads, 4,352 conv channels
SERVE_KV_ARCH = "qwen2_0_5b"  # 14 query heads, 2 KV heads of 64
SERVE_KV_MESHES = (((2, 4), "hd"), ((2, 3), "q"))  # (data, model): head_dim in blocks of 16; query heads 5/5/4


def phase_shard_serve(torch, np, legs=("d", "split", "d4")):
    """Sharded serving on the card (``launch.steps.place_serve_state``,
    ``make_serve_step``/``make_prefill_step`` over a mesh: heads split
    over "model", ``serving.sharded_decode_step``/``sharded_prefill``).

    h2o-danube3-4b at its published width and depth (float32 master
    weights made on the card from a seed, bfloat16 compute) on a 2 x 2
    ``(data, model)`` mesh of ``cuda:0``, "tp", each leg's bytes printed
    from ``device="meta"`` first:

    (d1) ``decode_32k``-shaped decode at batch 16 (cut from 128): a
         4,096-slot ring a layer filled from the seed (random bfloat16 K/V,
         ``kpos`` the positions 28,544-32,639), 8 greedy steps (cut from
         16) from position 32,640, the batch over "data" and the KV heads
         over "model", against the unsharded ``make_serve_step`` on an
         equal copy of the cache (both fed the unsharded step's greedy
         tokens);
    (d2) ``long_500k`` decode, batch 1: the slot axis over "data" (the
         sequence-parallel branch), positions 520,064-524,159 in the ring,
         8 steps from 524,160, compared the same way;
    (d3) ``make_prefill_step`` on 2 x 4,096 ``TokenStream`` tokens (cut
         from 32 x 32,768), the last position's logits against unsharded;
    then the three legs again in float32 at 4 of the 24 layers;
    (d5)-(d7) head-split MLA (absorbed and naive), Mamba-2, FSDP rows
         under "tp" and the "hd" and "q" cache splits (:func:`split_legs`);
    (d4) the dry run's serve cells: ``plan_cell`` for the ten archs x
         ``prefill_32k``, ``decode_32k``, ``long_500k`` at 16 x 16 with the
         sharded steps' collectives.

    Checks: logits within 2^-5 (bfloat16) or 1e-4 (float32) of max
    |logit|; each greedy token equal wherever the unsharded step's top-two
    margin exceeds that tolerance; the written cache slots within it,
    ``kpos`` and ``pos`` exact; each step's collectives equal
    ``dryrun.serve_collectives``; every logits block on the card.
    ``legs`` picks among "d" ((d1)-(d3)), "split" ((d5)-(d7)) and "d4"."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import shapes as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.models import serving as SV
    from repro_torch.models import transformer as TF

    t_phase = time.perf_counter()
    out = {"legs_s": {}, "legs": {}}

    def leg_done(name, t0=[t_phase]):
        now = time.perf_counter()
        out["legs_s"][name] = now - t0[0]
        t0[0] = now

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def rel(a, b) -> float:
        return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)

    mesh = make_local_mesh(data=SERVE_MESH[0], model=SERVE_MESH[1], device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    on = torch.device(DEVICE).type

    def ring_cache(c, batch, cap, pos0):
        """A decode cache as a ring after ``pos0`` tokens: K/V from the
        seed, ``kpos`` the positions each slot holds, ``pos`` = pos0."""
        cache = SV.init_cache(c, batch, cap, TF.compute_dtype(c), DEVICE)
        for names, leaf in ST._named_leaves(cache):
            if names[-1] == "pos":
                leaf.fill_(pos0)
            elif names[-1] == "kpos":
                t = torch.arange(leaf.shape[-1], device=DEVICE)
                last = pos0 - 1 - (pos0 - 1 - t) % leaf.shape[-1]
                leaf.copy_(torch.where(last >= 0, last, -1).to(torch.int32).expand_as(leaf))
            else:
                leaf.normal_(0.0, 0.5, generator=gen)
        return cache

    def decode_leg(c, params, cell, batch, cap, pos0, steps, tol, tag, mesh=mesh):
        gen.manual_seed(SERVE_SEED)
        want = ring_cache(c, batch, cap, pos0)
        src = TF.tree_map(lambda x: x.clone(), want)  # an equal copy; placed by views, written in place
        tok = torch.randint(0, c.vocab, (batch, 1), generator=gen, device=DEVICE, dtype=torch.int32)
        s_ms, u_ms, errs, counted = [], [], [], None
        n_tok = n_cmp = 0
        with ST.strategy_context(mesh, "tp") as (plan, ep_axis):
            pp, pc = ST.place_serve_state(params, src, c, mesh, plan)
            placed = ST.placed_bytes(pc)
            sstep, ustep = ST.make_serve_step(c, ep_axis), ST.make_serve_step(c, ep_axis)
            for t in range(steps):
                (w, want), ums = timed(ustep, params, want, tok)
                mesh.reset_collectives()
                (g, pc), sms = timed(sstep, pp, pc, tok)
                if counted is None:
                    counted = dict(mesh.collectives), dict(mesh.collective_bytes)
                check(all(b.device.type == on for b in g.shards), (tag, "every logits block on the card"))
                gl = g.gather()
                errs.append(rel(gl, w))
                wv, gv = w[:, -1, : c.vocab].float(), gl[:, -1, : c.vocab].float()
                top2 = wv.topk(2, dim=-1).values
                margin = (top2[:, 0] - top2[:, 1]) / wv.abs().max()
                decided = margin > tol
                nxt = wv.argmax(-1)
                n_tok += int(decided.sum())
                n_cmp += int((decided & (gv.argmax(-1) == nxt)).sum())
                s_ms.append(sms)
                u_ms.append(ums)
                tok = nxt[:, None].to(torch.int32)
        shape = SH.ShapeSpec(cell, "decode", cap, batch)
        check(counted == DR.serve_collectives(c, mesh, "tp", shape),
              (tag, "the mesh's collectives equal the dry run's formula", counted))
        check(max(errs) <= tol, (tag, "sharded logits against unsharded", errs))
        check(n_cmp == n_tok, (tag, "greedy tokens where the margin decides", n_cmp, n_tok))
        # the written slots, kpos and pos
        slot_err = 0.0
        for (names, sh), (_, w) in zip(ST._named_leaves(pc), ST._named_leaves(want)):
            got = sh.gather()
            if names[-1] in ("kpos", "pos"):
                check(torch.equal(got, w), (tag, names, "exact"))
            elif names[-1] in ("ssm", "conv"):  # Mamba-2's state: all of it written each step
                slot_err = max(slot_err, rel(got, w))
            else:
                idx = torch.tensor([(pos0 + t) % w.shape[-3] for t in range(steps)], device=DEVICE)
                slot_err = max(slot_err, rel(got.index_select(-3, idx), w.index_select(-3, idx)))
            del got
        check(slot_err <= tol, (tag, "written cache slots", slot_err))
        lay = SV.SD.serve_layout(c, mesh, batch)
        res = {"cell": cell, "batch": batch, "cache_capacity": cap, "first_pos": pos0, "steps": steps,
               "mesh": dict(mesh.shape), "seq_shard": lay.seq_shard, "attn": lay.attn, "ssm_tp": lay.ssm_tp,
               "conv_tp": lay.conv_tp, "max_rel_err": max(errs),
               "slot_rel_err": slot_err, "greedy_tokens_compared": n_tok, "sharded_ms": s_ms, "unsharded_ms": u_ms,
               "sharded_ms_median": float(np.median(s_ms[1:])), "unsharded_ms_median": float(np.median(u_ms[1:])),
               "collectives": counted[0], "collective_bytes": counted[1], "placed_cache": placed}
        log(f"[serve-shard] {tag} {cell} batch {batch} on {dict(mesh.shape)} ({lay.attn}, seq_shard "
            f"{lay.seq_shard}): logits within {max(errs):.2e} of max, {'state' if c.ssm else 'slots'} within "
            f"{slot_err:.2e}, kpos and pos exact, {n_tok} greedy tokens decided and equal; a step "
            f"{res['sharded_ms_median']:.1f} ms sharded against {res['unsharded_ms_median']:.1f} ms unsharded "
            f"(median of steps 2-{steps}); collectives {counted[0]} ({counted[1]} bytes on device 0); the placed "
            f"cache {placed['per_device'] / 1e9:.3f} GB a device, {placed['storages'] / 1e9:.3f} GB of storages")
        del want, src, pc, pp
        return res

    def prefill_leg(c, params, tol, tag, mesh=mesh):
        b, seq = SERVE_PREFILL
        host = TokenStream(c.vocab, b, seq, seed=SERVE_SEED).batch_at(0)
        batch = {"tokens": torch.from_numpy(host["tokens"]).to(DEVICE)}
        with ST.strategy_context(mesh, "tp") as (plan, ep_axis):
            pp, _ = ST.place_serve_state(params, None, c, mesh, plan)
            step = ST.make_prefill_step(c, ep_axis)
            w, ums = timed(step, params, batch)
            mesh.reset_collectives()
            g, sms = timed(step, pp, batch)
            counted = dict(mesh.collectives), dict(mesh.collective_bytes)
        check(all(x.device.type == on for x in g.shards), (tag, "every logits block on the card"))
        err = rel(g.gather(), w)
        check(err <= tol, (tag, "sharded prefill logits", err))
        check(counted == DR.serve_collectives(c, mesh, "tp", SH.ShapeSpec("prefill_32k", "prefill", seq, b)),
              (tag, "prefill collectives equal the formula", counted))
        log(f"[serve-shard] {tag} prefill {b} x {seq} on {dict(mesh.shape)}: last-position logits within "
            f"{err:.2e} of max; "
            f"{sms:.1f} ms sharded against {ums:.1f} ms unsharded; collectives {counted[0]} "
            f"({counted[1]} bytes on device 0)")
        return {"mesh": dict(mesh.shape), "batch": b, "seq": seq, "rel_err": err, "sharded_ms": sms,
                "unsharded_ms": ums,
                "collectives": counted[0], "collective_bytes": counted[1]}

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    if "d" in legs:
        head_legs(torch, out, decode_leg, prefill_leg, leg_done, mesh)
    if "split" in legs:
        split_legs(torch, out, decode_leg, prefill_leg, leg_done, mesh)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(out["peak_gb"] < 70, ("(d) peak device memory under 70 GB", out["peak_gb"]))
    if "d4" not in legs:
        out["launches"] = {"shard_serve": read_counts()}
        out["wall_s"] = time.perf_counter() - t_phase
        return out

    # (d4) the dry run's serve cells at the production mesh
    pmesh = make_production_mesh(device=DEVICE)
    out["dryrun"] = {}
    for arch in ARCH_IDS:
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            cell = DR.plan_cell(arch, shape, pmesh, "tp")
            if cell["status"] != "planned":
                out["dryrun"][f"{arch}/{shape}"] = cell["status"]
                continue
            col = cell["collectives"]
            check(col is not None and col["calls"]["all-reduce"] > 0, (arch, shape, "serve collectives"))
            check(col["layout"]["seq_shard"] == (shape == "long_500k"), (arch, shape, col["layout"]))
            out["dryrun"][f"{arch}/{shape}"] = {
                "calls": {k: v for k, v in col["calls"].items() if v},
                "bytes": {k: v for k, v in col["bytes"].items() if v}, "layout": col["layout"],
                "t_collective_ms": cell["roofline"]["t_collective_s"] * 1e3,
                "gb_per_device": cell["memory"]["total_bytes_per_device"] / 2**30}
    log(f"[serve-shard] (d4) dry run serve cells at {pmesh.shape}, (all-gather, all-reduce) calls a step: "
        + json.dumps({k: v if isinstance(v, str) else [v["calls"].get("all-gather", 0), v["calls"]["all-reduce"]]
                      for k, v in out["dryrun"].items()}))
    leg_done("dryrun")
    out["launches"] = {"shard_serve": read_counts()}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[serve-shard] phase {out['wall_s']:.1f} s: {out['legs_s']}; peak {out['peak_gb']:.2f} GB; launches "
        f"{out['launches']}")
    return out


def head_legs(torch, out, decode_leg, prefill_leg, leg_done, mesh):
    """``phase_shard_serve``'s (d1)-(d3): h2o-danube3-4b, bfloat16 at
    full depth, then float32 at 4 layers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import serving as SV
    from repro_torch.models import transformer as TF

    cfg = get_config(SERVE_ARCH)
    fcfg = dataclasses.replace(cfg, **SERVE_FP32_CUT)
    for c, tag in ((cfg, "bf16"), (fcfg, "float32 4 layers")):
        pb = tree_bytes(TF.init_params(None, c, device="meta"))
        cb = {cell: tree_bytes(SV.init_cache(c, b, cap, TF.compute_dtype(c), device="meta"))
              for cell, b, cap, _ in SERVE_DECODE}
        log(f"[serve-shard] {c.name} {tag}: {c.n_layers} layers, d_model {c.d_model}, {c.n_heads}/{c.n_kv_heads} "
            f"heads, window {c.sliding_window}; float32 weights {pb / 1e9:.2f} GB; caches "
            f"{ {k: round(v / 1e9, 3) for k, v in cb.items()} } GB (two copies a leg: sharded and unsharded); "
            f"mesh {mesh.shape} of {mesh.device_list[0]}; reduced: decode_32k batch 128 -> 16, prefill_32k "
            f"32 x 32768 -> {SERVE_PREFILL[0]} x {SERVE_PREFILL[1]}")
    params = TF.init_params(torch.Generator(device=DEVICE).manual_seed(SERVE_SEED), cfg, DEVICE)
    for cell, b, cap, pos0 in SERVE_DECODE:
        out["legs"][cell] = decode_leg(cfg, params, cell, b, cap, pos0, SERVE_STEPS, SERVE_BF16_REL, "(d)")
        free(torch)
        leg_done(cell)
    out["legs"]["prefill"] = prefill_leg(cfg, params, SERVE_BF16_REL, "(d3)")
    del params
    free(torch)
    leg_done("prefill")
    fparams = TF.init_params(torch.Generator(device=DEVICE).manual_seed(SERVE_SEED), fcfg, DEVICE)
    for cell, b, cap, pos0 in SERVE_DECODE:
        out["legs"][f"float32_{cell}"] = decode_leg(fcfg, fparams, cell, b, cap, pos0, SERVE_FP32_STEPS,
                                                    SERVE_FP32_REL, "(d) float32")
    out["legs"]["float32_prefill"] = prefill_leg(fcfg, fparams, SERVE_FP32_REL, "(d3) float32")
    del fparams
    free(torch)
    leg_done("float32")



def split_legs(torch, out, decode_leg, prefill_leg, leg_done, mesh):
    """``phase_shard_serve``'s (d5)-(d7), the head-split paths (d1)-(d3)
    bypass, each at its published width (bfloat16 compute over float32
    weights; each leg's bytes from ``device="meta"`` first; its state freed
    after it):

    (d5) deepseek-v3 at its 3 dense layers, "tp" on the 2 x 2 mesh: 128
         MLA heads, 64 a model shard, the latent cache replicated over
         "model"; decode at batch 16 from a 4,096-slot latent ring, absorbed
         and naive (``serving.MLA_ABSORBED``), each against the unsharded
         step under the same flag; both forms again at batch 1 (the slot
         axis over "data": the sequence-parallel softmax); a 2 x 4,096
         prefill; a decode with FSDP rows under "tp"
         (``sharding.DP_THRESHOLD_PARAMS`` 0: the depth cut takes the
         config under the threshold);
    (d6) mamba2-1.3b at full depth, "tp" on 2 x 2: 64 state heads and
         4,352 conv channels split; decode at batch 16 from seed-made
         SSM/conv state, ``long_500k`` at batch 1, a 2 x 4,096 prefill;
    (d7) qwen2-0.5b at full depth: "hd" on 2 x 4 (2 KV heads, ``head_dim``
         64 in blocks of 16, the partial scores summed over "model") and "q"
         on 2 x 3 (14 query heads in ceil blocks over a replicated cache),
         each a decode at batch 16 from a 4,096-slot ring and a prefill."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import serving as SV
    from repro_torch.models import sharding as SD
    from repro_torch.models import transformer as TF

    cap, pos0 = SERVE_RING
    tol = SERVE_BF16_REL

    def made(c, what, cut, meshes):
        reduced = {**cut, "decode_32k batch": [128, 16], "prefill_32k": ["32 x 32768", "%d x %d" % SERVE_PREFILL]}
        pb = tree_bytes(TF.init_params(None, c, device="meta"))
        cb = tree_bytes(SV.init_cache(c, 16, cap, TF.compute_dtype(c), device="meta"))
        log(f"[serve-shard] {what} {c.name}: {c.n_layers} layers, d_model {c.d_model}, {c.n_heads}/"
            f"{c.n_kv_heads} heads, vocab {c.vocab:,}; float32 weights {pb / 1e9:.2f} GB; a batch-16 cache of "
            f"{cap} slots {cb / 1e9:.3f} GB (two copies a leg); meshes {meshes}; reduced: {reduced}")
        return TF.init_params(torch.Generator(device=DEVICE).manual_seed(SERVE_SEED), c, DEVICE)

    legs = out["legs"]
    # ---- (d5) head-split MLA, absorbed and naive
    full = get_config(SERVE_MLA_ARCH)
    c = dataclasses.replace(full, **SERVE_MLA_CUT)
    params = made(c, "(d5)", {k: [getattr(full, k), v] for k, v in SERVE_MLA_CUT.items()}, [dict(mesh.shape)])
    for absorbed in (True, False):
        form = "absorbed" if absorbed else "naive"
        with setting(SV.MLA_ABSORBED, "enabled", absorbed):
            legs[f"mla_{form}"] = decode_leg(c, params, "decode_4k", 16, cap, pos0, SERVE_SPLIT_STEPS, tol,
                                             f"(d5) MLA {form}")
            legs[f"mla_{form}_seq"] = decode_leg(c, params, "decode_4k_batch_1", 1, cap, pos0, SERVE_SEQ_STEPS,
                                                 tol, f"(d5) MLA {form}")
            check(legs[f"mla_{form}_seq"]["seq_shard"], "(d5) batch 1 takes the sequence-parallel branch")
    legs["mla_prefill"] = prefill_leg(c, params, tol, "(d5) MLA")
    with setting(SD, "DP_THRESHOLD_PARAMS", 0):
        check(SD.use_fsdp(c), "(d5) FSDP rows under tp")
        legs["mla_fsdp_rows"] = decode_leg(c, params, "decode_4k", 16, cap, pos0, SERVE_SEQ_STEPS, tol,
                                           "(d5) MLA, FSDP rows under tp")
    del params
    free(torch)
    leg_done("d5_mla")

    # ---- (d6) head-split Mamba-2
    c = get_config(SERVE_SSM_ARCH)
    lay = SD.serve_layout(c, mesh, 16)
    check(lay.ssm_tp and lay.conv_tp, ("(d6) state heads and conv channels split", lay))
    params = made(c, "(d6)", {}, [dict(mesh.shape)])
    legs["ssm_decode"] = decode_leg(c, params, "decode_4k", 16, cap, pos0, SERVE_SPLIT_STEPS, tol, "(d6) Mamba-2")
    _, b, lcap, lpos = SERVE_DECODE[1]
    legs["ssm_long_500k"] = decode_leg(c, params, "long_500k", b, lcap, lpos, SERVE_SPLIT_STEPS, tol,
                                       "(d6) Mamba-2")
    legs["ssm_prefill"] = prefill_leg(c, params, tol, "(d6) Mamba-2")
    del params
    free(torch)
    leg_done("d6_ssm")

    # ---- (d7) the "hd" and "q" cache splits
    c = get_config(SERVE_KV_ARCH)
    meshes = [(make_local_mesh(data=d, model=m, device=DEVICE), attn) for (d, m), attn in SERVE_KV_MESHES]
    params = made(c, "(d7)", {}, [dict(m.shape) for m, _ in meshes])
    for m, attn in meshes:
        check(SD.serve_layout(c, m, 16).attn == attn, ("(d7) the cache split", attn))
        legs[f"{attn}_decode"] = decode_leg(c, params, "decode_4k", 16, cap, pos0, SERVE_SPLIT_STEPS, tol,
                                            f"(d7) {attn}", m)
        legs[f"{attn}_prefill"] = prefill_leg(c, params, tol, f"(d7) {attn}", m)
    del params
    free(torch)
    leg_done("d7_hd_q")


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

    walls = {}
    t_start = time.perf_counter()

    def timed_phase(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        walls[name] = round(time.perf_counter() - t0, 1)
        return res

    timed_phase("build", phase_build)
    parity_err = timed_phase("parity", phase_parity, torch, np)
    ops_err = timed_phase("parity_ops", phase_parity_ops, torch, np)
    scatter_err = timed_phase("parity_scatter", phase_parity_scatter, torch, np)
    torch.cuda.reset_peak_memory_stats()
    lm = timed_phase("lm", phase_lm, torch, np)
    free(torch)
    train = timed_phase("train", phase_train, torch, np)
    free(torch)
    shard = timed_phase("shard", phase_shard, torch, np)
    free(torch)
    serve_shard = timed_phase("shard_serve", phase_shard_serve, torch, np)
    free(torch)
    examples = timed_phase("examples", phase_examples, torch, np)
    free(torch)
    data = timed_phase("data", phase_data, torch, np)
    sess8, main_run = timed_phase("main", phase_main, torch, np, data)
    mesh = timed_phase("mesh", phase_mesh, torch, np, data, sess8)
    bf16_err = timed_phase("bf16_ingest", phase_bf16_ingest, torch, np, data)
    types_err, types_launches = timed_phase("value_types", phase_value_types, torch, np, data)
    read = timed_phase("read_side", phase_read_side, torch, np, sess8, data)
    served = timed_phase("serve", phase_serve, torch, np, data, sess8)
    # the fleet's workers hold their own state: free this process's first
    fleet_want = sess8.snapshot()
    del sess8
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fleet = timed_phase("fleet", phase_fleet, torch, np, data, fleet_want)
    del fleet_want
    gc.collect()
    torch.cuda.empty_cache()
    bench = timed_phase("bench", phase_bench, torch, np)
    single_sess, single = timed_phase("single", phase_single, torch, np, data)
    times = timed_phase("kernel_times", phase_kernel_times, torch, np, data, main_run, single_sess)
    del single_sess
    algebra = timed_phase("algebra", phase_algebra, torch, np)
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    # free the streaming phases' state before the embedding path
    del data
    main_run.pop("routed")
    gc.collect()  # the sessions hold reference cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[embed] device memory held before the phase {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    embed = timed_phase("embed", phase_embed_grad, torch, np)
    fl = embed["flushed"]
    embed_times = timed_phase("scatter_times", scatter_times, torch, np, fl.ids, fl.rows, int(fl.nnz),
                              embed["rows_n"], "times")
    log(f"[embed] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    paths = {"cuda": main_run["launches"], "single": single["launches"], "read": read["launches"],
             "serve": served["cuda"]["launches"], "serve_default": served["cuda_default"]["launches"],
             "serve_single": served["single"]["launches"],
             "serve_loopback": served["loopback"]["launches"], "value_types": types_launches,
             "algebra": algebra["launches"], "embed_grad": embed["launches"],
             "fleet": fleet["launches"], **mesh["launches"], "lm_serve": lm["launches"],
             "lm_train": train["launches"], "train_lm": train["train_lm"]["launches"],
             **shard["launches"],
             **serve_shard["launches"], **examples["launches"],
             **{f"bench_{sec}": c for sec, c in bench["launches"].items()}}
    err = max(ops_err, main_run["err"], read["err"], single["err"], algebra["err"], served["err"],
              types_err, mesh["err"])

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
        "max_abs_err": max(parity_err, main_run["err"], bf16_err, types_err, mesh["err"]),
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
        "max_abs_err": max(scatter_err, embed["err"]),  # phase_train's are bit-identical (checked)
        "ms": embed_times["ms"],
        "plain_ms": embed_times["plain_ms"],
        "bound_ms": embed_times["bound_ms"],
        "bound_by": "bytes",
        "library_ms": embed_times["library_ms"],
        "bytes": embed_times["bytes"],
        "lm_train_shape": train["gather_backward"]["scatter_add"],
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
        "serve": "the default ServeConfig",
        "sweep": {f"N={n}": {k: v for k, v in row.items() if k != "merge_kernel"}
                  for n, row in fleet["sweep"].items()},
        "kill_leg_N=2": fleet["kill"],
        "merge_kernel": fleet["sweep"][max(FLEET_WORKERS)]["merge_kernel"],
        "controller_chunk_ms": fleet["host_costs"],
        "launches": fleet["launches"],
    }))
    log("[mesh-metrics] " + json.dumps({"card": card, **{k: v for k, v in mesh.items() if k != "err"}}))
    log("[bench-metrics] " + json.dumps({
        "card": card,
        "wall_s": bench["wall_s"],
        "sections_s": bench["sections_s"],
        "reduced": bench["reduced"],
        "sections": bench["sections"],
        "launches": bench["launches"],
    }))
    log("[lm-metrics] " + json.dumps({"card": card, **{k: v for k, v in lm.items() if k != "launches"}}))
    log("[train-metrics] " + json.dumps({"card": card, **train}))
    log("[shard-metrics] " + json.dumps({"card": card, **{k: v for k, v in shard.items() if k != "launches"}}))
    log("[serve-shard-metrics] " + json.dumps({"card": card, **{k: v for k, v in serve_shard.items()
                                                                if k != "launches"}}))
    log("[examples-metrics] " + json.dumps({"card": card, **{k: v for k, v in examples.items()
                                                             if k != "launches"}}))
    walls["total"] = round(time.perf_counter() - t_start, 1)
    log(f"[timing] phases, s: {walls}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
