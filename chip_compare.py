#!/usr/bin/env python3
"""Time the port's ``hier_cascade``, ``merge_add`` and ``sort_dedup`` kernels
of one source tree at the main paths' shapes, so that two commits can be
compared in one call on the card (the host of a chip machine varies between
calls).

    mkdir -p archive/parent && git archive <commit> | tar -x -C archive/parent
    for t in archive/parent . . archive/parent; do python3 chip_compare.py --src $t; done

Each run imports ``repro_torch`` from ``<src>/src`` (its kernels built into
that tree's own build directory) and the measurement helpers from
``chip_smoke.py`` beside this script, and prints one JSON line:

* ``hier_cascade``: the ``cuda`` engine at full width (K=8, 200 groups of
  100,000 R-MAT edges, ``configs/d4m_stream.CONFIG``): the ingest rate, then
  the kernel alone on the same routed batches, per step and per step kind
  (the highest cascade that fired, read from the cascade counters);
* ``merge_add``: the ``single`` engine's ingest rate at full width, and the
  kernel alone on its layer-1 merge, the snapshot merges of its state and
  the last cascade merge of each level;
* ``sort_dedup``: the kernel alone on a routed ``cuda`` engine batch
  ``[8, 100000]`` and a ``single`` engine batch ``[100000]``
  (``from_triples``, and ``combine_sorted`` on the same batches sorted),
  the degrees' fold stage on the ``single`` state's snapshot and one run as
  long as the largest out-degree (``combine_sorted``), with the wrapper's
  host ms and (where the tree counts them) the CUDA launches a call.

The R-MAT stream is made once and kept in ``--cache`` (a git-ignored path)
for the runs that follow.  Without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs  # puts this tree's src on sys.path first

ROOT = Path(__file__).resolve().parent


def load_data(torch, np, cache: Path):
    """The stream of ``chip_smoke.phase_data``, from ``cache`` when there."""
    if cache.exists():
        z = np.load(cache)
        R, C = (torch.tensor(z[k], device=cs.DEVICE) for k in ("R", "C"))
        return {"n_edges": R.numel(), "n_distinct": int(z["n_distinct"]), "R": R, "C": C,
                "V": torch.ones(R.shape, dtype=torch.float32, device=cs.DEVICE)}
    data = cs.phase_data(torch, np)
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.savez(cache, R=data["R"].cpu().numpy(), C=data["C"].cpu().numpy(), n_distinct=data["n_distinct"])
    return data


def time_cascade(torch, np, data):
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.core import multistream
    from repro_torch.d4m import D4MStream
    from repro_torch.kernels.hier_cascade import ops

    R, C, V = data["R"], data["C"], data["V"]
    cfg = CONFIG.to_session(instances_per_device=cs.K, top_capacity=cs.TOP_CAPACITY,
                            snapshot_cap=data["n_distinct"])
    sess = D4MStream(cfg)
    sess.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in range(cs.STEPS):
        sess.ingest(R[g], C[g], V[g])
    torch.cuda.synchronize()
    rate = data["n_edges"] / (time.perf_counter() - t0)
    batches, routed = [], None
    for g in range(cs.STEPS):
        br, bc, bv, _ = sess.route(R[g], C[g], V[g])
        routed = routed or (br, bc, bv)
        batches.append(ops.canonical_batch(br, bc, bv, sess.sr))
    h = multistream.init_packed(cs.K, sess.cuts, cfg.top_capacity, cfg.batch_size, sess.sr,
                                device=cs.DEVICE)
    flat, kernel_ms, host_ms, casc_after, _ = cs.kernel_replay(
        torch, np, batches, multistream.flat_layer_state(h), sess.cuts, sess.plan.layer_caps, sess.sr)
    same = cs.compare(torch, multistream.from_flat_layer_state(*flat), sess.state, "replay vs ingest")
    return {"rate": rate, "ms": float(np.mean(kernel_ms)), "median_ms": float(np.median(kernel_ms)),
            "host_ms": float(np.mean(host_ms)), "max_abs_err": same,
            "kinds": cs.step_kinds(torch, np, casc_after, kernel_ms)}, routed


def time_merges(torch, np, data):
    from repro_torch.configs.d4m_stream import CONFIG
    from repro_torch.d4m import D4MStream
    from repro_torch.kernels.merge_add import ops as mops

    sess = D4MStream(CONFIG.to_session(snapshot_cap=data["n_distinct"]))
    sess.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in range(cs.STEPS):
        sess.ingest(data["R"][g], data["C"][g], data["V"][g])
    torch.cuda.synchronize()
    out = {"rate": data["n_edges"] / (time.perf_counter() - t0)}
    for name, (a, b, cap) in cs.merge_add_cases(torch, data, sess).items():
        ms = cs.time_kernel(torch, np, lambda: mops.merge_add(a, b, cap, sess.sr), reps=5)
        out[name] = {"ms": ms, "n_a": int(a.nnz), "n_b": int(b.nnz), "cap": cap}
        cs.log(f"[compare] merge_add {name}: {ms:.4f} ms")
    return out, sess


def time_sort(torch, np, data, routed, single):
    from repro_torch.core import assoc
    from repro_torch.kernels.sort_dedup import ops as sops

    sr = single.sr
    snap = single.snapshot()
    zero_c = torch.where(snap.rows != assoc.PAD, 0, assoc.PAD).to(torch.int32)
    longest = int(torch.bincount(data["R"].flatten()).max())  # the largest out-degree, as chip_smoke.py
    run = torch.zeros(longest, dtype=torch.int32, device=cs.DEVICE)
    batches = {"[8, 100000]": routed, "[100000]": (data["R"][0], data["C"][0], data["V"][0])}
    shapes = {name: (sops.from_triples, b) for name, b in batches.items()}
    for name, (r, c, v) in batches.items():  # the fold stage alone on the sorted batch
        order = torch.sort(assoc.pack_keys(r, c), dim=-1, stable=True).indices
        shapes[f"fold stage {name}"] = (sops.combine_sorted, tuple(torch.gather(x, -1, order) for x in (r, c, v)))
    shapes.update({
        f"degrees fold [{snap.capacity}]": (sops.combine_sorted, (snap.rows, zero_c, snap.vals)),
        f"one run of {longest}": (sops.combine_sorted, (run, run, torch.ones(longest, device=cs.DEVICE))),
    })
    out = {}
    for name, (entry, (r, c, v)) in shapes.items():
        def call(entry=entry, r=r, c=c, v=v):
            return entry(r, c, v, r.shape[-1], sr)

        row = {"ms": cs.time_kernel(torch, np, call, reps=10)}
        row["cuda_launches_per_call"], row["host_ms"] = cs.wrapper_costs(torch, np, sops, call)
        out[name] = row
        cs.log(f"[compare] sort_dedup {name}: {row}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=".", help="root of the source tree to time (default: this one)")
    ap.add_argument("--cache", default=str(ROOT / "bench-artifacts" / "chip_compare_stream.npz"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device; this runs on the card", file=sys.stderr)
        return 2
    src = Path(args.src).resolve() / "src"
    sys.path.insert(0, str(src))
    import repro_torch

    if Path(repro_torch.__file__).resolve().parents[1] != src:
        print(f"chip_compare: imported {repro_torch.__file__}, not from {src}", file=sys.stderr)
        return 2
    cs.phase_build()
    data = load_data(torch, np, Path(args.cache))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cascade, routed = time_cascade(torch, np, data)
    merges, single = time_merges(torch, np, data)
    res = {"src": str(src), "card": smi, "hier_cascade": cascade, "merge_add": merges,
           "sort_dedup": time_sort(torch, np, data, routed, single)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
