#!/usr/bin/env python3
"""Time the port's ``hier_cascade`` and ``merge_add`` kernels of one source
tree at the main paths' shapes, so that two commits can be compared in one
call on the card (the host of a chip machine varies between calls).

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
  the last cascade merge of each level.

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
    batches = []
    for g in range(cs.STEPS):
        br, bc, bv, _ = sess.route(R[g], C[g], V[g])
        batches.append(ops.canonical_batch(br, bc, bv, sess.sr))
    h = multistream.init_packed(cs.K, sess.cuts, cfg.top_capacity, cfg.batch_size, sess.sr,
                                device=cs.DEVICE)
    flat, kernel_ms, host_ms, casc_after, _ = cs.kernel_replay(
        torch, np, batches, multistream.flat_layer_state(h), sess.cuts, sess.plan.layer_caps, sess.sr)
    same = cs.compare(torch, multistream.from_flat_layer_state(*flat), sess.state, "replay vs ingest")
    return {"rate": rate, "ms": float(np.mean(kernel_ms)), "median_ms": float(np.median(kernel_ms)),
            "host_ms": float(np.mean(host_ms)), "max_abs_err": same,
            "kinds": cs.step_kinds(torch, np, casc_after, kernel_ms)}


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
    res = {"src": str(src), "card": smi,
           "hier_cascade": time_cascade(torch, np, data), "merge_add": time_merges(torch, np, data)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
