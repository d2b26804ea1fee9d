"""Quickstart: the paper in 60 seconds, on the port's ``repro_torch.d4m``
API.

Build hypersparse associative arrays from a network-traffic-like stream,
push them through a hierarchical cascade, and query the result: the Fig. 1
/ Section III workflow on synthetic IPv4 traffic, written as the paper
writes it: one config, one session, operator algebra.  On the card the
algebra and the snapshot run the ``sort_dedup`` and ``merge_add`` kernels
and the session is the ``single`` engine (one hierarchy, K=1).

Run::

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

:func:`main` returns what it printed, as tensors moved to numpy, so that
two runs can be compared bit for bit.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import d4m
from repro_torch.data import dictionary, rmat
from repro_torch.device import resolve_device


def _triples(a) -> tuple:
    """An Assoc's live entries as numpy ``(rows, cols, vals)``."""
    n = int(a.nnz)
    return (a.rows[:n].cpu().numpy(), a.cols[:n].cpu().numpy(), a.vals[:n].float().cpu().numpy())


def run(device=None, group: int = 512, total_edges: int = 16_384, scale: int = 14, seed: int = 0) -> dict:
    """The quickstart on ``device`` (``cuda`` unless given), printing as
    the reference's example prints; returns its results."""
    dev = resolve_device(device)
    out: dict = {}
    # --- 1. associative arrays over (src-ip, dst-ip) keys ------------------
    src = torch.as_tensor(dictionary.encode_ipv4(["1.1.1.1", "1.1.1.1", "10.0.0.7", "8.8.8.8"]), device=dev)
    dst = torch.as_tensor(dictionary.encode_ipv4(["2.2.2.2", "3.3.3.3", "1.1.1.1", "1.1.1.1"]), device=dev)
    vals = torch.ones((4,), device=dev)
    A = d4m.from_triples(src, dst, vals, cap=8)
    print("nnz:", int(A.nnz))

    # Fig. 1 one-liners, operator algebra under the ambient cap policy:
    one = int(dictionary.encode_ipv4(["1.1.1.1"])[0])
    row = A[one, :]  # nearest out-neighbours of 1.1.1.1
    print("out-neighbours of 1.1.1.1:", int(row.nnz))
    sym = A + A.T  # undirected view (table union)
    print("undirected support nnz:", int(sym.nnz))
    hot = A & sym  # intersection (element-wise mul)
    print("A & (A + A.T) nnz:", int(hot.nnz))
    with d4m.cap_policy(matmul_cap=64, max_fanout=4):
        two_hop = A @ A  # semiring spGEMM
    print("two-hop pairs:", int(two_hop.nnz))

    # semiring flexibility: the same algebra under max.plus
    with d4m.cap_policy(sr=d4m.MAX_PLUS):
        B = d4m.from_triples(src, dst, vals, cap=8, sr=d4m.MAX_PLUS)
        union = B + B.T
        print("max.plus union nnz:", int(union.nnz))
    out["algebra"] = {name: _triples(x) for name, x in
                      (("A", A), ("row", row), ("sym", sym), ("hot", hot), ("two_hop", two_hop),
                       ("maxplus_union", union))}

    # --- 2. hierarchical streaming (Section III) ---------------------------
    cfg = d4m.StreamConfig(cuts=(1024, 8192), top_capacity=200_000, batch_size=group)
    print(cfg.plan().describe())
    sess = d4m.D4MStream(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_all, d_all, v_all = rmat.stream_tensor(gen, total_edges // group, group, scale)
    for s, d, v in zip(s_all, d_all, v_all):
        sess.update(s, d, v)
    tel = sess.telemetry()
    print("stream ingested; per-layer nnz:", tel["nnz_per_layer"])
    cascades = np.asarray(tel["cascades"]).tolist()
    print("cascades per layer:", cascades)

    # --- 3. analysis: the bound query namespace ----------------------------
    ids, counts = sess.query.top_k(5)
    print("top-5 out-degree vertices:", ids.tolist(), counts.tolist())
    snap = sess.snapshot()
    heavy = snap.topk(3)[0]
    print("snapshot nnz:", int(snap.nnz), "| heavy hitters via operator:", heavy.tolist())
    out.update(
        kind=sess.kind,
        nnz_per_layer=list(tel["nnz_per_layer"]),
        cascades=cascades,
        top_k=(ids.cpu().numpy(), counts.cpu().numpy()),
        heavy=heavy.cpu().numpy(),
        snapshot=_triples(snap),
    )
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--group", type=int, default=512)
    ap.add_argument("--total-edges", type=int, default=16_384)
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return run(args.device, args.group, args.total_edges, args.scale, args.seed)


if __name__ == "__main__":
    main()
