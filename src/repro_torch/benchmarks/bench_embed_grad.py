"""LM integration benchmark: hierarchical sparse embedding-gradient
accumulation vs. dense accumulation (port of the reference's
``benchmarks/bench_embed_grad.py``).

A gradient-accumulation window of M microbatches touches at most M*T
distinct vocabulary rows of V.  The dense baseline adds each microbatch's
rows into a ``[V, d]`` float32 table (``index_add_``); the hierarchical path
ingests ``(id, row)`` pairs into the row accumulator
(:mod:`repro_torch.sparse.row_accum`), flushes it once (``hier_flush``) and
scatters it into a dense table through the ``scatter_add`` kernel
(``to_dense``).

Reported: time a microbatch of each path, the flush + scatter, and in place
of the reference's modeled TPU traffic the bytes the window's function must
move on the card (every microbatch's ids and rows read once, the dense
``[V, d]`` gradient written once) with their bound at 3.35 TB/s.  The
flushed gradient must equal the dense one (``rtol=1e-4, atol=1e-5``), and
the accumulator must hold numpy's count of distinct ids with no overflow.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench.reporting import BenchmarkReport
from repro_torch.sparse import row_accum as RA

from . import _common


def run(v: int, d: int, t_tokens: int, micro: int, zipf: float = 1.2,
        report: BenchmarkReport | None = None, device: str | torch.device = "cuda"):
    dev = _common.device_of(device)
    rng = np.random.default_rng(0)
    # a Zipf-like token draw: the power-law structure of R-MAT streams
    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = ranks**-zipf
    probs /= probs.sum()
    ids_np = rng.choice(v, size=(micro, t_tokens), p=probs).astype(np.int32)
    rows_np = rng.normal(size=(micro, t_tokens, d)).astype(np.float32) * 0.01
    ids_all = torch.from_numpy(ids_np).to(dev)
    rows_all = torch.from_numpy(rows_np).to(dev)

    # ---- dense baseline --------------------------------------------------
    acc = torch.zeros((v, d), dtype=torch.float32, device=dev)
    acc.index_add_(0, ids_all[0], rows_all[0])  # warm-up
    acc.zero_()
    _common.sync(dev)
    t0 = time.perf_counter()
    for m in range(micro):
        acc.index_add_(0, ids_all[m], rows_all[m])
    _common.sync(dev)
    dense_us = (time.perf_counter() - t0) / micro * 1e6

    # ---- hierarchical sparse accumulator ----------------------------------
    cuts = (2 * t_tokens, 8 * t_tokens)
    before = _common.launch_counts()
    h = RA.hier_init(cuts, top_capacity=micro * t_tokens, batch=t_tokens, d=d, device=dev)
    h = RA.hier_update(h, ids_all[0], rows_all[0], cuts)  # warm-up
    RA.to_dense(RA.hier_flush(h), v)  # builds the kernel at first use
    h = RA.hier_init(cuts, top_capacity=micro * t_tokens, batch=t_tokens, d=d, device=dev)
    _common.sync(dev)
    t0 = time.perf_counter()
    for m in range(micro):
        h = RA.hier_update(h, ids_all[m], rows_all[m], cuts)
    _common.sync(dev)
    hier_us = (time.perf_counter() - t0) / micro * 1e6
    t0 = time.perf_counter()
    flushed = RA.hier_flush(h)
    got = RA.to_dense(flushed, v)
    _common.sync(dev)
    flush_us = (time.perf_counter() - t0) * 1e6
    launches = _common.launches_since(before)

    distinct = int(np.unique(ids_np).size)
    overflow = bool(RA.hier_overflowed(h))
    exact_nnz = int(flushed.nnz) == distinct and not overflow
    close = bool(torch.allclose(got, acc, rtol=1e-4, atol=1e-5))
    err = float((got - acc).abs().max())

    # the window's function: every microbatch's ids and rows read once, the
    # dense gradient written once
    nbytes = micro * t_tokens * (d * 4 + 4) + v * d * 4
    bound_us = nbytes / _common.HBM_BYTES_PER_S * 1e6
    print(
        f"embed_grad,V={v},d={d},tok/mb={t_tokens},micro={micro},"
        f"dense_us={dense_us:.0f},hier_us={hier_us:.0f},flush_us={flush_us:.0f},"
        f"bytes={nbytes / 1e9:.3f}GB,bound_us={bound_us:.1f},distinct_ids={distinct},"
        f"nnz_exact={exact_nnz},allclose={close},max_abs_err={err:.2e},launches={launches}",
        flush=True,
    )
    if report is not None:
        report.add(
            "embed_grad",
            params={"V": v, "d": d, "tokens_per_microbatch": t_tokens, "micro": micro},
            updates_per_sec=t_tokens / (hier_us / 1e6),
            wall_s=hier_us / 1e6 * micro,
            dense_us=dense_us,
            hier_us=hier_us,
            flush_us=flush_us,
            bytes=int(nbytes),
            bound_us=bound_us,
            bound_by="bytes",
            distinct_ids=distinct,
            nnz=int(flushed.nnz),
            nnz_exact=bool(exact_nnz),
            overflow=overflow,
            allclose=close,
            max_abs_err=err,
            launches=launches,
        )
    failures = []
    if not exact_nnz:
        failures.append(f"V={v}: accumulator nnz {int(flushed.nnz)} vs {distinct} distinct ids, "
                        f"overflow {overflow}")
    if not close:
        failures.append(f"V={v}: flushed gradient differs from the dense one by {err:.3e}")
    return failures


def main(smoke: bool = False, shapes=None, device: str = "cuda"):
    """The reference's windows, or those ``shapes`` names: ``[V, d, tokens a
    microbatch, microbatches]`` each."""
    dev = _common.device_of(device)
    report = BenchmarkReport("embed_grad", device=str(dev))
    if shapes is None:
        shapes = [(32_000, 64, 512, 4)] if smoke else [(32_000, 256, 2048, 8),
                                                       (262_144, 256, 2048, 8)]
    failures = []
    for v, d, t_tokens, micro in shapes:
        failures += run(v=int(v), d=int(d), t_tokens=int(t_tokens), micro=int(micro),
                        report=report, device=dev)
        _common.release(dev)
    report.write()
    _common.raise_failures("embed", failures)


if __name__ == "__main__":
    main()
