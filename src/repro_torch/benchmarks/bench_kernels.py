"""Kernel microbenchmarks on the card (port of the reference's
``benchmarks/bench_kernels.py``).

The reference times its Pallas kernels in interpret mode on the CPU and
reports the TPU design's VMEM working set.  Here each kernel runs on the
card, at the reference's sizes or at the shapes a spec names
(``merge_sizes``, ``sort_shapes``, ``scatter_shapes``), and reports the
card's own numbers:

* ``kernel_us`` — the kernel's time from CUDA events around each call,
  after a warm-up call that builds it, each call queued behind a spin of
  the card so the wrapper's host work is hidden (the headline
  ``updates_per_sec`` is the kernel's);
* ``call_us`` — a whole wrapper call as its caller waits for it (host
  clock, synchronized), the wrapper's host work included;
* ``plain_us`` — its plain PyTorch version on the same inputs, timed so;
* ``bound_us`` — the byte bound: each input read once and each output
  written once, at 3.35 TB/s (H100 SXM HBM3);
* ``library_us`` — one PyTorch call computing the same function where there
  is one (``index_add_`` of the live prefix for ``scatter_add``), else
  ``null`` with ``library_reason``;
* ``bit_identical`` — the kernel's output equals its plain version's on the
  same inputs, bit for bit (a false one ends the section with an error).

On the CPU (tests) the wrappers take their plain versions and the times are
host times of those.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.reporting import BenchmarkReport
from repro_torch.core import assoc
from repro_torch.kernels.scatter_add import ops as scatter_ops

from . import _common

ENTRY_BYTES = 12  # int32 row + int32 col + float32 value
NO_LIBRARY = {
    "merge_add": "no single PyTorch call merges two sorted lists with a semiring fold",
    "sort_dedup": "no single PyTorch call sorts triples and folds duplicate keys",
}


def _triples(rng, n, space, dev):
    r = torch.from_numpy(rng.integers(0, space, n).astype(np.int32)).to(dev)
    c = torch.from_numpy(rng.integers(0, space, n).astype(np.int32)).to(dev)
    return r, c, torch.ones(n, dtype=torch.float32, device=dev)


def _add(report, name, params, n_updates, kernel_us, call_us, plain_us, nbytes, launches,
         library_us=None, **extra):
    bound_us = nbytes / _common.HBM_BYTES_PER_S * 1e6
    lib = {"library_us": library_us}
    if library_us is None:
        lib["library_reason"] = NO_LIBRARY[name]
    report.add(
        name,
        params=params,
        updates_per_sec=n_updates / (kernel_us / 1e6),
        wall_s=kernel_us / 1e6,
        kernel_us=kernel_us,
        call_us=call_us,
        plain_us=plain_us,
        bound_us=bound_us,
        bound_by="bytes",
        bytes=int(nbytes),
        launches=launches,
        **lib,
        **extra,
    )
    return bound_us


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes and bits (float values compared as their bit patterns)."""
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int16 if a.element_size() == 2 else torch.int32), \
            b.view(torch.int16 if b.element_size() == 2 else torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def assoc_same(a: assoc.Assoc, b: assoc.Assoc) -> bool:
    return all(_same(getattr(a, f), getattr(b, f))
               for f in ("rows", "cols", "vals", "nnz", "overflow"))


def bench_merge(n: int, report: BenchmarkReport, dev: torch.device):
    rng = np.random.default_rng(0)
    a = assoc.from_triples(*_triples(rng, n, 10 * n, dev), cap=n)
    b = assoc.from_triples(*_triples(rng, n, 10 * n, dev), cap=n)
    before = _common.launch_counts()
    us = _common.time_kernel_us(lambda: assoc.add(a, b, cap=2 * n), dev)
    call_us = _common.time_host_us(lambda: assoc.add(a, b, cap=2 * n), dev, reps=10)
    launches = _common.launches_since(before)
    out = assoc.add(a, b, cap=2 * n)
    plain_us = _common.time_host_us(lambda: assoc.add_plain(a, b, cap=2 * n), dev)
    same = assoc_same(out, assoc.add_plain(a, b, cap=2 * n))
    # the live entries of both inputs read, the whole 2n-wide output written
    nbytes = ENTRY_BYTES * (int(a.nnz) + int(b.nnz) + 2 * n)
    bound = _add(report, "merge_add", {"n": n}, 2 * n, us, call_us, plain_us, nbytes, launches,
                 bit_identical=same)
    print(f"merge_add,n={n},kernel_us={us:.1f},call_us={call_us:.1f},plain_us={plain_us:.0f},"
          f"bound_us={bound:.2f},bit_identical={same}", flush=True)
    return [] if same else [f"merge_add n={n}: the kernel's sum differs from add_plain's"]


def bench_sort(shape, report: BenchmarkReport, dev: torch.device):
    """``sort_dedup`` on ``shape`` (``[n]``, or ``[K, n]``: K independent
    batches in one call) of uniform triples over n keys."""
    shape = tuple(int(x) for x in shape)
    n = shape[-1]
    rng = np.random.default_rng(1)
    r, c, v = (x.reshape(shape) for x in _triples(rng, int(np.prod(shape)), n, dev))
    before = _common.launch_counts()
    us = _common.time_kernel_us(lambda: assoc.from_triples(r, c, v, cap=n), dev)
    call_us = _common.time_host_us(lambda: assoc.from_triples(r, c, v, cap=n), dev, reps=10)
    launches = _common.launches_since(before)
    out = assoc.from_triples(r, c, v, cap=n)
    plain_us = _common.time_host_us(lambda: assoc.from_triples_plain(r, c, v, cap=n), dev)
    same = assoc_same(out, assoc.from_triples_plain(r, c, v, cap=n))
    nbytes = ENTRY_BYTES * 2 * r.numel()  # the triples read, an output as wide written
    params = {"n": n} if len(shape) == 1 else {"n": n, "k": shape[0]}
    bound = _add(report, "sort_dedup", params, r.numel(), us, call_us, plain_us, nbytes,
                 launches, bit_identical=same)
    print(f"sort_dedup,shape={list(shape)},kernel_us={us:.1f},call_us={call_us:.1f},"
          f"plain_us={plain_us:.0f},bound_us={bound:.2f},bit_identical={same}", flush=True)
    return [] if same else [f"sort_dedup {list(shape)}: the kernel's output differs from "
                            f"from_triples_plain's"]


def bench_scatter(v: int, d: int, k: int, report: BenchmarkReport, dev: torch.device):
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(np.sort(rng.choice(v, k, replace=False)).astype(np.int32)).to(dev)
    rows = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(dev)
    want = scatter_ops.scatter_add_plain(ids, rows, table.clone())
    got = scatter_ops.scatter_add(ids, rows, table.clone())
    same = _same(got, want)
    del got, want
    before = _common.launch_counts()
    us = _common.time_kernel_us(lambda: scatter_ops.scatter_add(ids, rows, table), dev)
    call_us = _common.time_host_us(lambda: scatter_ops.scatter_add(ids, rows, table), dev, reps=10)
    launches = _common.launches_since(before)
    plain_us = _common.time_host_us(lambda: scatter_ops.scatter_add_plain(ids, rows, table), dev)
    lib_us = _common.time_kernel_us(lambda: table.index_add_(0, ids, rows), dev)
    # the dense equivalent touches every row of the table
    full = torch.zeros_like(table)
    dense_us = _common.time_kernel_us(lambda: table + full, dev)
    del full
    # per id: the table row read and written, the row read; the ids read once
    nbytes = k * d * 4 * 3 + k * 4
    bound = _add(report, "scatter_add", {"V": v, "d": d, "k": k}, k, us, call_us, plain_us,
                 nbytes, launches, library_us=lib_us, dense_equiv_us=dense_us, bytes_ratio=v / k,
                 bit_identical=same)
    print(f"scatter_add,V={v},d={d},k={k},kernel_us={us:.1f},call_us={call_us:.1f},"
          f"plain_us={plain_us:.0f},"
          f"bound_us={bound:.2f},index_add_us={lib_us:.1f},dense_equiv_us={dense_us:.1f},"
          f"bytes_ratio={v / k:.0f}x,bit_identical={same}", flush=True)
    return [] if same else [f"scatter_add V={v} d={d} k={k}: the kernel's table differs from "
                            f"scatter_add_plain's"]


def main(smoke: bool = False, merge_sizes=None, sort_shapes=None, scatter_shapes=None,
         device: str = "cuda"):
    """Each kernel at the reference's sizes, or at those named:
    ``merge_sizes`` (n: two n-wide sums into 2n), ``sort_shapes`` (``[n]``
    or ``[K, n]``), ``scatter_shapes`` (``[V, d, k]``)."""
    dev = _common.device_of(device)
    report = BenchmarkReport("kernels", device=str(dev))
    if merge_sizes is None:
        merge_sizes = (1 << 10,) if smoke else (1 << 10, 1 << 14, 1 << 17)
    if sort_shapes is None:
        sort_shapes = [(1 << 10,)] if smoke else [(1 << 10,), (1 << 14,)]
    if scatter_shapes is None:
        scatter_shapes = [(32_000, 512, 1024)] if smoke else [(32_000, 512, 1024),
                                                              (262_144, 512, 4096)]
    failures = []
    for n in merge_sizes:
        failures += bench_merge(int(n), report, dev)
        _common.release(dev)
    for shape in sort_shapes:
        failures += bench_sort(shape, report, dev)
        _common.release(dev)
    for v, d, k in scatter_shapes:
        failures += bench_scatter(int(v), int(d), int(k), report, dev)
        _common.release(dev)
    report.write()
    _common.raise_failures("kernels", failures)


if __name__ == "__main__":
    main()
