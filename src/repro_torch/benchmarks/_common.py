"""What the port's bench sections share: the device and its clock, the
kernels' launch counters, and the served sessions' configuration."""
from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch import d4m
from repro_torch.device import resolve_device

#: H100 SXM HBM3 (NVIDIA's data sheet): the rate every byte bound divides by
HBM_BYTES_PER_S = 3.35e12


def kernel_modules() -> Dict[str, object]:
    """The four kernels' wrapper modules, whose ``launch_count`` each
    wrapper raises by one where it launches its kernel."""
    from repro_torch.kernels.hier_cascade import ops as hc
    from repro_torch.kernels.merge_add import ops as ma
    from repro_torch.kernels.scatter_add import ops as sa
    from repro_torch.kernels.sort_dedup import ops as sd

    return {"hier_cascade": hc, "merge_add": ma, "scatter_add": sa, "sort_dedup": sd}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launch_count for name, mod in kernel_modules().items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Kernel launches in this process since ``before`` (a
    :func:`launch_counts`); 0 on the CPU, where the wrappers take their
    plain versions."""
    return {name: n - before[name] for name, n in launch_counts().items()}


def add_launches(total: Dict[str, int], more: Dict[str, int]) -> Dict[str, int]:
    return {name: total.get(name, 0) + more.get(name, 0) for name in {**total, **more}}


def device_of(device: str | torch.device | None) -> torch.device:
    """The section's device: the card unless ``"cpu"`` is asked for; CUDA
    asked for without CUDA raises."""
    return resolve_device(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: a spin of the card (~5 ms at H100 clocks) queued ahead of each timed
#: kernel call, so the wrapper's host work overlaps it and the events
#: around the call time the kernel alone
SLEEP_CYCLES = 10_000_000


def time_kernel_us(fn: Callable[[], object], device: torch.device, reps: int = 10) -> float:
    """Mean microseconds of ``fn`` on the device, after a warm-up call
    (which builds a kernel at first use): on the card between CUDA events
    around each call, each queued behind a spin of the card; on the CPU on
    the host clock."""
    fn()
    if device.type != "cuda":
        return time_host_us(fn, device, reps)
    torch.cuda.synchronize(device)
    marks = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize(device)
    return float(np.mean([s.elapsed_time(e) for s, e in marks])) * 1e3


def time_host_us(fn: Callable[[], object], device: torch.device, reps: int = 3) -> float:
    """Mean microseconds of ``fn`` on the host clock, synchronized on both
    sides of each call (what a caller waits; for the plain versions, whose
    many small launches wait on the host)."""
    fn()
    out = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        out.append(time.perf_counter() - t0)
    return float(np.mean(out)) * 1e6


def _pack(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """int64 keys that order like the ``(row, col)`` pair of non-negative
    int32s (as ``assoc.pack_keys`` orders them)."""
    return (rows.astype(np.int64) << 32) | (cols.astype(np.int64) & 0xFFFFFFFF)


def key_counts(rows: np.ndarray, cols: np.ndarray):
    """numpy's distinct (row, col) keys of a stream, in key order, and how
    many records carry each: what an exact store of the stream holds when
    every record's value is 1."""
    keys = _pack(rows, cols).ravel()
    keys.sort()
    first = np.ones(keys.size, dtype=bool)
    first[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(first)
    return keys[starts], np.diff(np.append(starts, keys.size))


def distinct_keys(rows: np.ndarray, cols: np.ndarray) -> int:
    """numpy's count of distinct (row, col) keys: the nnz an exact store of
    the stream must hold."""
    return int(key_counts(rows, cols)[0].size)


def holds_counts(snap, want) -> bool:
    """Whether a snapshot of a stream of unit values holds exactly the keys
    of ``want = key_counts(...)``, in key order, each with its count of
    records as its value."""
    keys, counts = want
    n = int(snap.nnz)
    if n != keys.size:
        return False
    got = _pack(snap.rows[:n].cpu().numpy(), snap.cols[:n].cpu().numpy())
    vals = snap.vals[:n].float().cpu().numpy()
    return bool(np.array_equal(got, keys) and np.array_equal(vals, counts.astype(np.float32)))


def release(device: torch.device) -> None:
    """Free the state of the sessions dropped so far now: they hold
    reference cycles, so their device memory waits for the cycle
    collector otherwise."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def rmat_records(batches: int, batch: int, scale: int, seed: int = 0):
    """``batches * batch`` R-MAT records (``serve.RMATSource``, drawn up
    front), as flat host arrays."""
    from repro_torch import serve

    src = serve.RMATSource(batches * batch, chunk_records=batch, scale=scale, seed=seed,
                           pregenerate=True)
    rows, cols, vals = zip(*src.chunks())
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def stream_config(k: int, batch: int, top: int, records: int, cuts=None) -> d4m.StreamConfig:
    """The served sessions' configuration (the reference's
    ``bench_serve``/``bench_query``/``bench_obs``/``bench_fleet``): cuts at
    2 and 16 batches unless ``cuts`` names them; a snapshot holds the
    reference's 4 top capacities, or the stream's ``records`` where fewer
    (a stream has no more distinct keys than records, and at full width 4
    top capacities of 8 instances would hold a 64 M-wide snapshot for
    each of 4 fleet workers on one card)."""
    return d4m.StreamConfig(
        cuts=tuple(cuts) if cuts is not None else (2 * batch, 16 * batch),
        top_capacity=top,
        batch_size=batch,
        instances_per_device=k,
        snapshot_cap=min(4 * top, records),
    )


def raise_failures(section: str, failures: List[str]) -> None:
    """A correctness check that failed ends the section with an error (after
    its artifact is written, so the run can be read)."""
    if failures:
        raise RuntimeError(f"{section}: correctness failed: " + "; ".join(failures))
