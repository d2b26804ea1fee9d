"""``from_triples`` and its fold stage through the ``sort_dedup`` kernel.

Port of ``repro/kernels/sort_dedup/ops.py``.  Two entry points, each
taking leading batch axes (one group per batch index):

* :func:`from_triples`, the drop-in equivalent of ``assoc.from_triples``
  (the JAX wrapper's signature): a stable lexicographic sort of the
  triples, then a fold of each run of equal keys;
* :func:`combine_sorted`, the fold-and-compact stage alone for triples
  whose equal keys are already adjacent (``assoc._combine_sorted``: the
  degrees, ``reduce_rows/cols``, ``extract_row``, ``elem_mul``).

Each returns exactly what its plain PyTorch version returns, values
included (:func:`repro_torch.core.assoc.from_triples_plain` and
:func:`repro_torch.core.assoc.combine_sorted_plain`): the fold replays
``lax.associative_scan``'s bracketing run by run.

The kernel (``repro_torch/csrc/sort_dedup.cu``) replaces the TPU kernel
``repro/kernels/sort_dedup/kernel.py:50`` (``sort_dedup_pallas``).  It is
bound by bytes: at least each input triple read once and each live output
entry written once (12 B each in float32).  The sort is a merge sort:
tiles of 4096 entries sorted in shared memory (a stable block radix sort on
the packed 64-bit key, carrying the input index), then one merge round per
doubling of the run width, each entry placed by a binary search in its
partner run; each round reads and writes 12 B an entry.  The fold gives
one thread to each run end, which folds its run in O(run + log n) (see the
note at the top of the source).  Values are float32 or bfloat16; other
types raise ``NotImplementedError``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.assoc import Assoc, combine_sorted_plain, from_triples_plain
from repro_torch.core.semiring import PLUS_TIMES, Semiring

from .. import _build, _launch

#: wrapper calls that launched the kernel (both entry points; the chip
#: smoke test zeroes it)
launch_count = 0


def _lib():
    lib = _build.load("sort_dedup")
    if lib.sort_dedup_from_triples.argtypes is None:
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.sort_dedup_from_triples.argtypes = (
            [ctypes.c_int, i64, i64] + [vp] * 9 + [i64] + [vp] * 6
            + [ctypes.c_int, ctypes.c_uint32, vp]
        )
        lib.sort_dedup_from_triples.restype = ctypes.c_int
        lib.sort_dedup_combine.argtypes = (
            [ctypes.c_int, i64, i64] + [vp] * 8 + [i64] + [vp] * 3
            + [ctypes.c_int, ctypes.c_uint32, vp]
        )
        lib.sort_dedup_combine.restype = ctypes.c_int
        lib.sort_dedup_error_string.argtypes = [ctypes.c_int]
        lib.sort_dedup_error_string.restype = ctypes.c_char_p
    return lib


def from_triples(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    cap: int,
    sr: Semiring = PLUS_TIMES,
    valid: torch.Tensor | None = None,
) -> Assoc:
    """Build an Assoc from unsorted triples with duplicates; equal keys fold
    with ``sr.add``; ``valid`` masks input slots."""
    if rows.device.type == "cpu":
        return from_triples_plain(rows, cols, vals, cap, sr, valid)
    return _launch_kernel(rows, cols, vals, cap, sr, valid, sort=True)


def combine_sorted(rows, cols, vals, cap: int, sr: Semiring = PLUS_TIMES) -> Assoc:
    """Fold each run of equal adjacent keys with ``sr.add`` and compact the
    survivors to ``cap``; PAD keys drop.  Equal live keys must be adjacent
    (sorted triples, or sorted unique keys with PAD holes)."""
    if rows.device.type == "cpu":
        return combine_sorted_plain(rows, cols, vals, cap, sr)
    return _launch_kernel(rows, cols, vals, cap, sr, None, sort=False)


def _outputs(batch, cap, dtype, dev) -> Assoc:
    return Assoc(
        rows=torch.empty(batch + (cap,), dtype=torch.int32, device=dev),
        cols=torch.empty(batch + (cap,), dtype=torch.int32, device=dev),
        vals=torch.empty(batch + (cap,), dtype=dtype, device=dev),
        nnz=torch.empty(batch, dtype=torch.int32, device=dev),
        overflow=torch.empty(batch, dtype=torch.bool, device=dev),
    )


def _launch_kernel(rows, cols, vals, cap, sr, valid, *, sort: bool) -> Assoc:
    global launch_count
    cap = int(cap)
    n = rows.shape[-1]
    batch = rows.shape[:-1]
    if cols.shape != rows.shape or vals.shape != rows.shape:
        raise ValueError(f"rows, cols and vals must share a shape, got "
                         f"{tuple(rows.shape)}, {tuple(cols.shape)}, {tuple(vals.shape)}")
    code = _launch.dtype_code(vals, "sort_dedup")
    extra = () if valid is None else (valid,)
    dev = _launch.check_cuda("sort_dedup", rows, cols, vals, *extra)
    g = 1
    for d in batch:
        g *= int(d)
    if max(n, cap) > _launch.INT32_LIMIT or g * max(n, 1) > _launch.INT32_LIMIT:
        raise ValueError("sort_dedup takes widths and group sizes below 2**31")
    out = _outputs(batch, cap, vals.dtype, dev)
    if g == 0:
        return out
    r = _launch.flat(rows, g, n, torch.int32)
    c = _launch.flat(cols, g, n, torch.int32)
    v = _launch.flat(vals, g, n, vals.dtype)
    tiles = g * _launch.n_tiles(n)
    counts = torch.empty(2 * tiles + 1, dtype=torch.int32, device=dev)
    counts, off = torch.split(counts, [tiles, tiles + 1])
    outs = (out.rows, out.cols, out.vals, out.nnz, out.overflow)
    lib = _lib()
    common = (sr.fold, _launch.zero_bits(sr.zero, vals.dtype), _launch.stream(dev))
    if sort:
        ok = None if valid is None else _launch.flat(valid, g, n, torch.bool)
        keys = torch.empty((2, g * n), dtype=torch.int64, device=dev)
        idx = torch.empty((2, g * n), dtype=torch.int32, device=dev)
        err = lib.sort_dedup_from_triples(
            code, g, n, r.data_ptr(), c.data_ptr(), v.data_ptr(),
            None if ok is None else ok.data_ptr(),
            *(t.data_ptr() for t in outs), cap,
            keys[0].data_ptr(), keys[1].data_ptr(), idx[0].data_ptr(), idx[1].data_ptr(),
            counts.data_ptr(), off.data_ptr(), *common,
        )
    else:
        keys = torch.empty(g * n, dtype=torch.int64, device=dev)
        err = lib.sort_dedup_combine(
            code, g, n, r.data_ptr(), c.data_ptr(), v.data_ptr(),
            *(t.data_ptr() for t in outs), cap,
            keys.data_ptr(), counts.data_ptr(), off.data_ptr(), *common,
        )
    _launch.raise_on(err, lib, "sort_dedup", "sort_dedup")
    launch_count += 1
    return out
