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
entry written once (12 B each in float32).  The sort is a merge sort of
the live keys only: tiles of 4096 entries sorted in shared memory (a
stable block radix sort on the bits that vary among the tile's live keys;
dead keys last and dropped), then one merge round per doubling of the run
width, each a merge-path merge of the runs' live prefixes; each key
carries its value's bits.  The fold builds in shared memory the part of each tile's pair tree
that its run ends read, and a tree over tiles, and folds each run end from
at most ``2 log2(n)`` nodes in ``lax.associative_scan``'s bracketing: no
walk along a run (see the note at the top of the source).
``from_triples`` makes ``1 + ceil(log2(n / 4096)) + 2`` CUDA launches,
``combine_sorted`` 2, each a programmatic dependent launch (launched as the
kernel before it on the stream finishes).  Values are float32, bfloat16,
float16 or int32 (an int32 fold stays integer: plus wraps, no ``+ 0.0``);
other types raise ``NotImplementedError``.  The workspaces are
kept per device and stream between calls, so a call allocates only its
outputs.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.assoc import Assoc, combine_sorted_plain, from_triples_plain
from repro_torch.core.semiring import PLUS_TIMES, Semiring

from .. import _build, _launch

#: wrapper calls that launched the kernel (both entry points; the chip
#: smoke test zeroes it)
launch_count = 0
#: CUDA kernel launches those calls made, as the CUDA entries count them
cuda_launch_count = 0

#: (device index, stream) -> (work, zeroed): the kernel's workspaces, grown
#: as needed and kept between calls.  ``zeroed`` holds counters every call
#: leaves zero, so it is zeroed only when made.
_scratch: dict = {}


def _lib():
    lib = _build.load("sort_dedup")
    if lib.sort_dedup_from_triples.argtypes is None:
        vp, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        tail = [c_int, ctypes.c_uint32, ctypes.POINTER(c_int), vp]  # fold, zero, launches, stream
        lib.sort_dedup_from_triples.argtypes = [c_int, i64, i64] + [vp] * 9 + [i64] + [vp] * 2 + tail
        lib.sort_dedup_from_triples.restype = c_int
        lib.sort_dedup_combine.argtypes = [c_int, i64, i64] + [vp] * 8 + [i64] + [vp] * 2 + tail
        lib.sort_dedup_combine.restype = c_int
        lib.sort_dedup_workspace.argtypes = [i64, i64, c_int, ctypes.POINTER(i64)]
        lib.sort_dedup_workspace.restype = c_int
        lib.sort_dedup_error_string.argtypes = [c_int]
        lib.sort_dedup_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=256)
def workspace_bytes(groups: int, n: int, sort: bool) -> tuple:
    """Bytes ``(work, zeroed)`` of a call on ``groups`` groups of ``n``
    (``sort`` False: ``combine_sorted``), as the CUDA source lays them
    out."""
    lib = _lib()
    sizes = (ctypes.c_int64 * 2)()
    err = lib.sort_dedup_workspace(groups, n, int(sort), sizes)
    _launch.raise_on(err, lib, "sort_dedup", "sort_dedup")
    return tuple(sizes)


def workspace(dev: torch.device, stream: int, work_bytes: int, zeroed_bytes: int):
    """Device pointers ``(work, zeroed)`` of at least the given sizes for
    ``stream`` on ``dev``, kept from earlier calls where they are large
    enough (``zeroed`` is zero when made)."""
    key = (_launch.index(dev), stream)
    work, zeroed = _scratch.get(key, (None, None))
    if work is None or work.numel() < work_bytes:
        work = torch.empty(work_bytes, dtype=torch.uint8, device=dev)
    if zeroed is None or zeroed.numel() < zeroed_bytes:
        zeroed = torch.zeros(zeroed_bytes, dtype=torch.uint8, device=dev)
    _scratch[key] = (work, zeroed)
    return work.data_ptr(), zeroed.data_ptr()


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
    global launch_count, cuda_launch_count
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
    stream = _launch.stream(dev)
    work, zeroed = workspace(dev, stream, *workspace_bytes(g, n, sort))
    outs = (out.rows.data_ptr(), out.cols.data_ptr(), out.vals.data_ptr(),
            out.nnz.data_ptr(), out.overflow.data_ptr())
    lib = _lib()
    launches = ctypes.c_int(0)
    common = (sr.fold, _launch.zero_bits(sr.zero, vals.dtype), ctypes.byref(launches), stream)
    ok = None if valid is None else _launch.flat(valid, g, n, torch.bool).data_ptr()
    with torch.cuda.device(dev):  # the entry launches on the current device
        if sort:
            err = lib.sort_dedup_from_triples(
                code, g, n, r.data_ptr(), c.data_ptr(), v.data_ptr(), ok, *outs, cap,
                work, zeroed, *common,
            )
        else:
            err = lib.sort_dedup_combine(
                code, g, n, r.data_ptr(), c.data_ptr(), v.data_ptr(), *outs, cap,
                work, zeroed, *common,
            )
    cuda_launch_count += launches.value
    _launch.raise_on(err, lib, "sort_dedup", "sort_dedup")
    launch_count += 1
    return out
