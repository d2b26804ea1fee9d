"""``C = A (+) B`` through the ``merge_add`` kernel.

Port of ``repro/kernels/merge_add/ops.py``.  :func:`merge_add` is the
drop-in equivalent of ``assoc.add``, which dispatches to it for CUDA
tensors: the same keys, values (bit for bit), ``nnz`` and overflow flags as
:func:`repro_torch.core.assoc.add_plain`, its plain PyTorch version.

The kernel (``repro_torch/csrc/merge_add.cu``) replaces the TPU kernel
``repro/kernels/merge_add/kernel.py:75`` (``merge_add_pallas``).  It is
bound by the bytes it moves: each live input entry read once and each
output entry written once (12 B an entry in float32, 10 B in bfloat16).
It reads only the live prefixes and spreads one merge over the whole card
in merge-path tiles (``csrc/merge.cuh``): one warp search per tile edge, a
merge of each tile in shared memory, a scan of the tiles' survivor counts
for their output offsets, and the fill of the dead tail; three launches
(see the note at the top of the source).  It takes leading batch axes (one group per batch index),
float32, bfloat16, float16 and int32 values (an int32 fold stays integer:
plus wraps, no ``+ 0.0``); other types raise ``NotImplementedError``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.assoc import Assoc, add_plain
from repro_torch.core.semiring import PLUS_TIMES, Semiring

from .. import _build, _launch

#: wrapper calls that launched the kernel (the chip smoke test zeroes it)
launch_count = 0
#: CUDA kernel launches those calls made, as the CUDA entry counts them
cuda_launch_count = 0


def _lib():
    lib = _build.load("merge_add")
    if lib.merge_add_run.argtypes is None:
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.merge_add_run.argtypes = (
            [ctypes.c_int, i64] + [vp] * 5 + [i64] + [vp] * 5 + [i64] + [vp] * 5
            + [i64] + [vp] * 4 + [i64, ctypes.c_int, ctypes.c_uint32, ctypes.c_int]
            + [ctypes.POINTER(ctypes.c_int), vp]
        )
        lib.merge_add_run.restype = ctypes.c_int
        lib.merge_add_error_string.argtypes = [ctypes.c_int]
        lib.merge_add_error_string.restype = ctypes.c_char_p
    return lib


def merge_add(a: Assoc, b: Assoc, cap: int | None = None, sr: Semiring = PLUS_TIMES) -> Assoc:
    """``C = A (+) B``: equal keys fold as ``sr.add(a, b)``; the result is
    truncated to ``cap`` (default ``a.capacity + b.capacity``)."""
    if a.rows.device.type == "cpu":
        return add_plain(a, b, cap, sr)
    return merge_add_kernel(a, b, cap, sr)


def merge_add_kernel(a: Assoc, b: Assoc, cap: int | None, sr: Semiring) -> Assoc:
    """Launch the CUDA kernel (inputs must hold the Assoc invariant)."""
    global launch_count, cuda_launch_count
    m, n = a.capacity, b.capacity
    cap = m + n if cap is None else int(cap)
    batch = a.rows.shape[:-1]
    if b.rows.shape[:-1] != batch:
        raise ValueError(f"batch axes differ: {tuple(batch)} and {tuple(b.rows.shape[:-1])}")
    if a.vals.dtype != b.vals.dtype:
        raise ValueError(f"value types differ: {a.vals.dtype} and {b.vals.dtype}")
    code = _launch.dtype_code(a.vals, "merge_add")
    dev = _launch.check_cuda(
        "merge_add", a.rows, a.cols, a.vals, a.nnz, a.overflow,
        b.rows, b.cols, b.vals, b.nnz, b.overflow,
    )
    g = 1
    for d in batch:
        g *= int(d)
    if max(m, n, cap) > _launch.INT32_LIMIT:
        raise ValueError("merge_add takes widths below 2**31")
    dt = a.vals.dtype
    out = Assoc(
        rows=torch.empty(batch + (cap,), dtype=torch.int32, device=dev),
        cols=torch.empty(batch + (cap,), dtype=torch.int32, device=dev),
        vals=torch.empty(batch + (cap,), dtype=dt, device=dev),
        nnz=torch.empty(batch, dtype=torch.int32, device=dev),
        overflow=torch.empty(batch, dtype=torch.bool, device=dev),
    )
    if g == 0:
        return out
    i32 = torch.int32
    ar, ac, av = (_launch.flat(x, g, m, t) for x, t in ((a.rows, i32), (a.cols, i32), (a.vals, dt)))
    br, bc, bv = (_launch.flat(x, g, n, t) for x, t in ((b.rows, i32), (b.cols, i32), (b.vals, dt)))
    a_nnz, b_nnz = (x.to(i32).reshape(g).contiguous() for x in (a.nnz, b.nnz))
    a_ov, b_ov = (x.to(torch.bool).reshape(g).contiguous() for x in (a.overflow, b.overflow))
    tiles = _launch.merge_tiles(m + n)
    splits, counts, offsets, done = _launch.merge_scratch(dev, g, tiles)
    lib = _lib()
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):  # the entry launches on the current device
        err = lib.merge_add_run(
            code, g,
            ar.data_ptr(), ac.data_ptr(), av.data_ptr(), a_nnz.data_ptr(), a_ov.data_ptr(), m,
            br.data_ptr(), bc.data_ptr(), bv.data_ptr(), b_nnz.data_ptr(), b_ov.data_ptr(), n,
            out.rows.data_ptr(), out.cols.data_ptr(), out.vals.data_ptr(),
            out.nnz.data_ptr(), out.overflow.data_ptr(), cap,
            splits, counts, offsets, done, tiles,
            sr.fold, _launch.zero_bits(sr.zero, dt), _launch.sm_count(_launch.index(dev)),
            ctypes.byref(launches), _launch.stream(dev),
        )
    cuda_launch_count += launches.value
    _launch.raise_on(err, lib, "merge_add", "merge_add")
    launch_count += 1
    return out
