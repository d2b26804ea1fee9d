"""``table[ids] += rows`` through the ``scatter_add`` kernel.

Port of ``repro/kernels/scatter_add/ops.py``.  :func:`scatter_add` updates
``table`` in place and returns it, as the reference donates the table's
buffer.  ``ids`` are int32 ``[k]``, sorted and unique, with ``PAD``
(``2**31 - 1``) in dead slots; ``rows`` are ``[k, d]`` and ``table`` is
``[V, d]``, each float32, bfloat16 or float16.  The result is what the reference's
oracle ``scatter_add_ref`` computes, bit for bit (see
:func:`scatter_add_plain`): rows cast to the table's type, then added; a
negative id wraps to ``V + id``; an id still outside ``[0, V)`` drops; and
whenever ``ids`` hold a PAD, row 0 becomes ``row 0 + 0.0`` after its live
add (ROADMAP C10: the oracle sends every PAD slot to row 0 with a masked
``+0.0``; the TPU kernel skips PAD slots instead).

The kernel (``repro_torch/csrc/scatter_add.cu``) replaces the TPU kernel
``repro/kernels/scatter_add/kernel.py:45`` (``scatter_add_pallas``).  It is
bound by bytes: per live id one table row read and written and one row
read.  One block owns one table row at a time and its threads split the
columns (16-byte vectors where ``d % 8 == 0`` and both buffers are 16-byte
aligned); the ids are unique, so there are no atomics.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.assoc import PAD

from .. import _build, _launch

#: the table and row types the kernel takes
TYPES = (torch.float32, torch.bfloat16, torch.float16)
#: wrapper calls that launched the kernel (the chip smoke test zeroes it)
launch_count = 0


def _lib():
    lib = _build.load("scatter_add")
    if lib.scatter_add_run.argtypes is None:
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.scatter_add_run.argtypes = [
            ctypes.c_int, ctypes.c_int, vp, vp, vp, i64, i64, i64, ctypes.c_int, vp,
        ]
        lib.scatter_add_run.restype = ctypes.c_int
        lib.scatter_add_error_string.argtypes = [ctypes.c_int]
        lib.scatter_add_error_string.restype = ctypes.c_char_p
    return lib


def scatter_add(ids: torch.Tensor, rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[ids] += rows`` in place (PAD slots add ``+0.0`` to row 0);
    returns ``table``."""
    if table.device.type == "cpu":
        return scatter_add_plain(ids, rows, table)
    return scatter_add_kernel(ids, rows, table)


def scatter_add_plain(ids: torch.Tensor, rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch :func:`scatter_add`: the reference's
    ``table.at[where(live, ids, 0)].add(where(live, rows, 0).astype(
    table.dtype))`` with its duplicate indices taken apart, so that no
    add depends on the order of an atomic: the wrapped negative ids first
    (their slots come first in the sorted ids), then the others, then row
    0's ``+ 0`` for the PAD slots, which come last."""
    nrows = table.shape[0]
    ids = ids.to(torch.int64)
    idx = torch.where(ids < 0, ids + nrows, ids)
    ok = (ids != PAD) & (idx >= 0) & (idx < nrows)
    for sel in (ok & (ids < 0), ok & (ids >= 0)):
        at = idx[sel]
        table[at] = table[at] + rows[sel].to(table.dtype)
    if nrows and bool((ids == PAD).any()):
        table[0] = table[0] + 0
    return table


def scatter_add_kernel(ids: torch.Tensor, rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (``ids`` must be sorted and unique)."""
    global launch_count
    if ids.dtype != torch.int32 or ids.ndim != 1:
        raise ValueError(f"scatter_add takes int32 ids [k], got {ids.dtype} {tuple(ids.shape)}")
    k = ids.shape[0]
    if table.ndim != 2 or rows.shape != (k, table.shape[1]):
        raise ValueError(
            f"scatter_add takes rows [k, d] and a table [V, d], got {tuple(rows.shape)} "
            f"and {tuple(table.shape)} for k={k}"
        )
    if not table.is_contiguous():
        raise ValueError("scatter_add updates the table in place: it must be contiguous")
    t_code = _launch.dtype_code(table, "scatter_add", TYPES)
    r_code = _launch.dtype_code(rows, "scatter_add", TYPES)
    dev = _launch.check_cuda("scatter_add", ids, rows, table)
    nrows, d = table.shape
    if nrows >= _launch.INT32_LIMIT:
        raise ValueError("scatter_add takes tables of fewer than 2**31 - 1 rows")
    if k == 0 or nrows == 0 or d == 0:
        return table  # nothing to add: no launch
    ids, rows = ids.contiguous(), rows.contiguous()
    vectors = d % 8 == 0 and rows.data_ptr() % 16 == 0 and table.data_ptr() % 16 == 0
    lib = _lib()
    with torch.cuda.device(dev):  # the entry launches on the current device
        err = lib.scatter_add_run(
            t_code, r_code, ids.data_ptr(), rows.data_ptr(), table.data_ptr(),
            k, nrows, d, int(vectors), _launch.stream(dev),
        )
    _launch.raise_on(err, lib, "scatter_add", "scatter_add")
    launch_count += 1
    return table
