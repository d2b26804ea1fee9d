"""One packed update step through the lane-skipping cascade kernel.

Port of ``repro/kernels/hier_cascade/ops.py``.  :func:`cascade_update` is
the drop-in equivalent of :func:`repro_torch.core.multistream.packed_update`
for a packed hierarchy (``init_state``): bit-identical layers, nnz, cascade
counters and overflow flags, at a per-step cost that follows the lanes whose
cuts fire.  Unlike the TPU kernel it needs no power-of-two padding: a layer
buffer may have any width of at least its true capacity (the width is the
row stride), so the port keeps the true capacities.

The kernel (``repro_torch/csrc/hier_cascade.cu``) replaces the TPU kernel
``repro/kernels/hier_cascade/kernel.py:168`` (``hier_cascade_pallas``).  It
is bound by the bytes it moves: on a step without cascades, the live prefix
of layer 1 and the batch's live entries, read and written back.  Each merge
of a step runs over the whole card in merge-path tiles x K instances, out of
place into a scratch of the widest layer (kept with the state), copied
back; the lane skip is decided on the card, so a call makes no host sync
(see the note at the top of the source).  It takes float32, bfloat16, float16 and int32 values; other types
raise ``NotImplementedError``.

The wrapper dispatches on where the tensors lie: on the CPU it runs
:func:`cascade_step_plain`, the plain PyTorch version of the same step; on
the card it launches the kernel or raises.  Nothing falls back.  Like a
donated argument in the reference, the hierarchy passed in is consumed: its
layer buffers are updated in place and the returned hierarchy is the new
state.

The batch is canonicalized in front of the kernel with the same
``assoc.from_triples`` the other engines use, which on the card is the
``sort_dedup`` kernel (:mod:`repro_torch.kernels.sort_dedup`).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core import assoc, multistream
from repro_torch.core.assoc import PAD, Assoc
from repro_torch.core.hierarchical import HierAssoc, telescoped_caps
from repro_torch.core.semiring import PLUS_TIMES, Semiring

from repro_torch.device import resolve_device

from .. import _build, _launch, plain_active

#: kernel launches so far (the chip smoke test zeroes it around a run)
launch_count = 0
#: CUDA kernel launches those calls made, as the CUDA entry counts them
cuda_launch_count = 0

#: layer-1 rows buffer of a state -> its merged-layer scratch (rows, cols,
#: vals ``[K, max cap]``) and merge records ``[K, 2]``: kept while the
#: state lives, so a call allocates nothing
_scratch = WeakIdKeyDictionary()

MAX_LAYERS = 8


def canonical_batch(rows, cols, vals, sr: Semiring = PLUS_TIMES) -> Assoc:
    """``[K, B]`` raw triples -> ``[K]``-leading canonical Assoc of cap B."""
    return assoc.from_triples(rows, cols, vals, cap=rows.shape[-1], sr=sr)


def _check_layout(h: HierAssoc, caps: Sequence[int]) -> None:
    widths = [l.capacity for l in h.layers]
    if len(widths) != len(caps):
        raise ValueError(f"{len(caps)} caps for {len(widths)} layers")
    for q, cap in zip(widths, caps):
        if q < cap:
            raise ValueError(f"a layer buffer of width {q} cannot hold its cap {cap}")


def cascade_step_plain(
    bufs, nnz, cascades, overflow, batch: Assoc, cuts, caps, sr, merges=None
):
    """The plain PyTorch version of one kernel step, on the flat state
    (updated in place): a loop over lanes in cond form over
    ``assoc.add_plain`` (plain on every device).
    The Python ``if`` on each cut reads ``nnz`` back to the host; that sync
    is accepted here.

    ``merges``, when a list, receives one ``(n_dst, n_src, n_out, cleared)``
    tuple of live entry counts per merge the step performs: the data the
    kernel's byte bound is computed from."""

    def lane(i, k):
        r, c, v = bufs[i]
        return Assoc(r[k], c[k], v[k], nnz[k, i], overflow[k, i])

    def store(i, k, a: Assoc, n_src, cleared):
        r, c, v = bufs[i]
        if merges is not None:
            merges.append((int(nnz[k, i]), int(n_src), int(a.nnz), cleared))
        n = a.capacity
        r[k, :n], c[k, :n], v[k, :n] = a.rows, a.cols, a.vals
        nnz[k, i], overflow[k, i] = a.nnz, a.overflow

    for k in range(nnz.shape[0]):
        b = Assoc(batch.rows[k], batch.cols[k], batch.vals[k], batch.nnz[k], batch.overflow[k])
        store(0, k, assoc.add_plain(lane(0, k), b, cap=caps[0], sr=sr), b.nnz, False)
        for i, cut in enumerate(cuts):
            if int(nnz[k, i]) > cut:  # the lane skip, as a host-side branch
                merged = assoc.add_plain(lane(i + 1, k), lane(i, k), cap=caps[i + 1], sr=sr)
                store(i + 1, k, merged, nnz[k, i], True)
                r, c, v = bufs[i]
                r[k], c[k], v[k] = PAD, PAD, sr.zero_as(v.dtype)
                nnz[k, i], overflow[k, i] = 0, False
                cascades[k, i + 1] += 1


def _lib():
    lib = _build.load("hier_cascade")
    if lib.hier_cascade_step.argtypes is None:
        vp, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.hier_cascade_step.argtypes = [
            c_int, c_int, c_int, vp, vp, vp, vp, i64,
            ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(vp),
            ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i64),
            vp, vp, vp, vp, vp, vp, i64, vp, vp, vp, vp, vp, i64,
            c_int, ctypes.c_uint32, c_int, ctypes.POINTER(c_int), vp,
        ]
        lib.hier_cascade_step.restype = ctypes.c_int
        lib.hier_cascade_error_string.argtypes = [ctypes.c_int]
        lib.hier_cascade_error_string.restype = ctypes.c_char_p
    return lib


def _tiles(caps: Sequence[int], batch_width: int) -> int:
    """Tiles per instance of the widest merge of a step."""
    srcs = [batch_width] + list(caps[:-1])
    return max(_launch.merge_tiles(cap + src) for cap, src in zip(caps, srcs))


def _state_scratch(rows0: torch.Tensor, k: int, width: int, dt: torch.dtype):
    """The merged-layer scratch and merge records of the state whose layer-1
    rows buffer is ``rows0`` (made on its first call)."""
    s = _scratch.get(rows0)
    if s is None or s[0].shape != (k, width) or s[2].dtype != dt:
        dev = rows0.device
        s = (
            torch.empty((k, width), dtype=torch.int32, device=dev),
            torch.empty((k, width), dtype=torch.int32, device=dev),
            torch.empty((k, width), dtype=dt, device=dev),
            torch.empty((k, 2), dtype=torch.int64, device=dev),
        )
        _scratch[rows0] = s
    return s


def cascade_step_kernel(bufs, nnz, cascades, overflow, batch: Assoc, cuts, caps, sr):
    """Launch the CUDA kernel on the flat state (updated in place).  Reads
    nothing back from the card and, after the state's first call,
    allocates nothing."""
    global launch_count, cuda_launch_count
    k, n_layers = nnz.shape
    planes = [nnz, cascades, overflow, batch.rows, batch.cols, batch.vals, batch.nnz]
    planes += [t for layer in bufs for t in layer]
    dev = _launch.check_cuda("hier_cascade", *planes)
    if not all(t.is_contiguous() for t in planes):
        raise ValueError("hier_cascade needs contiguous tensors")
    dt = batch.vals.dtype
    code = _launch.dtype_code(batch.vals, "hier_cascade")
    if any(v.dtype != dt for _, _, v in bufs):
        raise ValueError("the batch and every layer need one value type")
    keys = [batch.rows, batch.cols, batch.nnz, nnz, cascades]
    keys += [t for r, c, _ in bufs for t in (r, c)]
    if any(t.dtype != torch.int32 for t in keys) or overflow.dtype != torch.bool:
        raise ValueError("keys, nnz and cascades must be int32 and overflow bool")
    if any(t.shape[0] != k for t in planes):
        raise ValueError(f"every plane needs a leading axis of {k} instances")
    if not 1 <= n_layers <= MAX_LAYERS or max(caps) >= 2**31:
        raise ValueError(f"hier_cascade takes 1..{MAX_LAYERS} layers of cap < 2**31")
    lib = _lib()
    b_width = batch.rows.shape[1]
    width, tiles = max(caps), _tiles(caps, b_width)
    out_rows, out_cols, out_vals, rec = _state_scratch(bufs[0][0], k, width, dt)
    splits, counts, offsets, done = _launch.merge_scratch(dev, k, tiles)
    launches = ctypes.c_int(0)

    def ptrs(ts):
        return (ctypes.c_void_p * n_layers)(*[t.data_ptr() for t in ts])

    def ints(xs):
        xs = list(xs) or [0]
        return (ctypes.c_int64 * len(xs))(*[int(x) for x in xs])

    with torch.cuda.device(dev):  # the entry launches on the current device
        err = lib.hier_cascade_step(
            code, k, n_layers,
            batch.rows.data_ptr(), batch.cols.data_ptr(), batch.vals.data_ptr(),
            batch.nnz.data_ptr(), b_width,
            ptrs([r for r, _, _ in bufs]), ptrs([c for _, c, _ in bufs]),
            ptrs([v for _, _, v in bufs]),
            ints(r.shape[1] for r, _, _ in bufs), ints(caps), ints(cuts),
            nnz.data_ptr(), cascades.data_ptr(), overflow.data_ptr(),
            out_rows.data_ptr(), out_cols.data_ptr(), out_vals.data_ptr(), width,
            splits, counts, offsets, rec.data_ptr(), done, tiles, sr.fold,
            _launch.zero_bits(sr.zero, dt), _launch.sm_count(_launch.index(dev)),
            ctypes.byref(launches), _launch.stream(dev),
        )
    cuda_launch_count += launches.value
    _launch.raise_on(err, lib, "hier_cascade", "hier_cascade")
    launch_count += 1


def cascade_step(
    h: HierAssoc,
    batch: Assoc,
    cuts: Sequence[int],
    caps: Sequence[int],
    sr: Semiring = PLUS_TIMES,
) -> HierAssoc:
    """One step on a canonical ``[K]``-leading batch.  CPU tensors, and
    CUDA tensors inside ``kernels.plain_versions()``, take the plain
    version; other CUDA tensors launch the kernel."""
    cuts = tuple(int(c) for c in cuts)
    caps = tuple(int(c) for c in caps)
    _check_layout(h, caps)
    bufs, nnz, cascades, overflow = multistream.flat_layer_state(h)
    # a malformed batch surfaces on layer 1 exactly as assoc.add would
    overflow[:, 0] |= batch.overflow
    if nnz.device.type == "cpu" or plain_active():
        cascade_step_plain(bufs, nnz, cascades, overflow, batch, cuts, caps, sr)
    elif nnz.device.type == "cuda":
        cascade_step_kernel(bufs, nnz, cascades, overflow, batch, cuts, caps, sr)
    else:
        raise ValueError(f"hier_cascade runs on cuda or cpu, got {nnz.device}")
    return multistream.from_flat_layer_state(bufs, nnz, cascades, overflow)


def cascade_update(
    h: HierAssoc,
    rows: torch.Tensor,  # [K, B] int32
    cols: torch.Tensor,
    vals: torch.Tensor,
    cuts: Sequence[int],
    caps: Sequence[int],
    sr: Semiring = PLUS_TIMES,
) -> HierAssoc:
    """One streaming update on every packed instance: canonicalize the
    batch, then :func:`cascade_step`.  ``caps`` are the true telescoped
    capacities (``telescoped_caps`` / ``StreamConfig.plan().layer_caps``)."""
    batch = canonical_batch(rows, cols, vals, sr)
    return cascade_step(h, batch, cuts, caps, sr)


def build_step(cuts: Sequence[int], caps: Sequence[int], sr: Semiring = PLUS_TIMES):
    """A ``(h, rows, cols, vals) -> h`` kernel step (consumes ``h``)."""
    cuts = tuple(int(c) for c in cuts)
    caps = tuple(int(c) for c in caps)

    def step(h: HierAssoc, rows, cols, vals) -> HierAssoc:
        return cascade_update(h, rows, cols, vals, cuts, caps, sr)

    return step


def init_state(
    n_instances: int,
    cuts: Sequence[int],
    top_capacity: int,
    batch_size: int,
    sr: Semiring = PLUS_TIMES,
    dtype=torch.float32,
    device=None,
) -> Tuple[HierAssoc, Tuple[int, ...]]:
    """Empty packed state + the true capacities to drive it with (on the
    card unless ``device="cpu"``)."""
    caps = telescoped_caps(tuple(int(c) for c in cuts), top_capacity, batch_size)
    h = multistream.init_packed(
        n_instances, cuts, top_capacity, batch_size, sr, dtype,
        device=resolve_device(device),
    )
    return h, caps
