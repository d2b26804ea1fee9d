"""What the wrappers of the port's kernels share: argument checks, the
value-type code, the zero's bits, the flattening of leading batch axes and
the merge kernels' tile scratch."""
from __future__ import annotations

import functools

import torch

from repro_torch.core.semiring import as_value

#: value type -> the dtype code the CUDA entry points take (csrc/value_types.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2, torch.float16: 3}
INT32_LIMIT = 2**31 - 1


def dtype_code(vals: torch.Tensor, kernel: str, types=tuple(DTYPE_CODES)) -> int:
    """The dtype code of ``vals``; a value type outside ``types`` (the
    kernel's) raises."""
    if vals.dtype not in types:
        names = ", ".join(str(t).removeprefix("torch.") for t in types)
        raise NotImplementedError(f"the {kernel} kernel takes {names} values, got {vals.dtype}")
    return DTYPE_CODES[vals.dtype]


@functools.lru_cache(maxsize=None)
def zero_bits(zero: float, dtype: torch.dtype) -> int:
    """The bits of ``zero`` in ``dtype`` as the port writes a dead slot
    (``torch.full`` of :func:`~repro_torch.core.semiring.as_value`), as an
    unsigned int."""
    t = torch.full((), as_value(zero, dtype), dtype=dtype)
    if dtype.itemsize == 2:
        return int(t.view(torch.int16).item()) & 0xFFFF
    return int(t.view(torch.int32).item()) & 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (sizes the merge
    kernels' grids)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


#: entries of a merge-path tile (csrc/merge.cuh kMergeTile)
MERGE_TILE = 2048


def merge_tiles(n: int) -> int:
    """Merge-path tiles of a merge of ``n`` entries (at least one)."""
    return max(1, -(-int(n) // MERGE_TILE))


#: (device index, stream) -> (work, done): the merge kernels' tile scratch,
#: grown as needed and kept between calls.  ``done`` holds the groups'
#: finish counters, zero between launches (each group's last block of the
#: count pass sets its own back to zero), so it is zeroed once, when made.
_merge_scratch: dict = {}


def merge_scratch(dev: torch.device, groups: int, tiles: int):
    """Device pointers ``(splits, counts, offsets, done)`` of tile scratch
    for ``groups`` merges of at most ``tiles`` tiles each (csrc/merge.cuh:
    splits ``[groups, tiles + 1]`` int2, counts ``[groups, tiles]`` int32,
    offsets ``[groups, tiles]`` int64, done ``[groups]`` int32), on ``dev``'s
    current stream.  Launches nothing unless it has to grow."""
    key = (index(dev), stream(dev))
    work, done = _merge_scratch.get(key, (None, None))
    n_off = groups * tiles
    n_split = groups * (tiles + 1)
    words = 2 * n_off + 2 * n_split + n_off  # int32 words
    if work is None or work.numel() < words:
        work = torch.empty(words, dtype=torch.int32, device=dev)
    if done is None or done.numel() < groups:
        done = torch.zeros(groups, dtype=torch.int32, device=dev)
    _merge_scratch[key] = (work, done)
    offsets = work.data_ptr()
    splits = offsets + 8 * n_off
    counts = splits + 8 * n_split
    return splits, counts, offsets, done.data_ptr()


def check_cuda(kernel: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{kernel} needs tensors on one CUDA device")
    return dev


def flat(x: torch.Tensor, groups: int, width: int, dtype: torch.dtype) -> torch.Tensor:
    """``[..., width]`` as a contiguous ``[groups, width]`` of ``dtype``."""
    return x.to(dtype).reshape(groups, width).contiguous()


def index(dev: torch.device) -> int:
    """The CUDA device index of ``dev``."""
    return dev.index if dev.index is not None else torch.cuda.current_device()


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def raise_on(err: int, lib, prefix: str, kernel: str) -> None:
    if err != 0:
        msg = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
