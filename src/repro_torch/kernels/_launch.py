"""What the wrappers of the port's ``merge_add`` and ``sort_dedup`` kernels
share: argument checks, the value-type code, the zero's bits and the
flattening of leading batch axes."""
from __future__ import annotations

import functools

import torch

#: value type -> the dtype code the CUDA entry points take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT32_LIMIT = 2**31 - 1
#: entries of one tile of the kernels' block scans (csrc/tiles.cuh kTile)
TILE = 4096


def n_tiles(n: int) -> int:
    """Tiles of one group of width ``n``."""
    return -(-int(n) // TILE)


def dtype_code(vals: torch.Tensor, kernel: str) -> int:
    if vals.dtype not in DTYPE_CODES:
        raise NotImplementedError(
            f"the {kernel} kernel takes float32 and bfloat16 values, got {vals.dtype}"
        )
    return DTYPE_CODES[vals.dtype]


@functools.lru_cache(maxsize=None)
def zero_bits(zero: float, dtype: torch.dtype) -> int:
    """The bits of ``zero`` in ``dtype`` as PyTorch writes them (what
    ``torch.full`` fills a dead slot with), as an unsigned int."""
    t = torch.full((), zero, dtype=dtype)
    if dtype == torch.bfloat16:
        return int(t.view(torch.int16).item()) & 0xFFFF
    return int(t.view(torch.int32).item()) & 0xFFFFFFFF


def check_cuda(kernel: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{kernel} needs tensors on one CUDA device")
    return dev


def flat(x: torch.Tensor, groups: int, width: int, dtype: torch.dtype) -> torch.Tensor:
    """``[..., width]`` as a contiguous ``[groups, width]`` of ``dtype``."""
    return x.to(dtype).reshape(groups, width).contiguous()


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def raise_on(err: int, lib, prefix: str, kernel: str) -> None:
    if err != 0:
        msg = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
