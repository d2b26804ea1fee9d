"""The benchmark's stream generator: Graph500 R-MAT edges drawn on the device
from the run's seed.

A frozen copy of ``repro_torch.data.rmat.rmat_edges_torch``, kept here so
that no change to the program changes the traffic.  One uniform draw per
edge and scale bit picks the quadrant with probabilities ``a, b, c`` and
``d = 1 - a - b - c``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rmat_edges(
    gen: torch.Generator,
    shape: Tuple[int, ...],
    scale: int,
    a: float,
    b: float,
    c: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 ``(src, dst)`` of ``shape``, vertices in ``[0, 2**scale)``."""
    src = torch.zeros(shape, dtype=torch.int32, device=gen.device)
    dst = torch.zeros_like(src)
    for _ in range(scale):
        r = torch.rand(shape, generator=gen, device=gen.device)
        src = src * 2 + (r >= a + b)
        dst = dst * 2 + (((r >= a) & (r < a + b)) | (r >= a + b + c))
    return src, dst


def epoch(traffic: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One epoch of the traffic mix: ``[epoch_groups, group_size]`` source,
    destination (int32) and weight (float32) tensors on ``device``, the
    same for the same seed."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    shape = (int(traffic["epoch_groups"]), int(traffic["group_size"]))
    src, dst = rmat_edges(gen, shape, int(traffic["scale"]),
                          float(traffic["a"]), float(traffic["b"]), float(traffic["c"]))
    vals = torch.full(shape, float(traffic["weight"]), dtype=torch.float32, device=src.device)
    return src, dst, vals
