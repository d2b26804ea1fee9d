"""Graph500-style R-MAT power-law edge streams (port of ``repro.data.rmat``).

Drawn with a numpy ``Generator``, so the bits differ from the reference's
threefry stream; parity tests feed both packages the same numpy triples.
Quadrant probabilities follow Graph500: a=0.57, b=0.19, c=0.19, d=0.05.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch


def rmat_edges(
    rng: np.random.Generator,
    n_edges: int,
    scale: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> Tuple[np.ndarray, np.ndarray]:
    """``n_edges`` edges of a ``2**scale``-vertex R-MAT graph: one uniform
    draw per edge and scale bit picks the quadrant.  Returns int32 arrays."""
    src = np.zeros(n_edges, np.int32)
    dst = np.zeros(n_edges, np.int32)
    for _ in range(scale):
        r = rng.random(n_edges, dtype=np.float32)
        src_bit = r >= a + b  # quadrants c, d
        dst_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src = src * 2 + src_bit
        dst = dst * 2 + dst_bit
    return src, dst


def edge_stream(
    rng: np.random.Generator,
    total_edges: int,
    group_size: int,
    scale: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield ``total_edges // group_size`` groups of (src, dst, val=1)."""
    for _ in range(total_edges // group_size):
        s, d = rmat_edges(rng, group_size, scale, a, b, c)
        yield s, d, np.ones(group_size, np.float32)


def rmat_edges_torch(
    gen: torch.Generator,
    shape: Tuple[int, ...],
    scale: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rmat_edges` drawn with a torch ``Generator`` on its device:
    int32 ``(src, dst)`` tensors of ``shape``, the same quadrant rule with
    other bits.  For streams too large to draw on the host in a run."""
    src = torch.zeros(shape, dtype=torch.int32, device=gen.device)
    dst = torch.zeros_like(src)
    for _ in range(scale):
        r = torch.rand(shape, generator=gen, device=gen.device)
        src = src * 2 + (r >= a + b)
        dst = dst * 2 + (((r >= a) & (r < a + b)) | (r >= a + b + c))
    return src, dst


def stream_tensor(
    gen_or_seed, n_groups: int, group_size: int, scale: int, device=None, **kw
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A ``[n_groups, group_size]`` stream (src, dst int32; val float32
    ones) for ingesting in one pass, drawn by :func:`rmat_edges_torch`
    with ``gen_or_seed`` (a torch ``Generator``, on whose device the
    stream lies, or an int seed for a generator on ``device``: ``cuda``
    unless given).  ``kw``: the quadrant probabilities ``a``, ``b``,
    ``c``."""
    gen = gen_or_seed
    if not isinstance(gen, torch.Generator):
        from repro_torch.device import resolve_device

        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(gen_or_seed))
    src, dst = rmat_edges_torch(gen, (n_groups, group_size), scale, **kw)
    return src, dst, torch.ones((n_groups, group_size), dtype=torch.float32, device=gen.device)
