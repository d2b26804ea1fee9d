"""Carry a hierarchy's state between the JAX reference and the port.

Numpy in, numpy out: the leaves of a reference ``HierAssoc`` (each
``Assoc`` field as ``np.asarray``, plus ``cascades``) become the port's
:class:`~repro_torch.core.hierarchical.HierAssoc` and back, packed (leading
``[K]`` axis) or not, power-of-two padded or not.  Arrays are copied, so the
port owns its buffers (its kernel updates them in place).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .assoc import Assoc
from .hierarchical import HierAssoc


def hier_from_numpy(
    layers: Sequence[Tuple[np.ndarray, ...]],
    cascades: np.ndarray,
    device=None,
) -> HierAssoc:
    """``layers`` is one ``(rows, cols, vals, nnz, overflow)`` tuple per
    layer, ``cascades`` the counter array.  The state lands on the card
    unless ``device="cpu"``."""
    device = resolve_device(device)

    def own(x, dtype=None):
        return torch.tensor(np.array(x, copy=True), dtype=dtype, device=device)

    return HierAssoc(
        layers=tuple(
            Assoc(
                rows=own(r, torch.int32),
                cols=own(c, torch.int32),
                vals=own(v),
                nnz=own(n, torch.int32),
                overflow=own(o, torch.bool),
            )
            for r, c, v, n, o in layers
        ),
        cascades=own(cascades, torch.int32),
    )


def hier_to_numpy(h: HierAssoc):
    """``(layers, cascades)`` as numpy arrays, the inverse of
    :func:`hier_from_numpy`."""
    layers = [
        tuple(x.detach().cpu().numpy().copy() for x in (l.rows, l.cols, l.vals, l.nnz, l.overflow))
        for l in h.layers
    ]
    return layers, h.cascades.detach().cpu().numpy().copy()
