"""Carry state between the JAX reference and the port.

Numpy in, numpy out: the leaves of a reference ``HierAssoc`` (each
``Assoc`` field as ``np.asarray``, plus ``cascades``) become the port's
:class:`~repro_torch.core.hierarchical.HierAssoc` and back, packed
(leading ``[K]`` axis) or not, power-of-two padded or not.  The sparse
side's state has its converters in :mod:`repro_torch.sparse.convert`.

Arrays are copied, so the port owns its buffers (its kernels update them
in place).  bfloat16 arrays (numpy's ``ml_dtypes``
type, as ``np.asarray`` of a JAX bfloat16 array gives them, or their raw
2-byte words, ``|V2``, as an npz checkpoint stores them) travel by their
bits.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .assoc import Assoc
from .hierarchical import HierAssoc


def _own(x, device, dtype=None) -> torch.Tensor:
    """An owned tensor copy of numpy ``x`` (bfloat16 by its bits)."""
    x = np.array(x, copy=True)
    if x.dtype.name == "bfloat16" or x.dtype == np.dtype("V2"):
        bits = torch.from_numpy(x.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(x, dtype=dtype, device=device)


def _np(x: torch.Tensor) -> np.ndarray:
    """An owned numpy copy of ``x`` (bfloat16 as ``ml_dtypes.bfloat16``)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes  # the reference's bfloat16 type; only needed here

        return x.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return x.numpy().copy()


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
        return _own(x, device, dtype)

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
        tuple(_np(x) for x in (l.rows, l.cols, l.vals, l.nnz, l.overflow))
        for l in h.layers
    ]
    return layers, _np(h.cascades)
