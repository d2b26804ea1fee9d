"""Carry the sparse side's state between the JAX reference and the port.

Numpy in, numpy out:

* a reference ``RowAccum`` (``ids, rows, nnz, overflow``) and
  ``HierRowAccum`` (its layers plus ``cascades``) become the port's
  :mod:`repro_torch.sparse.row_accum` state and back;
* an embedding's ``{table, m, v}`` arrays become tensors and back.

As in :mod:`repro_torch.core.convert`, arrays are copied (the lazy AdamW
and ``scatter_add`` update them in place) and bfloat16 travels by its
bits.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.convert import _np, _own
from ..device import resolve_device
from .row_accum import HierRowAccum, RowAccum


def row_accum_from_numpy(ids, rows, nnz, overflow, device=None) -> RowAccum:
    """A reference ``RowAccum``'s leaves as the port's
    :class:`~repro_torch.sparse.row_accum.RowAccum`, on the card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    return RowAccum(
        ids=_own(ids, device, torch.int32),
        rows=_own(rows, device),
        nnz=_own(nnz, device, torch.int32),
        overflow=_own(overflow, device, torch.bool),
    )


def row_accum_to_numpy(a: RowAccum) -> Tuple[np.ndarray, ...]:
    """``(ids, rows, nnz, overflow)`` as numpy arrays."""
    return tuple(_np(x) for x in (a.ids, a.rows, a.nnz, a.overflow))


def hier_rows_from_numpy(layers, cascades, device=None) -> HierRowAccum:
    """``layers`` is one ``(ids, rows, nnz, overflow)`` tuple per layer of a
    reference ``HierRowAccum``, ``cascades`` its counter array."""
    device = resolve_device(device)
    return HierRowAccum(
        layers=tuple(row_accum_from_numpy(*l, device=device) for l in layers),
        cascades=_own(cascades, device, torch.int32),
    )


def hier_rows_to_numpy(h: HierRowAccum):
    """``(layers, cascades)`` as numpy arrays, the inverse of
    :func:`hier_rows_from_numpy`."""
    return [row_accum_to_numpy(l) for l in h.layers], _np(h.cascades)


EMBEDDING_KEYS = ("table", "m", "v")


def embedding_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """An embedding's ``{table, m, v}`` as owned tensors (the table keeps
    its type, bfloat16 included)."""
    device = resolve_device(device)
    return {k: _own(arrays[k], device) for k in EMBEDDING_KEYS}


def embedding_to_numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: _np(tensors[k]) for k in EMBEDDING_KEYS}
