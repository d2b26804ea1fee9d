"""DEPRECATED streaming entry points: shims over the D4M session (port of
``repro.core.streaming``).

The streaming engines live in :mod:`repro_torch.d4m.session`
(:func:`~repro_torch.d4m.session.build_update_step`,
:func:`~repro_torch.d4m.session.scan_ingest`,
:func:`~repro_torch.d4m.session.scan_ingest_and_snapshot`); new code goes
through :class:`repro_torch.d4m.D4MStream`.  These keep the historical
``core.streaming`` names, with a :class:`DeprecationWarning`.  They import
the session lazily, so ``repro_torch.core`` never imports ``repro_torch.d4m``
when it is loaded.
"""
from __future__ import annotations

import warnings
from typing import Sequence, Tuple

import torch

from .hierarchical import HierAssoc
from .semiring import PLUS_TIMES, Semiring


def _warn(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.core.streaming.{old} is deprecated; use {new} "
        f"(see repro_torch.d4m, the unified session API)",
        DeprecationWarning,
        stacklevel=3,
    )


def make_update_fn(
    cuts: Sequence[int],
    sr: Semiring = PLUS_TIMES,
    donate: bool = True,
    instances: int | None = None,
):
    """Deprecated alias of :func:`repro_torch.d4m.session.build_update_step`.
    ``donate`` is the reference's argument; the port's eager steps do not
    read it."""
    _warn("make_update_fn", "repro_torch.d4m.session.build_update_step")
    from repro_torch.d4m import session as _session

    return _session.build_update_step(cuts, sr=sr, instances=instances)


def ingest_stream(
    h: HierAssoc,
    rows: torch.Tensor,  # [T, B] int32, or [T, K, B] when instances=K
    cols: torch.Tensor,
    vals: torch.Tensor,
    cuts: Sequence[int],
    sr: Semiring = PLUS_TIMES,
    instances: int | None = None,
) -> Tuple[HierAssoc, torch.Tensor]:
    """Deprecated alias of :func:`repro_torch.d4m.session.scan_ingest`."""
    _warn("ingest_stream", "repro_torch.d4m.session.scan_ingest")
    from repro_torch.d4m import session as _session

    return _session.scan_ingest(h, rows, cols, vals, cuts, sr, instances=instances)


def ingest_and_snapshot(
    h: HierAssoc,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    cuts: Tuple[int, ...],
    cap: int,
    sr: Semiring = PLUS_TIMES,
    instances: int | None = None,
):
    """Deprecated alias of
    :func:`repro_torch.d4m.session.scan_ingest_and_snapshot` (with
    ``instances=K``: ``[T, K, B]`` streams into a packed hierarchy, the
    snapshot the merged global array)."""
    _warn("ingest_and_snapshot", "repro_torch.d4m.session.scan_ingest_and_snapshot")
    from repro_torch.d4m import session as _session

    return _session.scan_ingest_and_snapshot(
        h, rows, cols, vals, tuple(int(c) for c in cuts), int(cap), sr, instances=instances,
    )
