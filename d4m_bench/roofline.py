"""Peaks of the card and the least bytes the measured work needs.

Peaks: NVIDIA H100 SXM data sheet (80 GB HBM3 at 3.35 TB/s), stated at the
card's full 700 W power limit.  The byte counts are lower bounds taken from
counts that no implementation changes, each input read once and each
output written once, so a share of the bandwidth roofline cannot pass 100%.
Entries are ``(row int32, col int32, value)``.
"""
from __future__ import annotations

from typing import Sequence

#: bytes/s of HBM3 on one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = {"H100": 3.35e12}


def peak_bytes_per_s(device_name: str) -> float | None:
    """The HBM peak of the card named ``device_name``, or ``None`` for a
    card this table does not hold."""
    for key, rate in HBM_BYTES_PER_S.items():
        if key in device_name:
            return rate
    return None


def entry_bytes(value_itemsize: int) -> int:
    return 4 + 4 + int(value_itemsize)


def update_bytes(updates: int, cascades: Sequence[int], cuts: Sequence[int], value_itemsize: int) -> int:
    """Ingest: every update read once; every cascade out of layer ``i``
    moves more than ``cuts[i]`` entries, read from layer ``i`` once and
    written into layer ``i + 1`` once.  ``cascades[i + 1]`` counts the
    cascades that reached layer ``i + 1`` (the session's counters)."""
    moved = sum(int(n) * int(cut) for n, cut in zip(list(cascades)[1:], cuts))
    return entry_bytes(value_itemsize) * (int(updates) + 2 * moved)


def snapshot_bytes(state_entries: int, view_entries: int, value_itemsize: int) -> int:
    """A view: every live entry of the state read once, every entry of the
    merged view written once."""
    return entry_bytes(value_itemsize) * (int(state_entries) + int(view_entries))
