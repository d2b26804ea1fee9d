"""Host tier of the two-level hash router (port of ``repro.fleet.routing``).

One finalized 32-bit key hash drives both routing tiers, end to end:

* the **instance** tier (in-process) takes ``key_hash32 % n_instances`` —
  :func:`repro_torch.core.multistream.instance_of` on the device and
  :func:`repro_torch.serve.router.instance_of_numpy` on the host, proven
  bit-identical;
* the **host** tier (this module) takes the *top* bits of the same hash:
  ``route_host(r, c, H) = (uint64(key_hash32) * H) >> 32``.  For a
  power-of-two ``H`` that is *exactly* the top ``log2(H)`` bits of the
  hash (Lemire's fast-range reduction degenerates to a bit shift); for
  non-power-of-two ``H`` it is the same multiply-shift range reduction,
  still uniform and still disjoint from the modulo the instance tier uses.

Because the two tiers read disjoint ends of one hash, a record's (host,
instance) assignment is deterministic given (H, K), a fleet of ``H=1``
reproduces single-process routing bit-exactly, and per-host key sets are
disjoint — the property that makes the fleet's merged snapshot equal the
single-process snapshot bit for bit.

Everything here is numpy (the controller routes before records reach a
device), over :func:`repro_torch.serve.router.key_hash32_numpy`, whose
uint32 multiplies wrap as the reference's do.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.router import key_hash32_numpy


def host_prefix_bits(n_hosts: int) -> Optional[int]:
    """``log2(n_hosts)`` when it is a power of two (the regime where
    :func:`route_host` is exactly the hash's top bits), else ``None``."""
    n = int(n_hosts)
    if n >= 1 and (n & (n - 1)) == 0:
        return n.bit_length() - 1
    return None


def host_key_range(host: int, n_hosts: int) -> Tuple[int, int]:
    """The half-open ``[lo, hi)`` interval of 32-bit key hashes that
    :func:`route_host` assigns to ``host``: ``(h * H) >> 32 == i`` holds
    exactly for ``h`` in ``[ceil(i * 2^32 / H), ceil((i+1) * 2^32 / H))``.
    This is what a quarantine report surfaces — the key space that lost
    its owner."""
    n = int(n_hosts)
    i = int(host)
    if n < 1 or not 0 <= i < n:
        raise ValueError(f"need 0 <= host < n_hosts, got {host}/{n_hosts}")
    lo = -((-i << 32) // n)  # ceil(i * 2^32 / n)
    hi = -((-(i + 1) << 32) // n)
    return lo, min(hi, 1 << 32)


def route_host(rows: np.ndarray, cols: np.ndarray, n_hosts: int) -> np.ndarray:
    """Which of ``n_hosts`` owns key ``(row, col)``: the top end of
    :func:`~repro_torch.serve.router.key_hash32_numpy` via multiply-shift
    range reduction.  Returns int32 in ``[0, n_hosts)``; ``n_hosts=1`` maps
    everything to host 0 (single-process routing, bit-exactly)."""
    n = int(n_hosts)
    if n < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    h = key_hash32_numpy(np.asarray(rows), np.asarray(cols))
    return ((h.astype(np.uint64) * np.uint64(n)) >> np.uint64(32)).astype(
        np.int32
    )


def split_by_host(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_hosts: int,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Partition one record chunk into per-host sub-chunks.

    Returns a list of ``n_hosts`` ``(rows, cols, vals)`` triples; host
    ``h``'s slice keeps the original arrival order (stable selection), so
    each worker sees its records in stream order — the property the
    cursor-exact replay contract depends on.  The slices are disjoint and
    their concatenation is a permutation of the input: every record is
    routed exactly once, none invented, none lost.
    """
    rows = np.asarray(rows, np.int32).ravel()
    cols = np.asarray(cols, np.int32).ravel()
    vals = np.asarray(vals).ravel()
    owner = route_host(rows, cols, n_hosts)
    return [
        (rows[owner == h], cols[owner == h], vals[owner == h])
        for h in range(int(n_hosts))
    ]
