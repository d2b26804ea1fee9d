"""Host-side string-key dictionary encoding (a copy of
``repro.data.dictionary`` for the port).

D4M's associative arrays key on sorted strings (e.g. IPv4 addresses); the
device-side arrays key on int32.  This module is the boundary: a
persistent, append-only string -> int32 dictionary kept on the host by the
data pipeline.  IPv4 addresses get a lossless fast path (packed octets)
that never consults the dictionary.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List

import numpy as np


def encode_ipv4(addrs: Iterable[str]) -> np.ndarray:
    """Lossless IPv4 -> int32 (packed octets, two's-complement wrap)."""
    out = []
    for a in addrs:
        p = a.split(".")
        v = (int(p[0]) << 24) | (int(p[1]) << 16) | (int(p[2]) << 8) | int(p[3])
        out.append(np.int32(np.uint32(v)))
    return np.asarray(out, np.int32)


def decode_ipv4(codes: np.ndarray) -> List[str]:
    out = []
    for v in np.asarray(codes).astype(np.uint32):
        out.append(f"{(v >> 24) & 255}.{(v >> 16) & 255}.{(v >> 8) & 255}.{v & 255}")
    return out


class StringDictionary:
    """Append-only bidirectional string<->int32 map (thread-safe)."""

    def __init__(self):
        self._fwd: Dict[str, int] = {}
        self._rev: List[str] = []
        self._lock = threading.Lock()

    def encode(self, keys: Iterable[str]) -> np.ndarray:
        out = []
        with self._lock:
            for k in keys:
                idx = self._fwd.get(k)
                if idx is None:
                    idx = len(self._rev)
                    self._fwd[k] = idx
                    self._rev.append(k)
                out.append(idx)
        return np.asarray(out, np.int32)

    def decode(self, codes: Iterable[int]) -> List[str]:
        with self._lock:
            return [self._rev[int(c)] for c in codes]

    def __len__(self):
        return len(self._rev)
