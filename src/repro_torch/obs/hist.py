"""Lock-free log-bucketed latency histograms (HDR-style, power-of-two).

Port of ``repro.obs.hist``, copied: it imports no JAX, and its wire
forms (environment variables, JSON, state dicts) are the reference's, so
what one package writes reads the same in the other.

The recording path must be safe to call from any thread without a lock:
the router's producer thread, the feed thread, and the source's reader
thread all record into the same registry while the caller's thread reads
summaries.  A shared counter array with ``counts[i] += 1`` is NOT safe —
the read-modify-write spans bytecodes, so concurrent writers lose
increments and the count-conservation contract (``sum(counts) == number
of record() calls``) breaks exactly when the system is busiest.

So each histogram keeps **per-thread shards**: every recording thread owns
a private numpy ``int64`` bucket array (plus its own max), created once on
the thread's first record (the only lock in the lifetime of a writer
thread — shard *creation*, never the hot path).  Readers sum the shards;
a sum racing a record may be one event stale, but after writers quiesce
(join) it is exact — the conservation property the tests pin down.

Buckets are powers of two over nanoseconds: value ``v`` lands in bucket
``v.bit_length()`` (bucket 0 holds exactly {0}; bucket ``i`` holds
``[2^(i-1), 2^i - 1]``), clamped to :data:`NUM_BUCKETS` - 1.  64 buckets
cover any ``perf_counter_ns`` delta.  Percentiles report the bucket's
upper bound clamped to the observed max — integers, so summaries survive
JSON bit-exactly (the METRICS scrape's exactness contract).

Merging is plain bucket-count addition plus max-of-max: associative,
commutative, and exactly count-conserving — what lets a fleet controller
fold worker histograms into one distribution without losing a single
event (:func:`merge_states`).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

#: Bucket count: bucket i holds values with bit_length i (2^63 ns ≈ 292
#: years — no perf_counter_ns delta clamps in practice).
NUM_BUCKETS = 64

#: Percentiles every summary carries, as (label, quantile).
SUMMARY_QUANTILES = (("p50_ns", 0.50), ("p90_ns", 0.90), ("p99_ns", 0.99))


def bucket_index(value_ns: int) -> int:
    """The power-of-two bucket of a non-negative nanosecond value."""
    v = int(value_ns)
    if v <= 0:
        return 0
    return min(v.bit_length(), NUM_BUCKETS - 1)


def bucket_upper_bound(index: int) -> int:
    """Largest value bucket ``index`` can hold (0 for bucket 0)."""
    if index <= 0:
        return 0
    return (1 << index) - 1


class _Shard:
    """One thread's private counters (only its owner writes them)."""

    __slots__ = ("counts", "max_ns")

    def __init__(self) -> None:
        self.counts = np.zeros((NUM_BUCKETS,), np.int64)
        self.max_ns = 0


class LatencyHistogram:
    """One named latency distribution.  See the module docstring."""

    def __init__(self, name: str = ""):
        self.name = str(name)
        self._local = threading.local()
        self._shards: List[_Shard] = []
        self._create_lock = threading.Lock()  # shard creation only

    # -- write side (lock-free after a thread's first record) ---------------
    def record(self, value_ns: int) -> None:
        shard = getattr(self._local, "shard", None)
        if shard is None:
            shard = _Shard()
            with self._create_lock:
                self._shards.append(shard)
            self._local.shard = shard
        v = int(value_ns)
        shard.counts[bucket_index(v)] += 1
        if v > shard.max_ns:
            shard.max_ns = v

    # -- read side -----------------------------------------------------------
    def counts(self) -> np.ndarray:
        """Summed bucket counts across every writer thread (owned copy)."""
        out = np.zeros((NUM_BUCKETS,), np.int64)
        for shard in list(self._shards):
            out += shard.counts
        return out

    @property
    def count(self) -> int:
        return int(self.counts().sum())

    @property
    def max_ns(self) -> int:
        return max((s.max_ns for s in list(self._shards)), default=0)

    def state(self) -> Dict[str, Any]:
        """JSON-ready merge unit: ``{"counts": [...], "max_ns": int}``."""
        return {"counts": self.counts().tolist(), "max_ns": int(self.max_ns)}

    def percentile(self, q: float) -> Optional[int]:
        return state_percentile(self.state(), q)

    def summary(self) -> Dict[str, int]:
        return summarize_state(self.state())


# ---------------------------------------------------------------------------
# state-dict algebra (what travels on the wire and merges across a fleet)
# ---------------------------------------------------------------------------

def copy_state(state: Mapping[str, Any]) -> Dict[str, Any]:
    return {
        "counts": [int(c) for c in state["counts"]],
        "max_ns": int(state.get("max_ns", 0)),
    }


def merge_states(a: Mapping[str, Any], b: Mapping[str, Any]) -> Dict[str, Any]:
    """Bucket-count addition + max-of-max: associative, commutative, and
    exactly count-conserving (``sum(out) == sum(a) + sum(b)``)."""
    ca, cb = list(a["counts"]), list(b["counts"])
    if len(ca) != len(cb):
        raise ValueError(
            f"cannot merge histograms with {len(ca)} vs {len(cb)} buckets"
        )
    return {
        "counts": [int(x) + int(y) for x, y in zip(ca, cb)],
        "max_ns": max(int(a.get("max_ns", 0)), int(b.get("max_ns", 0))),
    }


def merge_state_maps(
    maps: List[Mapping[str, Mapping[str, Any]]]
) -> Dict[str, Dict[str, Any]]:
    """Merge ``{name: state}`` maps across workers (union of names)."""
    out: Dict[str, Dict[str, Any]] = {}
    for m in maps:
        for name, st in m.items():
            out[name] = (
                merge_states(out[name], st) if name in out else copy_state(st)
            )
    return out


def state_count(state: Mapping[str, Any]) -> int:
    return int(sum(int(c) for c in state["counts"]))


def state_percentile(state: Mapping[str, Any], q: float) -> Optional[int]:
    """The q-quantile as an integer nanosecond value (``None`` when empty).

    Deterministic in the bucket counts alone: walk the cumulative counts to
    the smallest bucket covering ``ceil(q * total)`` events and report its
    upper bound, clamped to the observed max — so any two holders of the
    same state compute the identical integer (the scrape bit-exactness
    contract).
    """
    counts = [int(c) for c in state["counts"]]
    total = sum(counts)
    if total == 0:
        return None
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile must be in (0, 1], got {q}")
    target = max(1, int(np.ceil(q * total)))
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            return min(bucket_upper_bound(i), int(state.get("max_ns", 0)))
    return int(state.get("max_ns", 0))  # pragma: no cover - cum==total above


def summarize_state(state: Mapping[str, Any]) -> Dict[str, int]:
    """``{count, p50_ns, p90_ns, p99_ns, max_ns}`` — all integers, so the
    summary survives any JSON hop bit-exactly."""
    out: Dict[str, int] = {"count": state_count(state)}
    for label, q in SUMMARY_QUANTILES:
        p = state_percentile(state, q)
        if p is not None:
            out[label] = p
    out["max_ns"] = int(state.get("max_ns", 0))
    return out
