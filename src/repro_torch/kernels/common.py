"""Shared helpers of the port's kernels.

The reference's bitonic networks are TPU-specific (oblivious compare-
exchange passes over VMEM lanes) and are not carried over: the Hopper
kernels merge by merge-path partitions (``csrc/merge.cuh``).
"""
from __future__ import annotations


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
