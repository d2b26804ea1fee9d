"""Helpers shared by the port's fleet tests (``test_torch_fleet*.py``): the
reference fleet tests' configuration and records, the JAX single-process
snapshot they are held to, and a bit-for-bit comparison."""
import numpy as np

from repro import d4m as jd4m
from repro_torch import d4m as td4m

from _torch_parity import assert_assoc_same

TOTAL = 2048
CHUNK = 256
CAP = 8192

# worker processes run the port on the CPU; pin their BLAS/OpenMP threads
# so N workers do not oversubscribe a small box
ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
SERVE = dict(drain_timeout_s=600.0)

_REF = {}  # one reference session a process: JAX compiles its steps once


def config() -> td4m.StreamConfig:
    """``tests/fleet/test_fleet.py``'s configuration, in the port."""
    return td4m.StreamConfig(
        cuts=(256, 1024),
        top_capacity=4096,
        batch_size=128,
        instances_per_device=2,
        snapshot_cap=CAP,
    )


def records(total: int = TOTAL, seed: int = 11):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 4096, total).astype(np.int32)
    cols = rng.integers(0, 4096, total).astype(np.int32)
    vals = rng.integers(1, 8, total).astype(np.float32)  # exact in float32
    return rows, cols, vals


def reference_session() -> "jd4m.D4MStream":
    """The JAX session of the same configuration (its wire form read by
    the reference), emptied."""
    if "sess" not in _REF:
        _REF["sess"] = jd4m.D4MStream(jd4m.StreamConfig.from_dict(config().to_dict()))
    return _REF["sess"].reset()


def reference_snapshot(rows, cols, vals):
    """Single-process ingest of the whole stream through the JAX package,
    in stream order."""
    sess = reference_session()
    for lo in range(0, rows.shape[0], 128):
        dropped = sess.ingest(rows[lo:lo + 128], cols[lo:lo + 128], vals[lo:lo + 128])
        assert int(dropped) == 0
    return sess.snapshot(cap=CAP)


def assert_bit_identical(snap, ref):
    """The port's merged snapshot equals the reference's, every slot."""
    assert_assoc_same(snap, ref, "merged snapshot")
    assert int(ref.nnz) > 0
    assert not bool(snap.overflow)
