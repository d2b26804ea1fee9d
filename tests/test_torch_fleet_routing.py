"""``repro_torch.fleet.routing`` against ``repro.fleet.routing``, on the CPU.

The host tier must consume exactly the *top* bits of the same 32-bit key
hash whose low end (modulo K) the instance tier consumes, and the uint32
multiply-shift must wrap as the reference's does (ROADMAP C3): for
power-of-two and other host counts, and for int32 edge keys, every
function equals the reference's, and the host tier and the port's
``route_to_instances`` read one hash.  Mirrors ``tests/fleet/test_routing.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multistream as jms
from repro.fleet import routing as jrouting
from repro_torch.core import multistream as tms
from repro_torch.fleet import host_prefix_bits, route_host, routing, split_by_host
from repro_torch.serve.router import instance_of_numpy, key_hash32_numpy

from _torch_parity import PAD, assert_same

HOSTS = [1, 2, 3, 4, 6, 7, 8, 256, 1000]
INT32_EDGES = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, PAD], np.int32)


def _records(seed: int, n: int, edges: bool = False):
    rng = np.random.default_rng(seed)
    if edges:  # the whole int32 range, with every edge value paired with every other
        r = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
        c = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
        er, ec = np.meshgrid(INT32_EDGES, INT32_EDGES)
        return np.concatenate([r, er.ravel()]), np.concatenate([c, ec.ravel()])
    rows = rng.integers(0, 1 << 20, n).astype(np.int32)
    cols = rng.integers(0, 1 << 20, n).astype(np.int32)
    return rows, cols


@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("n_hosts", HOSTS)
def test_route_host_equals_reference(n_hosts, edges):
    rows, cols = _records(n_hosts, 2048, edges)
    got = route_host(rows, cols, n_hosts)
    assert_same(got, jrouting.route_host(rows, cols, n_hosts))
    assert ((got >= 0) & (got < n_hosts)).all()


@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4, 7, 8])
def test_split_by_host_equals_reference(n_hosts, edges):
    rows, cols = _records(100 + n_hosts, 1024, edges)
    vals = np.arange(rows.shape[0], dtype=np.float32)  # arrival index as payload
    got = split_by_host(rows, cols, vals, n_hosts)
    want = jrouting.split_by_host(rows, cols, vals, n_hosts)
    assert len(got) == len(want) == n_hosts
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert_same(a, b)


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5, 6, 8, 1000, 2**31 + 1])
def test_host_key_range_equals_reference_and_tiles_the_hash_space(n_hosts):
    hosts = range(n_hosts) if n_hosts <= 1000 else (0, 1, n_hosts // 2, n_hosts - 1)
    ranges = [routing.host_key_range(i, n_hosts) for i in hosts]
    assert ranges == [jrouting.host_key_range(i, n_hosts) for i in hosts]
    if n_hosts <= 1000:
        assert ranges[0][0] == 0 and ranges[-1][1] == 1 << 32
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    for bad in (-1, n_hosts):
        with pytest.raises(ValueError):
            routing.host_key_range(bad, n_hosts)


def test_host_key_range_holds_what_route_host_assigns():
    rows, cols = _records(5, 4096, edges=True)
    h = key_hash32_numpy(rows, cols).astype(np.int64)
    for n_hosts in (3, 6, 8):
        owner = route_host(rows, cols, n_hosts)
        for i in range(n_hosts):
            lo, hi = routing.host_key_range(i, n_hosts)
            assert ((h[owner == i] >= lo) & (h[owner == i] < hi)).all()


def test_host_prefix_bits_equals_reference():
    for n in list(range(0, 300)) + [1 << 20, (1 << 20) + 1]:
        assert host_prefix_bits(n) == jrouting.host_prefix_bits(n), n
    assert [host_prefix_bits(n) for n in (1, 2, 8, 256, 3, 6)] == [0, 1, 3, 8, None, None]


@pytest.mark.parametrize("log_h", [1, 3, 8])
def test_route_host_is_hash_top_bits(log_h):
    """Power-of-two H: route_host == key_hash32 >> (32 - log2(H))."""
    rows, cols = _records(log_h, 1024, edges=True)
    expect = (key_hash32_numpy(rows, cols) >> np.uint32(32 - log_h)).astype(np.int32)
    np.testing.assert_array_equal(route_host(rows, cols, 1 << log_h), expect)


@pytest.mark.parametrize("edges", [False, True])
def test_host_hash_is_the_instance_routers_hash(edges):
    """One finalizer end to end: the numpy hash the host tier reads equals
    the port's device hash and the reference's."""
    rows, cols = _records(9, 512, edges)
    host_h = key_hash32_numpy(rows, cols)
    dev_h = tms.key_hash32(torch.tensor(rows), torch.tensor(cols)).numpy().astype(np.uint32)
    ref_h = np.asarray(jms.key_hash32(jnp.asarray(rows), jnp.asarray(cols))).astype(np.uint32)
    np.testing.assert_array_equal(host_h, dev_h)
    np.testing.assert_array_equal(host_h, ref_h)


@pytest.mark.parametrize("n_hosts,k", [(2, 1), (3, 8), (4, 2), (8, 8)])
def test_host_partition_preserves_instance_assignment(n_hosts, k):
    """Splitting by host, then routing each slice to instances with the
    port's ``route_to_instances``, places every record in the instance
    that routing the whole chunk gives it: (host, instance) is one pair
    per key."""
    rows, cols = _records(n_hosts * 10 + k, 256)
    vals = np.arange(rows.shape[0], dtype=np.float32) + 1  # record ids, 0 is dead
    global_inst = instance_of_numpy(rows, cols, k)
    for h, (r, c, v) in enumerate(split_by_host(rows, cols, vals, n_hosts)):
        br, _, bv, dropped = tms.route_to_instances(
            torch.tensor(r), torch.tensor(c), torch.tensor(v), k, 256
        )
        assert int(dropped) == 0
        for inst in range(k):
            live = br[inst] != PAD
            ids = bv[inst][live].numpy().astype(np.int64) - 1
            assert (global_inst[ids] == inst).all()
        np.testing.assert_array_equal(instance_of_numpy(r, c, k),
                                      global_inst[route_host(rows, cols, n_hosts) == h])


def test_h1_reproduces_single_process_routing():
    rows, cols = _records(7, 1000)
    vals = np.arange(1000, dtype=np.float32)
    np.testing.assert_array_equal(route_host(rows, cols, 1), np.zeros(1000, np.int32))
    (r, c, v), = split_by_host(rows, cols, vals, 1)
    for a, b in ((r, rows), (c, cols), (v, vals)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [0, 1, 511])
@pytest.mark.parametrize("n_hosts", [1, 3, 8])
def test_split_by_host_is_stable_partition(n, n_hosts):
    rows, cols = _records(n + n_hosts, max(n, 1))
    rows, cols = rows[:n], cols[:n]
    vals = np.arange(n, dtype=np.float32)
    parts = split_by_host(rows, cols, vals, n_hosts)
    owner = route_host(rows, cols, n_hosts)
    assert sum(p[0].shape[0] for p in parts) == n
    for h, (r, c, v) in enumerate(parts):
        np.testing.assert_array_equal(route_host(r, c, n_hosts), np.full(r.shape[0], h, np.int32))
        assert (np.diff(v) > 0).all()
        np.testing.assert_array_equal(r, rows[owner == h])


def test_route_host_rejects_bad_host_count():
    rows, cols = _records(0, 4)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            route_host(rows, cols, bad)
        with pytest.raises(ValueError):
            jrouting.route_host(rows, cols, bad)
