"""The port's graph analytics against the JAX reference (and networkx), on
the CPU: degrees, top-k, ``undirected_view``, ``triangle_count``,
``common_neighbors``, ``jaccard``, ``reachable_within``, the
``_require_counting`` guards, ``host_degree_fold`` and
``degrees_from_vectors``.  Results compared bit for bit.
"""
import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from repro.core import analytics as ja
from repro.core import assoc as jas
from repro.core import semiring as js
from repro_torch.core import analytics as ta
from repro_torch.core import assoc as tas
from repro_torch.core import semiring as ts

from _torch_parity import assert_assoc_same, assert_same

torch.set_num_threads(1)

CAP = 256

_jt = {
    "undirected_view": jax.jit(ja.undirected_view, static_argnames=("cap", "sr")),
    "triangle_count": jax.jit(ja.triangle_count, static_argnames=("cap_sq", "max_fanout", "sr")),
    "common_neighbors": jax.jit(ja.common_neighbors, static_argnames=("u", "v", "cap", "sr")),
    "jaccard": jax.jit(ja.jaccard, static_argnames=("u", "v", "cap", "sr")),
    "reachable_within": jax.jit(ja.reachable_within, static_argnames=("steps", "cap", "max_fanout", "sr")),
    "degrees": jax.jit(ja.degrees, static_argnames=("cap", "sr")),
}


@pytest.fixture(scope="module")
def graph():
    """networkx G(24, 60), both orientations, unit weights, in both
    packages."""
    g = nx.gnm_random_graph(24, 60, seed=7)
    edges = np.asarray(g.edges, np.int32)
    r = np.concatenate([edges[:, 0], edges[:, 1]])
    c = np.concatenate([edges[:, 1], edges[:, 0]])
    v = np.ones(len(r), np.float32)
    j = jas.from_triples(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), cap=CAP)
    t = tas.from_triples(torch.tensor(r), torch.tensor(c), torch.tensor(v), CAP)
    assert_assoc_same(t, j, "graph")
    return g, j, t


def test_degrees_and_top_k(graph):
    g, j, t = graph
    jo, ji = _jt["degrees"](j, cap=64)
    to, ti = ta.degrees(t, cap=64)
    assert_assoc_same(to, jo, "out")
    assert_assoc_same(ti, ji, "in")
    for got, want in zip(ta.top_k_vertices(to, 3), ja.top_k_vertices(jo, 3)):
        assert_same(got, want)
    for vtx in g.nodes:
        assert float(tas.get(to, vtx, 0)) == g.degree(vtx)


def test_triangle_count_matches_reference_and_networkx(graph):
    g, j, t = graph
    want = _jt["triangle_count"](j, cap_sq=1024, max_fanout=16)
    got = ta.triangle_count(t, cap_sq=1024, max_fanout=16)
    assert_same(got, want)
    assert float(got) == sum(nx.triangles(g).values()) / 3


@pytest.mark.parametrize("u,v", [(0, 1), (3, 7), (5, 5)])
def test_common_neighbors_and_jaccard(graph, u, v):
    g, j, t = graph
    assert_same(ta.common_neighbors(t, u, v, cap=64), _jt["common_neighbors"](j, u=u, v=v, cap=64))
    assert_same(ta.jaccard(t, u, v, cap=64), _jt["jaccard"](j, u=u, v=v, cap=64))
    nu, nv = set(g.neighbors(u)), set(g.neighbors(v))
    assert float(ta.common_neighbors(t, u, v, cap=64)) == len(nu & nv)


@pytest.mark.parametrize("srn", ["max.min", "min.max"])
@pytest.mark.parametrize("steps", [1, 2])
def test_reachable_within(graph, srn, steps):
    g, j, t = graph
    want = _jt["reachable_within"](j, steps=steps, cap=1024, max_fanout=16, sr=js.get(srn))
    got = ta.reachable_within(t, steps, cap=1024, max_fanout=16, sr=ts.get(srn))
    assert_assoc_same(got, want)
    adj = nx.to_numpy_array(g, nodelist=range(24)) > 0
    walks = adj | ((adj.astype(int) @ adj.astype(int)) > 0) if steps == 2 else adj
    assert int(got.nnz) == int(walks.sum())  # pairs joined by a walk of <= steps


@pytest.mark.parametrize("srn", ["plus.times", "max.plus"])
def test_undirected_view(graph, srn):
    _, j, t = graph
    # a directed half of the graph: the view must restore the symmetric support
    keep = (np.asarray(j.rows) < np.asarray(j.cols)) & (np.asarray(j.rows) != jas.PAD)
    r = np.where(keep, np.asarray(j.rows), jas.PAD).astype(np.int32)
    c = np.where(keep, np.asarray(j.cols), jas.PAD).astype(np.int32)
    v = np.where(keep, 2.5, 0.0).astype(np.float32)
    jh = jas.from_triples(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), cap=CAP, sr=js.get(srn))
    th = tas.from_triples(torch.tensor(r), torch.tensor(c), torch.tensor(v), CAP, ts.get(srn))
    want = _jt["undirected_view"](jh, cap=2 * CAP, sr=js.get(srn))
    got = ta.undirected_view(th, cap=2 * CAP, sr=ts.get(srn))
    assert_assoc_same(got, want)
    assert int(got.nnz) == int(t.nnz)


@pytest.mark.parametrize("srn", ["max.plus", "min.plus", "max.min", "min.max"])
def test_counting_analytics_reject_non_counting_semirings(graph, srn):
    _, _, t = graph
    sr = ts.get(srn)
    with pytest.raises(ValueError, match="counting"):
        ta.triangle_count(t, cap_sq=1024, max_fanout=16, sr=sr)
    with pytest.raises(ValueError, match="counting"):
        ta.common_neighbors(t, 0, 1, cap=64, sr=sr)
    with pytest.raises(ValueError, match="counting"):
        ta.jaccard(t, 0, 1, cap=64, sr=sr)


@pytest.mark.parametrize("srn", ["plus.times", "count"])
def test_counting_analytics_accept_counting_semirings(graph, srn):
    _, j, t = graph
    want = _jt["triangle_count"](j, cap_sq=1024, max_fanout=16, sr=js.get(srn))
    assert_same(ta.triangle_count(t, cap_sq=1024, max_fanout=16, sr=ts.get(srn)), want)


def test_host_degree_fold_and_degrees_from_vectors(graph):
    for name in ts.REGISTRY:
        assert ta.host_degree_fold(ts.get(name)) is ja.host_degree_fold(js.get(name))
    _, j, t = graph
    out_deg, in_deg = ta.degrees(t, cap=64)
    n_out, n_in = int(out_deg.nnz), int(in_deg.nnz)
    ids = out_deg.rows.numpy()[:n_out]
    vals = out_deg.vals.numpy()[:n_out]
    perm = np.random.default_rng(1).permutation(n_out)  # host order is arbitrary
    got = ta.degrees_from_vectors(ids[perm], vals[perm], in_deg.rows.numpy()[:n_in],
                                  in_deg.vals.numpy()[:n_in], 64, ts.PLUS_TIMES, device="cpu")
    want = ja.degrees_from_vectors(ids[perm], vals[perm], in_deg.rows.numpy()[:n_in],
                                   in_deg.vals.numpy()[:n_in], 64, js.PLUS_TIMES, jnp.float32)
    for g_, w_ in zip(got, want):
        assert_assoc_same(g_, w_)
    assert_assoc_same(got[0], out_deg)
    assert_assoc_same(got[1], in_deg)
