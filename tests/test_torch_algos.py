"""PageRank and BFS of cugraph_tpu_torch against cugraph_tpu on the CPU.

PageRank: max absolute error 1e-6 (f32 sums in another order). BFS:
distances and predecessors EQUAL (the predecessor is the smallest frontier
in-neighbour in both packages).
"""

import networkx as nx
import numpy as np
import pytest
import torch

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.algos.traversal import _sparse_bfs_level as jax_sparse_level
from cugraph_tpu_torch.algos import traversal


def _karate():
    e = np.array(nx.karate_club_graph().edges(), dtype=np.int32)
    return e[:, 0], e[:, 1], None, 34


def _rmat_np(scale, edgefactor, seed, weighted=False):
    """numpy R-MAT (a, b, c = .57, .19, .19): skewed, with multi-edges."""
    rng = np.random.default_rng(seed)
    e = edgefactor << scale
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    for _ in range(scale):
        sb = rng.random(e) < 0.38
        db = rng.random(e) < np.where(sb, 0.19 / 0.38, 0.19 / 0.76)
        src, dst = (src << 1) | sb, (dst << 1) | db
    w = rng.random(e).astype(np.float32) + 0.5 if weighted else None
    return src.astype(np.int32), dst.astype(np.int32), w, 1 << scale


GRAPHS = {
    "karate": _karate,
    "rmat10": lambda: _rmat_np(10, 16, 0),
    "rmat10w": lambda: _rmat_np(10, 16, 1, weighted=True),
}


@pytest.fixture(scope="module", params=list(GRAPHS))
def graphs(request):
    src, dst, w, v = GRAPHS[request.param]()
    return (
        cg.from_edgelist(src, dst, w, num_vertices=v),
        ct.from_edgelist(src, dst, w, num_vertices=v, device="cpu"),
    )


@pytest.mark.parametrize("kwargs", [dict(tol=0.0, max_iterations=50), dict()])
def test_pagerank_matches_jax(graphs, kwargs):
    jg, tg = graphs
    want, _ = cg.pagerank(jg, **kwargs)
    got, iters = ct.pagerank(tg, **kwargs)
    assert got.dtype == torch.float32 and got.shape == (tg.num_vertices,)
    assert 0 < iters <= kwargs.get("max_iterations", 100)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < 1e-6
    assert abs(float(got.sum()) - 1.0) < 1e-5


def test_pagerank_personalized_and_nstart_match_jax():
    src, dst, _, v = _rmat_np(10, 16, 2)
    jg = cg.from_edgelist(src, dst, num_vertices=v)
    tg = ct.from_edgelist(src, dst, num_vertices=v, device="cpu")
    pers = (np.array([0, 5, 17]), np.array([1.0, 2.0, 1.0], np.float32))
    nstart = np.random.default_rng(0).random(v).astype(np.float32)
    want, _ = cg.pagerank(jg, personalization=pers, nstart=nstart)
    got, _ = ct.pagerank(tg, personalization=pers, nstart=nstart)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < 1e-6
    with pytest.raises(ct.utils.GraphError):
        ct.pagerank(tg, max_iterations=2, fail_on_nonconvergence=True)


@pytest.mark.parametrize("sources", [0, 7, [3, 900]])
def test_bfs_equals_jax(graphs, sources):
    jg, tg = graphs
    if tg.num_vertices <= np.max(sources):
        sources = np.asarray(sources) % tg.num_vertices
    jd, jp = cg.bfs(jg, sources)
    td, tp = ct.bfs(tg, sources)
    assert td.dtype == torch.int32 and tp.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_bfs_depth_limit_equals_jax(graphs):
    jg, tg = graphs
    jd, jp = cg.bfs(jg, 0, depth_limit=1)
    td, tp = ct.bfs(tg, 0, depth_limit=1)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    reached = td < np.iinfo(np.int32).max
    assert td[reached].max() == 1


def test_bfs_compacted_levels_equal_jax(monkeypatch):
    """The compacted push (used from V >= 2^22 on) gives the same result
    as the dense sweep when forced on at small V."""
    src, dst, _, v = _rmat_np(10, 16, 3)
    jd, jp = cg.bfs(cg.from_edgelist(src, dst, num_vertices=v), 1)
    monkeypatch.setattr(traversal, "SPARSE_MIN_VERTICES", 0)
    calls = []
    real = traversal._sparse_bfs_level
    monkeypatch.setattr(
        traversal, "_sparse_bfs_level", lambda *a: calls.append(1) or real(*a)
    )
    tg = ct.from_edgelist(src, dst, num_vertices=v, device="cpu")
    td, tp = ct.bfs(tg, 1, sparse_caps=(600, 50))
    assert calls  # some levels were compacted, others dense
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_sparse_bfs_level_equals_jax():
    src, dst, _, v = _rmat_np(10, 16, 4)
    jg = cg.from_edgelist(src, dst, num_vertices=v)
    tg = ct.from_edgelist(src, dst, num_vertices=v, device="cpu")
    rng = np.random.default_rng(4)
    frontier = rng.random(v) < 0.02
    visited = frontier | (rng.random(v) < 0.3)
    csr = jg.csr()
    jt, jpc = jax_sparse_level(
        csr.offsets, csr.minors, frontier, visited, cap_v=64, cap_e=1 << 14
    )
    tt, tpc = traversal._sparse_bfs_level(
        tg.csr().offsets, tg.csr().minors, torch.from_numpy(frontier),
        torch.from_numpy(visited),
    )
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpc.numpy(), np.asarray(jpc))


def test_bfs_checks(monkeypatch):
    """A source out of range raises; above MAX_VERTICES (lowered here) bfs
    runs, as the JAX bfs does, and equals it."""
    src, dst, _, v = _karate()
    tg = ct.from_edgelist(src, dst, num_vertices=v, device="cpu")
    with pytest.raises(ct.utils.GraphError):
        ct.bfs(tg, v)
    monkeypatch.setattr(traversal, "MAX_VERTICES", v - 1)
    got_d, got_p = ct.bfs(tg, 0)
    want_d, want_p = cg.bfs(cg.from_edgelist(src, dst, num_vertices=v), 0)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
