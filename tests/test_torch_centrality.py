"""Centrality and link analysis of cugraph_tpu_torch against cugraph_tpu on
the CPU: Katz, eigenvector, HITS, degree, betweenness, edge betweenness,
and PageRank on the weighted and symmetrized graphs.

Both packages get the same numpy edge list. Katz, eigenvector and HITS
agree within 1e-5 absolute (f32 sums in another order over a few hundred
iterations); degree centrality is equal; betweenness within 1e-5 relative
to the largest score. Weighted graphs carry weights in (0, 1], so the
default Katz alpha, 1 / (1 + max out-degree), bounds the spectral radius.
"""

import networkx as nx
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.algos.centrality import _brandes_batch as jax_brandes_batch
from cugraph_tpu_torch.algos import centrality


def _rmat(scale, seed, weighted):
    """numpy R-MAT (a, b, c = .57, .19, .19), edgefactor 16: skewed, with
    multi-edges and self-loops; weights in (0, 1]."""
    rng = np.random.default_rng(seed)
    e = 16 << scale
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    for _ in range(scale):
        sb = rng.random(e) < 0.38
        db = rng.random(e) < np.where(sb, 0.19 / 0.38, 0.19 / 0.76)
        src, dst = (src << 1) | sb, (dst << 1) | db
    w = (1.0 - rng.random(e)).astype(np.float32) if weighted else None
    return src.astype(np.int32), dst.astype(np.int32), w, 1 << scale, {}


def _karate(weighted=False, symmetrize=False):
    e = np.array(nx.karate_club_graph().edges(), dtype=np.int32)
    w = None
    if weighted:
        w = (1.0 - np.random.default_rng(7).random(len(e))).astype(np.float32)
    return e[:, 0], e[:, 1], w, 34, dict(symmetrize=symmetrize)


GRAPHS = {
    "karate": lambda: _karate(),
    "karate_sym_w": lambda: _karate(weighted=True, symmetrize=True),
    "rmat10": lambda: _rmat(10, 0, False),
    "rmat10w": lambda: _rmat(10, 1, True),
}
# exact betweenness vmaps every source in the JAX package: scale 8 keeps
# its (V, E) state small
BC_GRAPHS = {
    "karate": GRAPHS["karate"],
    "karate_sym_w": GRAPHS["karate_sym_w"],
    "rmat8": lambda: _rmat(8, 2, False),
}


def build_both(factory):
    src, dst, w, v, kw = factory()
    return (
        cg.from_edgelist(src, dst, w, num_vertices=v, **kw),
        ct.from_edgelist(src, dst, w, num_vertices=v, device="cpu", **kw),
    )


@pytest.fixture(scope="module", params=list(GRAPHS))
def graphs(request):
    return build_both(GRAPHS[request.param])


@pytest.fixture(scope="module", params=list(BC_GRAPHS))
def bc_graphs(request):
    return build_both(BC_GRAPHS[request.param])


def _close(got, want, atol=1e-5):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("kwargs", [dict(), dict(alpha=0.01, beta=0.5, normalized=False)])
def test_katz_matches_jax(graphs, kwargs):
    jg, tg = graphs
    want, _ = cg.katz_centrality(jg, **kwargs)
    got, iters = ct.katz_centrality(tg, **kwargs)
    assert 0 < iters <= 1000
    _close(got, want)


def test_eigenvector_matches_jax(graphs):
    jg, tg = graphs
    want, _ = cg.eigenvector_centrality(jg)
    got, _ = ct.eigenvector_centrality(tg)
    _close(got, want)
    assert abs(float(torch.linalg.vector_norm(got)) - 1.0) < 1e-5


@pytest.mark.parametrize("normalized", [True, False])
def test_hits_matches_jax(graphs, normalized):
    jg, tg = graphs
    jh, ja, _ = cg.hits(jg, normalized=normalized)
    th, ta, iters = ct.hits(tg, normalized=normalized)
    assert 0 < iters <= 100
    _close(th, jh)
    _close(ta, ja)


def test_hits_and_centrality_without_edges_match_jax():
    """No edges: HITS divides by its 1e-30 floors and returns zeros after
    two iterations in both packages."""
    none = np.zeros(0, np.int32)
    jg = cg.from_edgelist(none, none, num_vertices=5)
    tg = ct.from_edgelist(none, none, num_vertices=5, device="cpu")
    jh, ja, ji = cg.hits(jg)
    th, ta, ti = ct.hits(tg)
    assert ti == ji == 2
    _close(th, jh)
    _close(ta, ja)
    _close(ct.katz_centrality(tg)[0], cg.katz_centrality(jg)[0])
    _close(ct.eigenvector_centrality(tg)[0], cg.eigenvector_centrality(jg)[0])


@pytest.mark.parametrize("normalized", [True, False])
def test_degree_centrality_equals_jax(graphs, normalized):
    jg, tg = graphs
    got = ct.degree_centrality(tg, normalized=normalized)
    np.testing.assert_array_equal(got.numpy(), np.asarray(cg.degree_centrality(jg, normalized)))


def _bc_close(got, want):
    want = np.asarray(want)
    err = np.max(np.abs(got.numpy() - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= 1e-5, err


@pytest.mark.parametrize("endpoints", [False, True])
@pytest.mark.parametrize("normalized", [True, False])
def test_betweenness_exact_matches_jax(bc_graphs, endpoints, normalized):
    jg, tg = bc_graphs
    want = cg.betweenness_centrality(jg, normalized=normalized, endpoints=endpoints)
    _bc_close(ct.betweenness_centrality(tg, normalized=normalized, endpoints=endpoints), want)


def test_edge_betweenness_exact_matches_jax(bc_graphs):
    """The JAX package pads edge slots to 128 lanes: compare [:E]."""
    jg, tg = bc_graphs
    got = ct.edge_betweenness_centrality(tg)
    assert got.shape == (tg.num_edges,)
    _bc_close(got, np.asarray(cg.edge_betweenness_centrality(jg))[: tg.num_edges])


def test_brandes_batch_explicit_sources_matches_jax(bc_graphs, monkeypatch):
    """Sampled sources differ by design (torch.Generator vs jax.random):
    the same explicit sources give the same dependencies, also when the
    port splits them into batches."""
    jg, tg = bc_graphs
    sources = np.array([0, 3, 17, 5, 30], np.int32)
    jd, jed, jr = (np.asarray(a) for a in jax_brandes_batch(jg, jnp.asarray(sources)))
    td, ted, tr = centrality._brandes_batch(tg, torch.from_numpy(sources))
    np.testing.assert_array_equal(tr.numpy(), jr)
    _bc_close(td, jd)
    _bc_close(ted, jed[:, : tg.num_edges])
    monkeypatch.setattr(centrality, "BRANDES_BATCH_SLOTS", 2 * tg.num_edges)
    delta, edge_delta, reached_by, reaches = centrality._brandes_sums(
        tg, torch.from_numpy(sources)
    )
    _bc_close(delta, jd.sum(0))
    _bc_close(edge_delta, jed[:, : tg.num_edges].sum(0))
    np.testing.assert_array_equal(reached_by.numpy(), jr.sum(0))
    np.testing.assert_array_equal(reaches.numpy(), jr.sum(1))


@pytest.mark.parametrize("k", [4, 16])
def test_betweenness_sampled_matches_jax_on_its_sources(bc_graphs, k):
    """k sampled sources: the port's draw, held against the JAX package's
    Brandes on those very sources, scaled by V / k."""
    jg, tg = bc_graphs
    v = tg.num_vertices
    sources = centrality.sample_sources(v, k, 3, "cpu")
    assert len(set(sources.tolist())) == k
    jd, jed, _ = (np.asarray(a) for a in jax_brandes_batch(jg, jnp.asarray(sources.numpy())))
    sym = 2.0 if tg.is_symmetric else 1.0
    want = jd.sum(0) * (v / k) / sym / ((v - 1) * (v - 2) / sym)
    _bc_close(ct.betweenness_centrality(tg, k=k, seed=3), want)
    want_e = jed[:, : tg.num_edges].sum(0) * (v / k) / sym / (v * (v - 1) / sym)
    _bc_close(ct.edge_betweenness_centrality(tg, k=k, seed=3), want_e)


@pytest.mark.parametrize("use_pallas", [None, False])
def test_pagerank_use_pallas_matches_jax(graphs, use_pallas):
    """The port's one PageRank path (``pull_aggregate``: the plain
    ``spmv_sum`` version on a CPU graph) agrees with both of the JAX
    function's CPU paths; the port has no use_pallas argument."""
    jg, tg = graphs
    want, _ = cg.pagerank(jg, use_pallas=use_pallas)
    got, _ = ct.pagerank(tg)
    _close(got, want, atol=1e-6)
