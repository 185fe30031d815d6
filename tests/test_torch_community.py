"""Community detection of cugraph_tpu_torch against cugraph_tpu on the CPU.

Tolerances, and why:
- modularity and the clustering metrics: within 1e-6 (f32 sums of the
  same terms in another order).
- louvain and leiden on unweighted graphs: labels EQUAL. Every weight sum
  is a small integer, exact in f32, and the port keeps the JAX package's
  order of operations in each score, so every comparison goes the same
  way. Returned modularity within 1e-6.
- on weighted graphs: modularity within 1e-6 only. Weight sums round, and
  a near-tie between two moves may then go either way, which changes the
  labels without changing their quality.
- triangle counts, k-truss edge sets and ego graphs: EQUAL (integers).
- ecg: the same numpy generator draws the same perturbations in both;
  modularity within 1e-6, and on karate the labels are equal.
- spectral: the modularity-maximization variant (dense eigh) gives the
  same partition; the balanced cut (ARPACK from a random start in the JAX
  package) gives the same partition up to the names of its clusters on
  karate, where the eigenvalues are distinct.
"""

import networkx as nx
import numpy as np
import pytest
import torch

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.core.convert import decompress_to_edgelist as jdecompress

TOL_Q = 1e-6


def _karate():
    e = np.array(nx.karate_club_graph().edges(), dtype=np.int32)
    return e[:, 0], e[:, 1], 34


def _rmat_np(scale, edgefactor, seed):
    rng = np.random.default_rng(seed)
    e = edgefactor << scale
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    for _ in range(scale):
        sb = rng.random(e) < 0.38
        db = rng.random(e) < np.where(sb, 0.19 / 0.38, 0.19 / 0.76)
        src, dst = (src << 1) | sb, (dst << 1) | db
    return src.astype(np.int32), dst.astype(np.int32), 1 << scale


def _weights(n):
    return np.random.default_rng(3).random(n).astype(np.float32) + 0.5


def _pair(src, dst, v, w=None):
    return (
        cg.from_edgelist(src, dst, w, num_vertices=v, symmetrize=True),
        ct.from_edgelist(src, dst, w, num_vertices=v, symmetrize=True, device="cpu"),
    )


GRAPHS = {
    "karate": lambda: _pair(*_karate()),
    "karate_w": lambda: _pair(*_karate(), _weights(78)),
    "rmat10": lambda: _pair(*_rmat_np(10, 4, 0)),
    "rmat10_w": lambda: _pair(*_rmat_np(10, 4, 0), _weights(4096)),
}
_cache = {}


def _graphs(name):
    if name not in _cache:
        _cache[name] = GRAPHS[name]()
    return _cache[name]


def _edges(g, jax_graph):
    s, d, w = jdecompress(g) if jax_graph else ct.core.decompress_to_edgelist(g)
    as_np = (lambda a: np.asarray(a)) if jax_graph else (lambda a: a.numpy())
    return as_np(s), as_np(d), None if w is None else as_np(w)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_modularity_matches_jax(name):
    jg, tg = _graphs(name)
    rng = np.random.default_rng(0)
    for labels in (np.arange(jg.num_vertices) % 3, rng.integers(0, 8, jg.num_vertices)):
        want = cg.modularity(jg, labels)
        assert abs(ct.modularity(tg, torch.from_numpy(labels)) - want) <= TOL_Q
        assert abs(ct.analyze_clustering_modularity(tg, labels) - want) <= TOL_Q
        assert abs(ct.modularity(tg, labels, resolution=0.5)
                   - cg.modularity(jg, labels, resolution=0.5)) <= TOL_Q


@pytest.mark.parametrize("name", list(GRAPHS))
def test_analyze_cuts_match_jax(name):
    jg, tg = _graphs(name)
    labels = np.random.default_rng(1).integers(0, 5, jg.num_vertices)
    for fn in ("analyze_clustering_edge_cut", "analyze_clustering_ratio_cut"):
        want = getattr(cg, fn)(jg, labels)
        got = getattr(ct, fn)(tg, torch.from_numpy(labels))
        assert abs(got - want) <= TOL_Q * max(1.0, abs(want))


@pytest.mark.parametrize(
    "name,fn",
    [("karate", "louvain"), ("karate", "leiden"), ("rmat10", "louvain"), ("rmat10", "leiden"),
     ("karate_w", "louvain"), ("karate_w", "leiden"), ("rmat10_w", "louvain")],
)
def test_louvain_leiden_match_jax(name, fn):
    jg, tg = _graphs(name)
    want_labels, want_q = getattr(cg, fn)(jg)
    labels, q = getattr(ct, fn)(tg)
    assert labels.dtype == torch.int32 and labels.shape == (tg.num_vertices,)
    assert abs(q - want_q) <= TOL_Q
    assert abs(ct.modularity(tg, labels) - q) <= TOL_Q
    if not tg.weighted:
        np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))


def test_louvain_one_level_matches_jax_with_constraint():
    """The refinement move of Leiden: moves stay within a given partition."""
    import jax.numpy as jnp
    from cugraph_tpu.algos.community import _louvain_one_level as jlevel
    from cugraph_tpu_torch.algos.community import _louvain_one_level as tlevel

    jg, tg = _graphs("rmat10")
    constraint = (np.arange(tg.num_vertices) // 100).astype(np.int32)
    jl, jm = jlevel(jg, jnp.float32(1.0), 32, constraint=jnp.asarray(constraint))
    tl, tm = tlevel(tg, 1.0, 32, constraint=torch.from_numpy(constraint))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tm == int(jm)
    assert (constraint[tl.numpy()] == constraint).all()


@pytest.mark.parametrize("name", ["karate", "rmat10"])
def test_triangle_count_matches_jax(name):
    jg, tg = _graphs(name)
    got = ct.triangle_count(tg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(cg.triangle_count(jg)))
    if name == "karate":
        want = nx.triangles(nx.karate_club_graph())
        assert got.tolist() == [want[i] for i in range(34)]


def test_triangle_count_small_wedge_budget():
    """Chunked wedge expansion gives the same counts at any budget."""
    from cugraph_tpu_torch.prims.intersection import (
        degree_oriented_adj,
        triangle_counts_per_vertex,
    )

    _, tg = _graphs("rmat10")
    src, dst, _ = ct.core.decompress_to_edgelist(tg)
    keep = src < dst
    oriented = degree_oriented_adj(src[keep], dst[keep], tg.num_vertices)
    full = triangle_counts_per_vertex(oriented, tg.num_vertices)
    for budget in (1, 97, 4096):
        assert torch.equal(
            triangle_counts_per_vertex(oriented, tg.num_vertices, wedge_budget=budget), full
        )


@pytest.mark.parametrize("name,k", [("karate", 3), ("karate_w", 4), ("karate", 5),
                                    ("rmat10", 4), ("rmat10_w", 5)])
def test_ktruss_matches_jax(name, k):
    jg, tg = _graphs(name)
    js, jd, jw = _edges(cg.ktruss(jg, k), True)
    ts, td, tw = _edges(ct.ktruss(tg, k), False)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(td, jd)
    if jw is not None:
        np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("name", ["karate", "rmat10_w"])
def test_ecg_matches_jax(name):
    jg, tg = _graphs(name)
    want_labels, want_q = cg.ecg(jg, ensemble_size=4, seed=5)
    labels, q = ct.ecg(tg, ensemble_size=4, seed=5)
    assert abs(q - want_q) <= TOL_Q
    if name == "karate":
        np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))


@pytest.mark.parametrize("name,seed,radius", [("karate", 0, 1), ("karate", 33, 2), ("rmat10_w", 0, 1),
                                              ("rmat10", 5, 2)])
def test_ego_graph_matches_jax(name, seed, radius):
    jg, tg = _graphs(name)
    jsub, jmap = cg.ego_graph(jg, seed, radius)
    tsub, tmap = ct.ego_graph(tg, seed, radius)
    np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))
    for a, b in zip(_edges(tsub, False), _edges(jsub, True)):
        if b is not None:
            np.testing.assert_array_equal(a, b)


def _same_partition(a, b):
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("name", ["karate", "karate_w", "rmat10"])
@pytest.mark.parametrize("k", [2, 3])
def test_spectral_modularity_maximization_matches_jax(name, k):
    jg, tg = _graphs(name)
    got = ct.spectral_modularity_maximization_clustering(tg, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(cg.spectral_modularity_maximization_clustering(jg, k))
    )


@pytest.mark.parametrize("name", ["karate", "karate_w"])
@pytest.mark.parametrize("k", [2, 3])
def test_spectral_balanced_cut_matches_jax(name, k):
    jg, tg = _graphs(name)
    got = ct.spectral_balanced_cut_clustering(tg, k)
    want = np.asarray(cg.spectral_balanced_cut_clustering(jg, k))
    assert _same_partition(got.numpy(), want)
    assert torch.equal(ct.spectral_balanced_cut_clustering(tg, k), got)  # seeded start


def test_spectral_balanced_cut_structure_rmat():
    """Many components: the small eigenvalues repeat, so the JAX function's
    own partition varies from call to call; hold the port to its contract."""
    _, tg = _graphs("rmat10")
    got = ct.spectral_balanced_cut_clustering(tg, 3)
    assert got.shape == (tg.num_vertices,) and set(got.tolist()) == {0, 1, 2}
    assert torch.equal(ct.spectral_balanced_cut_clustering(tg, 3), got)


@pytest.mark.parametrize("fn", ["louvain", "leiden", "modularity", "triangle_count", "ecg"])
def test_requires_symmetric_graph(fn):
    g = ct.from_edgelist([0, 1], [1, 2], device="cpu")
    args = (np.zeros(3, np.int32),) if fn == "modularity" else ()
    with pytest.raises(ct.utils.GraphError, match="symmetric"):
        getattr(ct, fn)(g, *args)
