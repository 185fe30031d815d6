"""Link prediction of cugraph_tpu_torch against cugraph_tpu on the CPU.

Tolerances, and why:
- unweighted coefficients within 1e-7 absolute: the intersections are
  exact integer counts in both, and the port keeps the JAX package's
  float32 expressions (a + b - inter, 2 inter / (a + b), min(a, b),
  sqrt(a b), the denom > 0 guard), so they agree to the last bit or so;
- weighted coefficients within 1e-5 relative: the port adds the vertex
  weights and the sums over neighbours in float64, the JAX package in
  float32 in another order;
- weighted coefficients of a hub's pairs within 1e-6 relative of float64
  scipy (``TOL_HUB_REL``): float32 operands rounded once, then the
  float32 expression, a few ulps in all; float32 sums over the hub's
  2^14 neighbours would be ~5e-6 off.
The port expands each pair's lower-degree endpoint a chunk at a time;
``PAIR_BUDGET`` set to a few slots makes the pairs span many chunks.
"""

import networkx as nx
import numpy as np
import pytest
import torch

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu_torch.prims import intersection

KINDS = ("jaccard", "sorensen", "overlap", "cosine")
TOL_ABS = 1e-7
TOL_W_REL = 1e-5
TOL_HUB_REL = 1e-6


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


def _weights(n, seed=3):
    return np.random.default_rng(seed).random(n).astype(np.float32) + 0.5


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


def _check(want, got, weighted):
    wv1, wv2, wc = (np.asarray(a) for a in want)
    gv1, gv2, gc = (a.numpy() for a in got)
    np.testing.assert_array_equal(gv1, wv1)
    np.testing.assert_array_equal(gv2, wv2)
    assert gc.dtype == np.float32
    if weighted:
        np.testing.assert_allclose(gc, wc, rtol=TOL_W_REL, atol=0)
    else:
        np.testing.assert_allclose(gc, wc, rtol=0, atol=TOL_ABS)
    return gc


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["karate", "rmat10"])
def test_default_pairs_match_jax(name, kind):
    jg, tg = _graphs(name)
    c = _check(getattr(cg, kind)(jg), getattr(ct, kind)(tg), False)
    assert (c > 0).any() and (c <= 1 + 1e-6).all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["karate_w", "rmat10_w"])
def test_use_weight_matches_jax(name, kind):
    jg, tg = _graphs(name)
    _check(getattr(cg, kind)(jg, use_weight=True), getattr(ct, kind)(tg, use_weight=True), True)


@pytest.fixture(scope="module")
def hub_graph():
    """A star of 2^14 leaves plus 4 x 2^14 distinct leaf edges, weights in
    [0.5, 1.5); 256 hub pairs and 256 leaf edges as pairs; each
    coefficient in float64 by scipy (intersection weight
    (B[v1] .* B[v2]) @ vw, size B @ vw, vw the edge-weight sums)."""
    import scipy.sparse as sp

    n = 1 << 14
    rng = np.random.default_rng(5)
    a, b = rng.integers(1, n + 1, (2, 4 * n))
    src = np.concatenate([np.zeros(n, np.int64), a])
    dst = np.concatenate([np.arange(1, n + 1), b])
    keep = src != dst
    e = np.unique(np.sort(np.stack([src[keep], dst[keep]], 1), axis=1), axis=0)
    src, dst = e[:, 0], e[:, 1]
    w = (rng.random(len(src)) + 0.5).astype(np.float32)
    v = n + 1
    g = ct.from_edgelist(src.astype(np.int32), dst.astype(np.int32), w, num_vertices=v,
                         symmetrize=True, device="cpu")
    rows, cols = np.concatenate([src, dst]), np.concatenate([dst, src])
    adj = sp.csr_matrix((np.concatenate([w, w]).astype(np.float64), (rows, cols)), shape=(v, v))
    ones = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(v, v))
    vw = np.asarray(adj.sum(1)).ravel()
    size = ones @ vw
    edge = rng.choice(len(src), 256, replace=False)
    v1 = np.concatenate([np.zeros(256, np.int64), src[edge]])
    v2 = np.concatenate([rng.choice(np.arange(1, n + 1), 256, replace=False), dst[edge]])
    inter = np.asarray(ones[v1].multiply(ones[v2]) @ vw).ravel()
    x, y = size[v1], size[v2]
    ref = {"jaccard": inter / (x + y - inter), "sorensen": 2 * inter / (x + y),
           "overlap": inter / np.minimum(x, y), "cosine": inter / np.sqrt(x * y)}
    return g, (torch.from_numpy(v1), torch.from_numpy(v2)), ref


@pytest.mark.parametrize("kind", KINDS)
def test_use_weight_hub_pairs_match_float64(hub_graph, kind):
    g, pairs, ref = hub_graph
    c = getattr(ct, kind)(g, pairs, use_weight=True)[2]
    assert (ref[kind] > 0).all()
    np.testing.assert_allclose(c.double().numpy(), ref[kind], rtol=TOL_HUB_REL, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_explicit_pairs_both_orders(kind):
    jg, tg = _graphs("rmat10")
    rng = np.random.default_rng(11)
    v1 = rng.integers(0, 1024, 300).astype(np.int32)
    v2 = rng.integers(0, 1024, 300).astype(np.int32)
    deg = np.asarray(jg.out_degrees())
    v1[:20] = np.argsort(-deg)[:20]  # hub rows against small ones, both ways
    for a, b in ((v1, v2), (v2, v1)):
        got = getattr(ct, kind)(tg, (torch.from_numpy(a), torch.from_numpy(b)))
        _check(getattr(cg, kind)(jg, (a, b)), got, False)
    fwd = getattr(ct, kind)(tg, (v1, v2))[2]
    bwd = getattr(ct, kind)(tg, (v2, v1))[2]
    np.testing.assert_array_equal(fwd.numpy(), bwd.numpy())


def test_isolated_endpoint_gives_zero():
    src, dst, _ = _karate()
    jg = cg.from_edgelist(src, dst, num_vertices=40, symmetrize=True)
    tg = ct.from_edgelist(src, dst, num_vertices=40, symmetrize=True, device="cpu")
    pairs = (np.array([0, 37, 38, 33], np.int32), np.array([39, 1, 38, 32], np.int32))
    for kind in KINDS:
        c = _check(getattr(cg, kind)(jg, pairs), getattr(ct, kind)(tg, pairs), False)
        assert (c[:3] == 0).all() and c[3] > 0


@pytest.mark.parametrize("name,weighted", [("rmat10", False), ("rmat10_w", True)])
def test_chunked_intersection_spans_many_chunks(name, weighted, monkeypatch):
    jg, tg = _graphs(name)
    want = {kind: getattr(cg, kind)(jg, use_weight=weighted) for kind in KINDS}
    calls = []
    real = intersection.ragged_chunks

    def counting(counts, budget):
        chunks = list(real(counts, budget))
        calls.append(len(chunks))
        yield from chunks

    monkeypatch.setattr(intersection, "PAIR_BUDGET", 7)
    monkeypatch.setattr(intersection, "ragged_chunks", counting)
    for kind in KINDS:
        _check(want[kind], getattr(ct, kind)(tg, use_weight=weighted), weighted)
    assert min(calls) > 100


@pytest.mark.parametrize("topk", [None, 25])
@pytest.mark.parametrize("kind", ["jaccard", "overlap"])
def test_all_pairs_similarity_matches_jax(kind, topk):
    jg, tg = _graphs("karate")
    want = cg.all_pairs_similarity(jg, kind, topk=topk)
    got = ct.all_pairs_similarity(tg, kind, topk=topk)
    c = _check(want, got, False)
    if topk is not None:
        assert c.shape == (topk,) and (np.diff(c) <= 0).all()


def test_requires_symmetric_and_weights():
    src, dst, v = _karate()
    g = ct.from_edgelist(src, dst, num_vertices=v, device="cpu")
    with pytest.raises(RuntimeError, match="symmetric"):
        ct.jaccard(g)
    with pytest.raises(RuntimeError, match="edge weights"):
        ct.jaccard(_graphs("karate")[1], use_weight=True)
