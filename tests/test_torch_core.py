"""cugraph_tpu_torch core (renumber, CSR/CSC, R-MAT) against cugraph_tpu.

Both packages get the same numpy edge list and must give EQUAL arrays:
renumber maps, offsets, and minors/majors/weights on [:num_edges] (the JAX
package pads edge arrays to 128 lanes; the port does not). R-MAT draws
differ by construction (torch Philox vs JAX threefry), so the generator is
checked for structure; the scrambling bijection is bit-equal.
"""

import networkx as nx
import numpy as np
import pytest
import torch

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.core import convert as jconvert
from cugraph_tpu.core import renumber as jrn
from cugraph_tpu.core.symmetrize import coalesce_edgelist_np
from cugraph_tpu.generators.rmat import rmat_edgelist as jax_rmat
from cugraph_tpu.generators.rmat import scramble_vertex_ids as jax_scramble


def _karate():
    e = np.array(nx.karate_club_graph().edges(), dtype=np.int32)
    return e[:, 0], e[:, 1], None, 34


def _rmat_np(scale, edgefactor, seed, weighted):
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
    "rmat10": lambda: _rmat_np(10, 16, 0, False),
    "rmat10w": lambda: _rmat_np(10, 16, 1, True),
}


@pytest.mark.parametrize("name", ["karate", "rmat10"])
def test_renumber_equals_jax(name):
    src, dst, _, v = GRAPHS[name]()
    want = jrn.compute_renumber_map(src, dst, v)
    got = ct.compute_renumber_map(src, dst, v, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    ws, wd = jrn.apply_renumber_map(want, src, dst)
    gs, gd = ct.apply_renumber_map(got, src, dst, device="cpu")
    np.testing.assert_array_equal(gs.numpy(), ws)
    np.testing.assert_array_equal(gd.numpy(), wd)


def _assert_adj_equal(got, want):
    e = want.num_edges
    assert got.num_edges == e and got.num_majors == want.num_majors
    np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
    np.testing.assert_array_equal(got.minors.numpy(), np.asarray(want.minors)[:e])
    np.testing.assert_array_equal(got.majors.numpy(), np.asarray(want.majors)[:e])
    if want.weights is None:
        assert got.weights is None
    else:
        np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights)[:e])


@pytest.mark.parametrize("name", ["karate", "rmat10", "rmat10w"])
def test_from_edgelist_equals_jax(name):
    src, dst, w, v = GRAPHS[name]()
    jg = cg.from_edgelist(src, dst, w, num_vertices=v)
    tg = ct.from_edgelist(src, dst, w, num_vertices=v, device="cpu")
    assert tg.num_vertices == jg.num_vertices and tg.num_edges == jg.num_edges
    _assert_adj_equal(tg.csr(), jg.csr())
    _assert_adj_equal(tg.csc(), jg.csc())
    np.testing.assert_array_equal(tg.in_degrees().numpy(), np.asarray(jg.in_degrees()))
    np.testing.assert_array_equal(tg.out_degrees().numpy(), np.asarray(jg.out_degrees()))
    # weighted sums: f32 adds in another order, so 1e-6 relative
    np.testing.assert_allclose(
        tg.out_weight_sums().numpy(), np.asarray(jg.out_weight_sums()), rtol=1e-6
    )
    np.testing.assert_allclose(
        tg.in_weight_sums().numpy(), np.asarray(jg.in_weight_sums()), rtol=1e-6
    )


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("name", ["karate", "rmat10", "rmat10w"])
def test_symmetrize_equals_jax(name, multi):
    """symmetrize=True (coalesced, reciprocal pairs keep the min weight;
    or multi, every copy kept): equal CSR, and the CSC is the same
    adjacency, as in the JAX package."""
    src, dst, w, v = GRAPHS[name]()
    jg = cg.from_edgelist(src, dst, w, num_vertices=v, symmetrize=True, multi=multi)
    tg = ct.from_edgelist(src, dst, w, num_vertices=v, symmetrize=True, multi=multi,
                          device="cpu")
    assert tg.is_symmetric and jg.is_symmetric
    assert tg.num_edges == jg.num_edges and tg.weighted == jg.weighted
    assert tg.csc() is tg.csr()
    _assert_adj_equal(tg.csr(), jg.csr())
    _assert_adj_equal(tg.csc(), jg.csc())


@pytest.mark.parametrize("store", ["both", "out"])
def test_is_symmetric_shares_one_adjacency(store):
    src, dst, w, v = GRAPHS["rmat10w"]()
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    w = np.concatenate([w, w])
    jg = cg.from_edgelist(src, dst, w, num_vertices=v, is_symmetric=True, store=store)
    tg = ct.from_edgelist(src, dst, w, num_vertices=v, is_symmetric=True, store=store,
                          device="cpu")
    assert tg.is_symmetric and tg.csc() is tg.csr()
    _assert_adj_equal(tg.csc(), jg.csc())
    plain = ct.from_edgelist(src, dst, w, num_vertices=v, device="cpu")
    assert not plain.is_symmetric and plain.csc() is not plain.csr()


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_coalesce_equals_jax(reduce):
    src, dst, w, v = GRAPHS["rmat10w"]()
    ws, wd, ww = coalesce_edgelist_np(src, dst, w, reduce=reduce)
    ts, td, tw = ct.core.coalesce_edgelist(src, dst, w, reduce=reduce, device="cpu")
    assert len(ws) < len(src)  # R-MAT has parallel edges
    np.testing.assert_array_equal(ts.numpy(), ws)
    np.testing.assert_array_equal(td.numpy(), wd)
    np.testing.assert_allclose(tw.numpy(), ww, rtol=1e-6)
    us, ud, uw = ct.core.coalesce_edgelist(src, dst, device="cpu")
    assert uw is None and torch.equal(us, ts) and torch.equal(ud, td)


@pytest.mark.parametrize("name", ["karate", "rmat10w"])
def test_decompress_and_transpose_equal_jax(name):
    src, dst, w, v = GRAPHS[name]()
    jg = cg.from_edgelist(src, dst, w, num_vertices=v)
    tg = ct.from_edgelist(src, dst, w, num_vertices=v, device="cpu")
    for got, want in zip(ct.core.decompress_to_edgelist(tg), jconvert.decompress_to_edgelist(jg)):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    jt, tt = jconvert.transpose(jg), ct.core.transpose(tg)
    _assert_adj_equal(tt.csr(), jt.csr())
    _assert_adj_equal(tt.csc(), jt.csc())
    _assert_adj_equal(tt.csr(), tg.csc())
    gin = ct.from_edgelist(src, dst, w, num_vertices=v, store="in", device="cpu")
    for got, want in zip(ct.core.decompress_to_edgelist(gin)[:2], (src, dst)):
        np.testing.assert_array_equal(np.sort(got.numpy()), np.sort(want))


def test_from_edgelist_store_and_checks():
    src, dst, _, v = _karate()
    g = ct.from_edgelist(src, dst, num_vertices=v, store="in", device="cpu")
    assert g.out_adj is None and g.csc().num_edges == len(src)
    with pytest.raises(ct.utils.GraphError):
        g.csr()
    with pytest.raises(ct.utils.GraphError):
        ct.from_edgelist(src, dst, num_vertices=10, device="cpu")


def _top1pct_share(src, dst, v):
    deg = np.bincount(src, minlength=v) + np.bincount(dst, minlength=v)
    k = max(v // 100, 1)
    return np.sort(deg)[::-1][:k].sum() / deg.sum()


def test_rmat_structure_matches_jax_skew():
    scale, e = 12, 16 << 12
    s, d = ct.rmat_edgelist(scale, e, scramble=True, device="cpu")
    assert s.shape == d.shape == (e,) and s.dtype == torch.int32
    s, d = s.numpy(), d.numpy()
    assert s.min() >= 0 and d.min() >= 0 and max(s.max(), d.max()) < 1 << scale
    js, jd = (np.asarray(a) for a in jax_rmat(scale, e, scramble=True))
    got, want = _top1pct_share(s, d, 1 << scale), _top1pct_share(js, jd, 1 << scale)
    # same distribution, other random bits: the top-1% degree share agrees
    # within 10% (it is ~0.28 here; uniform ids would give ~0.015)
    assert abs(got - want) < 0.1 * want, (got, want)
    g = torch.Generator().manual_seed(0)
    s2, _ = ct.rmat_edgelist(scale, e, scramble=True, generator=g, device="cpu")
    np.testing.assert_array_equal(s2.numpy(), s)  # the default seed is 0


def test_scramble_equals_jax():
    ids = np.arange(1 << 12, dtype=np.int32)
    got = ct.scramble_vertex_ids(torch.from_numpy(ids), 12).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_scramble(ids, 12)))
    assert np.array_equal(np.sort(got), ids)  # a bijection


@pytest.mark.parametrize("name", ["karate", "rmat10w"])
def test_relabel_equals_jax(name):
    src, dst, w, v = GRAPHS[name]()
    perm = np.random.default_rng(1).permutation(v).astype(np.int32)
    jg = cg.from_edgelist(src, dst, w, num_vertices=v)
    tg = ct.from_edgelist(src, dst, w, num_vertices=v, device="cpu")
    jr, tr = jconvert.relabel(jg, perm), ct.core.relabel(tg, torch.from_numpy(perm))
    _assert_adj_equal(tr.csr(), jr.csr())
    _assert_adj_equal(tr.csc(), jr.csc())


@pytest.mark.parametrize("relabel_result", [True, False])
@pytest.mark.parametrize("name", ["karate", "rmat10w"])
def test_induced_subgraph_equals_jax(name, relabel_result):
    src, dst, w, v = GRAPHS[name]()
    sym = name == "karate"
    keep = np.random.default_rng(2).integers(0, v, v // 2)  # repeats, unsorted
    jg = cg.from_edgelist(src, dst, w, num_vertices=v, symmetrize=sym)
    tg = ct.from_edgelist(src, dst, w, num_vertices=v, symmetrize=sym, device="cpu")
    js, jmap = jconvert.induced_subgraph(jg, keep, relabel_result)
    ts, tmap = ct.core.induced_subgraph(tg, torch.from_numpy(keep), relabel_result)
    assert tmap.dtype == torch.int32
    np.testing.assert_array_equal(tmap.numpy(), jmap)
    assert ts.num_vertices == js.num_vertices and ts.is_symmetric == js.is_symmetric
    _assert_adj_equal(ts.csr(), js.csr())
    _assert_adj_equal(ts.csc(), js.csc())


@pytest.mark.parametrize("name", ["karate", "rmat10", "rmat10w"])
def test_coarsen_graph_equals_jax(name):
    """Parallel edges merge with summed weights, in the same sort order:
    weights EQUAL (the same f32 terms in the same order on the CPU)."""
    from cugraph_tpu.core.coarsen import coarsen_graph as jcoarsen

    src, dst, w, v = GRAPHS[name]()
    labels = (np.random.default_rng(3).integers(0, 40, v) * 3).astype(np.int32)
    jg = cg.from_edgelist(src, dst, w, num_vertices=v, symmetrize=True)
    tg = ct.from_edgelist(src, dst, w, num_vertices=v, symmetrize=True, device="cpu")
    jc, jids = jcoarsen(jg, labels)
    tc, tids = ct.core.coarsen_graph(tg, torch.from_numpy(labels))
    np.testing.assert_array_equal(tids.numpy(), jids)
    assert tc.num_vertices == jc.num_vertices and tc.is_symmetric
    _assert_adj_equal(tc.csr(), jc.csr())
