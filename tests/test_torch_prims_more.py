"""The vertex, whole-edge, keyed and intersection prims of cugraph_tpu_torch
against cugraph_tpu on the CPU.

Integer results (counts, masks, keys, intersections) must be EQUAL; f32
sums within 1e-5 relative (the same terms in another order), except the
keyed aggregation, whose runs add the same terms in the same order in
both packages and must be EQUAL. The JAX package pads edge arrays to 128
lanes; its per-edge outputs are compared on [:num_edges].
"""

import importlib

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

import cugraph_tpu as cg
import cugraph_tpu_torch as ct
from cugraph_tpu.prims.reduce_ops import MAXIMUM as JMAX
from cugraph_tpu.prims.reduce_ops import MINIMUM as JMIN
from cugraph_tpu.prims.reduce_ops import PLUS as JPLUS
from cugraph_tpu_torch.prims.reduce_ops import MAXIMUM, MINIMUM, PLUS

# by module path: both packages' prims export functions named like their
# modules (transform_e)
jint, jkeyed, jte, jvertex, tint, tkeyed, tte, tvertex = (
    importlib.import_module(f"{pkg}.prims.{m}")
    for pkg in ("cugraph_tpu", "cugraph_tpu_torch")
    for m in ("intersection", "keyed", "transform_e", "vertex")
)
OPS = {"plus": (JPLUS, PLUS), "min": (JMIN, MINIMUM), "max": (JMAX, MAXIMUM)}


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


def _karate():
    e = np.array(nx.karate_club_graph().edges(), dtype=np.int32)
    return e[:, 0], e[:, 1], 34


GRAPHS = {
    "karate_sym": (_karate, False, True, None),
    "rmat9_w": (lambda: _rmat_np(9, 8, 0), True, False, "both"),
    "rmat9_in": (lambda: _rmat_np(9, 8, 1), False, False, "in"),
}


@pytest.fixture(scope="module", params=list(GRAPHS))
def graphs(request):
    make, weighted, sym, store = GRAPHS[request.param]
    src, dst, v = make()
    w = np.random.default_rng(2).random(len(src)).astype(np.float32) if weighted else None
    kw = dict(num_vertices=v, symmetrize=sym)
    if store:
        kw["store"] = store
    return cg.from_edgelist(src, dst, w, **kw), ct.from_edgelist(src, dst, w, device="cpu", **kw)


def _vals(v, seed=0):
    return np.random.default_rng(seed).standard_normal(v).astype(np.float32)


@pytest.mark.parametrize("op", list(OPS))
def test_vertex_prims_match_jax(graphs, op):
    jg, tg = graphs
    x = _vals(tg.num_vertices)
    jop, top = OPS[op]
    want = jvertex.reduce_v(jg, jnp.asarray(x), reduce_op=jop, init=0.5)
    got = tvertex.reduce_v(tg, torch.from_numpy(x), reduce_op=top, init=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    want = jvertex.transform_reduce_v(jg, lambda i, v: v * i, jnp.asarray(x), reduce_op=jop)
    got = tvertex.transform_reduce_v(tg, lambda i, v: v * i, torch.from_numpy(x), reduce_op=top)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    want = jvertex.count_if_v(jg, lambda i, v: (v > 0) & (i % 3 == 0), jnp.asarray(x))
    got = tvertex.count_if_v(tg, lambda i, v: (v > 0) & (i % 3 == 0), torch.from_numpy(x))
    assert got.dtype == torch.int32 and int(got) == int(want)


def test_reduce_v_empty_graph_gives_identity():
    g = ct.from_edgelist([], [], num_vertices=0, device="cpu")
    assert float(tvertex.reduce_v(g, torch.zeros(0), reduce_op=MINIMUM)) == float("inf")
    assert int(tvertex.count_if_v(g, lambda i, v: i >= 0)) == 0


def _e_op(s, d, sv, dv, w):
    diff = s - d
    diff = diff.to(sv.dtype) if isinstance(diff, torch.Tensor) else diff.astype(sv.dtype)
    out = sv * dv + diff
    return out if w is None else out * w


@pytest.mark.parametrize("op", list(OPS))
def test_transform_e_prims_match_jax(graphs, op):
    jg, tg = graphs
    e = tg.num_edges
    x = _vals(tg.num_vertices, 1)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jop, top = OPS[op]
    want = np.asarray(jte.transform_e(jg, _e_op, src_values=jx, dst_values=jx))[:e]
    got = tte.transform_e(tg, _e_op, src_values=tx, dst_values=tx)
    np.testing.assert_array_equal(got.numpy(), want)
    want = jte.transform_reduce_e(jg, _e_op, reduce_op=jop, init=1.0, src_values=jx, dst_values=jx)
    got = tte.transform_reduce_e(tg, _e_op, reduce_op=top, init=1.0, src_values=tx, dst_values=tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)

    def pred(s, d, sv, dv, w):
        return (sv > dv) & (s != d)

    want = np.asarray(jte.extract_if_e(jg, pred, src_values=jx, dst_values=jx))[:e]
    got = tte.extract_if_e(tg, pred, src_values=tx, dst_values=tx)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    want = jte.count_if_e(jg, pred, src_values=jx, dst_values=jx)
    got = tte.count_if_e(tg, pred, src_values=tx, dst_values=tx)
    assert got.dtype == torch.int32 and int(got) == int(want)


def test_transform_reduce_e_keeps_feature_axes(graphs):
    jg, tg = graphs
    x = np.random.default_rng(3).standard_normal((tg.num_vertices, 4)).astype(np.float32)

    def op(s, d, sv, dv, w):
        return sv - dv

    want = jte.transform_reduce_e(jg, op, src_values=jnp.asarray(x), dst_values=jnp.asarray(x))
    got = tte.transform_reduce_e(tg, op, src_values=torch.from_numpy(x), dst_values=torch.from_numpy(x))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("side", ["src", "dst"])
@pytest.mark.parametrize("op", list(OPS))
def test_keyed_reduce_by_key_matches_jax(graphs, side, op):
    jg, tg = graphs
    keys = (np.arange(tg.num_vertices) * 7 % 13).astype(np.int32)
    x = _vals(tg.num_vertices, 4)
    jop, top = OPS[op]
    jfn = getattr(jkeyed, f"transform_reduce_e_by_{side}_key")
    tfn = getattr(tkeyed, f"transform_reduce_e_by_{side}_key")
    want = jfn(jg, jnp.asarray(keys), _e_op, num_keys=13, reduce_op=jop,
               src_values=jnp.asarray(x), dst_values=jnp.asarray(x))
    got = tfn(tg, torch.from_numpy(keys), _e_op, num_keys=13, reduce_op=top,
              src_values=torch.from_numpy(x), dst_values=torch.from_numpy(x))
    assert got.shape == (13,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("nkeys", [3, 50, None])
def test_aggregate_by_dst_key_matches_jax(graphs, nkeys):
    jg, tg = graphs
    v = tg.num_vertices
    if tg.out_adj is None:  # both run over the CSR, and raise without one
        for fn, gr, keys in ((jkeyed, jg, jnp.zeros(v, jnp.int32)),
                             (tkeyed, tg, torch.zeros(v, dtype=torch.int32))):
            with pytest.raises(RuntimeError, match="without out-adjacency"):
                fn.aggregate_outgoing_e_by_dst_key(gr, keys)
        return
    keys = np.arange(v, dtype=np.int32) if nkeys is None else (
        np.random.default_rng(nkeys).integers(-nkeys, nkeys, v).astype(np.int32))
    e = tg.num_edges
    js, jk, jw, jv = (np.asarray(a)[:e] for a in jkeyed.aggregate_outgoing_e_by_dst_key(jg, jnp.asarray(keys)))
    ts, tk, tw, tv = tkeyed.aggregate_outgoing_e_by_dst_key(tg, torch.from_numpy(keys))
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tw.numpy(), jw)

    def kv_op(s, k, w, valid):
        return w * (k % 5 + 1)

    for jop, top in ((JPLUS, PLUS), (JMAX, MAXIMUM)):
        want = jkeyed.per_v_transform_reduce_dst_key_aggregated_outgoing_e(
            jg, jnp.asarray(keys), kv_op, reduce_op=jop, init=0.25)
        got = tkeyed.per_v_transform_reduce_dst_key_aggregated_outgoing_e(
            tg, torch.from_numpy(keys), kv_op, reduce_op=top, init=0.25)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_contains_sorted_and_candidate_tile_match_jax(graphs):
    jg, tg = graphs
    jadj, tadj = (jg.csc(), tg.csc())
    v = tg.num_vertices
    rng = np.random.default_rng(5)
    verts = rng.integers(0, v, 64).astype(np.int32)
    width = int(np.diff(np.asarray(jadj.offsets)).max())
    jc, jm = jint._candidate_tile(jadj, jnp.asarray(verts), width)
    # the port expands each row on its own (ragged_chunks) where the JAX
    # package tiles it: the tile's valid slots, row-major, at 5-slot chunks
    tverts = torch.from_numpy(verts).long()
    offsets = tadj.offsets.long()
    degs = offsets[tverts + 1] - offsets[tverts]
    rows, cands = [], []
    for _, _, owner, rank in tint.ragged_chunks(degs, 5):
        rows.append(owner)
        cands.append(tadj.minors[offsets[tverts[owner]] + rank])
    jm = np.asarray(jm)
    np.testing.assert_array_equal(torch.cat(rows).numpy(), np.nonzero(jm)[0])
    np.testing.assert_array_equal(torch.cat(cands).numpy(), np.asarray(jc)[jm])
    q = rng.integers(0, v, (64, 16)).astype(np.int32)
    lo = np.asarray(jadj.offsets)[verts][:, None]
    hi = np.asarray(jadj.offsets)[verts + 1][:, None]
    want = jint._contains_sorted(jadj.minors, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(q))
    # the port searches the sorted edge keys where the JAX package searches
    # each row's minors
    got = tint.edge_multiplicity(tint.edge_keys(tadj), tadj.num_minors,
                                 torch.from_numpy(verts)[:, None], torch.from_numpy(q)) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()


def test_pair_intersection_matches_jax(graphs):
    jg, tg = graphs
    v = tg.num_vertices
    rng = np.random.default_rng(6)
    v1, v2 = rng.integers(0, v, 200).astype(np.int32), rng.integers(0, v, 200).astype(np.int32)
    if tg.out_adj is None:  # both run over the CSR, and raise without one
        for fn, gr, a, b in ((jint, jg, jnp.asarray(v1), jnp.asarray(v2)),
                             (tint, tg, torch.from_numpy(v1), torch.from_numpy(v2))):
            with pytest.raises(RuntimeError, match="without out-adjacency"):
                fn.per_v_pair_dst_nbr_intersection(gr, a, b, max_degree=4)
        return
    wts = _vals(v, 7)
    maxd = int(np.diff(np.asarray(jg.csr().offsets)).max())
    jc, jw = jint.per_v_pair_dst_nbr_intersection(
        jg, jnp.asarray(v1), jnp.asarray(v2), max_degree=maxd, vertex_weights=jnp.asarray(wts))
    tc, tw = tint.per_v_pair_dst_nbr_intersection(
        tg, torch.from_numpy(v1), torch.from_numpy(v2), max_degree=maxd,
        vertex_weights=torch.from_numpy(wts))
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale", [8, 10])
def test_triangle_counts_per_vertex_matches_jax(scale):
    """The same DAG (oriented by id, as the JAX package orients) in both."""
    from cugraph_tpu.core.csr import _build_adj_np

    src, dst, v = _rmat_np(scale, 8, scale)
    jg = cg.from_edgelist(src, dst, num_vertices=v, symmetrize=True)
    s = np.asarray(jg.csr().majors)[: jg.num_edges]
    d = np.asarray(jg.csr().minors)[: jg.num_edges]
    keep = s < d
    jadj = _build_adj_np(s[keep], d[keep], None, v, v)
    maxd = int(np.diff(np.asarray(jadj.offsets)).max())
    want = np.asarray(jint.triangle_counts_per_vertex(jadj, v, max_oriented_degree=maxd))
    tadj = ct.core.csr._build_adj(torch.from_numpy(s[keep]), torch.from_numpy(d[keep]), None, v, v)
    got = tint.triangle_counts_per_vertex(tadj, v, wedge_budget=1000)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the port's own orientation by degree gives the same counts
    oriented = tint.degree_oriented_adj(torch.from_numpy(s[keep]), torch.from_numpy(d[keep]), v)
    np.testing.assert_array_equal(tint.triangle_counts_per_vertex(oriented, v).numpy(), want)
    # edge support: each triangle counted once on each of its three edges
    support = tint.edge_triangle_support(oriented)
    assert int(support.sum()) == int(want.sum())
