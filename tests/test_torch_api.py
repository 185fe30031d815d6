"""The user-facing layer of cugraph_tpu_torch against cugraph_tpu.api on the CPU.

Every test of tests/test_api.py is mirrored here with ``device="cpu"``
and held against the JAX package's API on the same input: karate, string
and multi-column ids, nx input and output, k-core, the sampler, the
numpy/scipy constructors, the conversions, PropertyGraph and the
multigraph. Besides:

- ``NumberMap``'s internal ids equal the JAX package's bit for bit (int64,
  string and two-column ids, with parallel edges and self-loops);
- every ``api.algorithms`` wrapper equals the port's core call on
  ``G.core``, mapped through ``to_external``, bit for bit;
- the wrappers whose result does not depend on a draw equal the JAX API's
  within the tolerance stated with each (the f32 sums of the two packages
  run in other orders: PageRank, HITS, Katz, eigenvector and betweenness
  within 1e-5 of max |x|, the coefficients within 1e-6, modularity within
  1e-6; ids, distances, labels, counts and predecessors are equal);
- the sampler's and the walks' draws differ from JAX's by design (a
  ``torch.Generator``), so their mirror holds structure: every sampled
  step is an edge, hops and shapes as the fanouts and the depth say.
"""

import doctest

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import cugraph_tpu.api as japi
from cugraph_tpu.api import algorithms as jalg
from cugraph_tpu.core.renumber import NumberMap as JaxNumberMap
from cugraph_tpu.testing import karate_edgelist as jax_karate

import cugraph_tpu_torch as ct
from cugraph_tpu_torch import api
from cugraph_tpu_torch.api import algorithms as alg
from cugraph_tpu_torch.api import graph as api_graph
from cugraph_tpu_torch.core.renumber import NumberMap
from cugraph_tpu_torch.testing import karate_edgelist
from cugraph_tpu_torch.utils.error import GraphError

CPU = "cpu"
TOL_SCORE_REL = 1e-5  # f32 iterative scores: max abs difference over max |x|
TOL_COEFF_ABS = 1e-6  # similarity coefficients and modularity


@pytest.fixture(scope="module")
def karate_pair():
    src, dst, w = karate_edgelist()
    g = api.Graph(device=CPU)
    g.from_numpy_edgelist(src, dst, w)
    jg = japi.Graph()
    jg.from_numpy_edgelist(*jax_karate())
    return g, jg


def _named_karate(directed=False, weighted=True):
    """Karate with string ids "v<i>" and seeded weights in [0.5, 1.5)."""
    src, dst, _ = karate_edgelist()
    rng = np.random.default_rng(3)
    df = pd.DataFrame({"source": [f"v{s}" for s in src], "destination": [f"v{d}" for d in dst]})
    if weighted:
        df["weight"] = rng.random(len(src)).astype(np.float32) + 0.5
    attr = "weight" if weighted else None
    g = api.Graph(directed=directed, device=CPU).from_pandas_edgelist(df, edge_attr=attr)
    jg = japi.Graph(directed=directed).from_pandas_edgelist(df, edge_attr=attr)
    return g, jg


@pytest.fixture(scope="module")
def named_pair():
    return _named_karate()


def _assert_rel(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


# ------------------------------------------------- tests/test_api.py mirrored


def test_graph_basics(karate_pair):
    g, jg = karate_pair
    assert g.number_of_vertices() == jg.number_of_vertices() == 34
    assert g.number_of_edges() == jg.number_of_edges() == 78
    assert not g.is_directed() and g.is_weighted()
    deg, jdeg = g.degree(), jg.degree()
    assert set(deg.columns) == {"vertex", "degree"}
    assert deg["degree"].sum() == 2 * 78
    pd.testing.assert_frame_equal(deg, jdeg, check_dtype=False)
    pd.testing.assert_frame_equal(g.in_degree(), jg.in_degree(), check_dtype=False)
    pd.testing.assert_frame_equal(g.edges(), jg.edges(), check_dtype=False)
    assert g.has_isolated_vertices() == jg.has_isolated_vertices()
    assert g.core.device == torch.device(CPU)


def test_string_vertex_ids():
    df = pd.DataFrame(
        {"source": ["alice", "bob", "carol"], "destination": ["bob", "carol", "alice"]}
    )
    g = api.Graph(device=CPU)
    g.from_pandas_edgelist(df)
    assert g.number_of_vertices() == 3
    res = alg.pagerank(g)
    assert set(res["vertex"]) == {"alice", "bob", "carol"}
    np.testing.assert_allclose(res["pagerank"].sum(), 1.0, rtol=1e-5)
    jres = jalg.pagerank(japi.Graph().from_pandas_edgelist(df))
    assert list(res["vertex"]) == list(jres["vertex"])
    _assert_rel(res["pagerank"], jres["pagerank"], TOL_SCORE_REL)


def test_multi_column_vertex_ids():
    df = pd.DataFrame({"s0": ["a", "a", "b", "c"], "s1": [1, 2, 1, 1],
                       "d0": ["a", "b", "c", "a"], "d1": [2, 1, 1, 1]})
    src, dst, nm = NumberMap.renumber(df, ["s0", "s1"], ["d0", "d1"], device=CPU)
    jsrc, jdst, jnm = JaxNumberMap.renumber(df, ["s0", "s1"], ["d0", "d1"])
    np.testing.assert_array_equal(src.numpy(), jsrc)
    np.testing.assert_array_equal(dst.numpy(), jdst)
    ext = nm.to_external(np.arange(nm.num_vertices))
    assert isinstance(ext, pd.DataFrame)
    pd.testing.assert_frame_equal(ext, jnm.to_external(np.arange(jnm.num_vertices)))
    ids = nm.to_internal([("a", 2), ("c", 1)])
    np.testing.assert_array_equal(ids, jnm.to_internal([("a", 2), ("c", 1)]))
    with pytest.raises(GraphError):
        nm.to_internal([("z", 9)])


def test_pagerank_df(karate_pair):
    g, jg = karate_pair
    res = alg.pagerank(g, tol=1e-8)
    assert list(res.columns) == ["vertex", "pagerank"]
    np.testing.assert_allclose(res["pagerank"].sum(), 1.0, rtol=1e-5)
    _assert_rel(res["pagerank"], jalg.pagerank(jg, tol=1e-8)["pagerank"], TOL_SCORE_REL)


def test_nx_input_returns_dict():
    src, dst, _ = karate_edgelist()
    G = nx.Graph(list(zip(src.tolist(), dst.tolist())))
    res = alg.pagerank(G, tol=1e-8, device=CPU)
    assert isinstance(res, dict)
    expected = nx.pagerank(G, tol=1e-10)
    for v, val in expected.items():
        np.testing.assert_allclose(res[v], val, rtol=1e-4)
    jres = jalg.pagerank(G, tol=1e-8)
    assert sorted(res) == sorted(jres)
    _assert_rel([res[v] for v in sorted(res)], [jres[v] for v in sorted(jres)], TOL_SCORE_REL)
    for fn in (alg.connected_components, alg.core_number, alg.triangle_count):
        got = fn(G, device=CPU)
        want = getattr(jalg, fn.__name__)(G)
        assert isinstance(got, dict) and got == want


def test_bfs_df(karate_pair):
    g, jg = karate_pair
    res = alg.bfs(g, 0)
    assert set(res.columns) == {"vertex", "distance", "predecessor"}
    assert res.loc[res["vertex"] == 0, "distance"].iloc[0] == 0
    pd.testing.assert_frame_equal(res, jalg.bfs(jg, 0), check_dtype=False)


def test_louvain_df(karate_pair):
    g, jg = karate_pair
    df, q = alg.louvain(g)
    assert q > 0.35
    assert "partition" in df.columns
    _, jq = jalg.louvain(jg)
    assert abs(q - jq) <= TOL_COEFF_ABS


def test_jaccard_df(karate_pair):
    g, jg = karate_pair
    df = alg.jaccard(g)
    assert set(df.columns) == {"first", "second", "jaccard_coeff"}
    assert len(df) == 78
    jdf = jalg.jaccard(jg)
    np.testing.assert_array_equal(df["first"], jdf["first"])
    np.testing.assert_array_equal(df["second"], jdf["second"])
    np.testing.assert_allclose(df["jaccard_coeff"], jdf["jaccard_coeff"], atol=TOL_COEFF_ABS)


def test_to_from_networkx():
    G = nx.karate_club_graph()
    g = api.from_networkx(G, device=CPU)
    assert g.number_of_vertices() == 34
    G2 = api.to_networkx(g)
    assert set((min(u, v), max(u, v)) for u, v in G2.edges) == set(
        (min(u, v), max(u, v)) for u, v in G.edges)
    jG2 = japi.to_networkx(japi.from_networkx(G))
    assert set(G2.edges) == set(jG2.edges)
    for u, v, d in G2.edges(data=True):
        assert d["weight"] == jG2.edges[u, v]["weight"]


def test_k_core_api(karate_pair):
    g, jg = karate_pair
    sub = alg.k_core(g, 4)
    assert sub.number_of_vertices() < 34
    jsub = jalg.k_core(jg, 4)
    assert sub.core.device == torch.device(CPU)
    np.testing.assert_array_equal(np.sort(sub.nodes()), np.sort(jsub.nodes()))
    pd.testing.assert_frame_equal(
        sub.edges().sort_values(["src", "dst"], ignore_index=True),
        jsub.edges().sort_values(["src", "dst"], ignore_index=True), check_dtype=False)


def test_uniform_neighbor_sample_api(karate_pair):
    g, _ = karate_pair
    df = alg.uniform_neighbor_sample(g, [0, 1], [2, 2])
    assert set(df.columns) >= {"sources", "destinations", "hop_id"}
    edges = set(zip(karate_edgelist()[0].tolist(), karate_edgelist()[1].tolist()))
    for s, d in zip(df["sources"], df["destinations"]):
        assert (s, d) in edges or (d, s) in edges
    hop0 = df[df["hop_id"] == 0]
    assert set(hop0["sources"]) <= {0, 1} and len(hop0) == 4  # both have degree >= 2
    hop1 = df[df["hop_id"] == 1]
    assert set(hop1["sources"]) <= set(hop0["destinations"])
    deg = dict(zip(g.degree()["vertex"], g.degree()["degree"]))
    assert len(hop1) == sum(min(2, deg[v]) for v in hop0["destinations"])
    assert (df["indices"] == 1.0).all()  # karate's weights ride in "indices", as in JAX


def _directed():
    """extract_subgraph's default graph, on the CPU: create_using carries
    the device."""
    return api.Graph(directed=True, device=CPU)


def test_property_graph():
    def build(pkg):
        pg = pkg.PropertyGraph()
        v_df = pd.DataFrame(
            {"id": [0, 1, 2, 3], "age": [25, 30, 35, 40], "score": [1.0, 2.0, 3.0, 4.0]})
        pg.add_vertex_data(v_df, "id", type_name="person")
        e_df = pd.DataFrame({"src": [0, 1, 2], "dst": [1, 2, 3], "amount": [10.0, 20.0, 30.0]})
        pg.add_edge_data(e_df, ("src", "dst"), type_name="pays")
        return pg

    pg, jpg = build(api), build(japi)
    assert pg.get_num_vertices() == 4
    assert pg.get_num_edges() == 3
    assert pg.vertex_types == ["person"]
    assert pg.edge_types == ["pays"]
    got = pg.get_vertex_data(vertex_ids=[1, 2])
    assert got["age"].tolist() == [30, 35]
    pd.testing.assert_frame_equal(got, jpg.get_vertex_data(vertex_ids=[1, 2]))
    g = pg.extract_subgraph(create_using=_directed(), edge_weight_property="amount")
    assert g.number_of_vertices() == 4 and g.core.device == torch.device(CPU)
    jg = jpg.extract_subgraph(edge_weight_property="amount")
    pd.testing.assert_frame_equal(g.edges(), jg.edges(), check_dtype=False)
    sel = pg.select_edges("amount > 15")
    g2 = pg.extract_subgraph(create_using=_directed(), selection=sel)
    assert g2.core.num_edges == 2
    g3 = pg.extract_subgraph(create_using=api.Graph(device=CPU), selection=sel)
    assert g3.core.device == torch.device(CPU) and g3.number_of_edges() == 2


def test_graph_conversions(karate_pair):
    g, jg = karate_pair
    gd = g.to_directed()
    assert gd.is_directed() and gd.core.device == torch.device(CPU)
    assert gd.number_of_edges() == 156
    gu = gd.to_undirected()
    assert not gu.is_directed()
    jgu = jg.to_directed().to_undirected()
    pd.testing.assert_frame_equal(gu.edges(), jgu.edges(), check_dtype=False)


def test_from_numpy_array():
    a = np.array([[0, 1, 0], [0, 0, 2], [3, 0, 0]], dtype=np.float32)
    g = api.Graph(directed=True, device=CPU)
    g.from_numpy_array(a)
    assert g.number_of_vertices() == 3
    assert g.number_of_edges() == 3
    jg = japi.Graph(directed=True)
    jg.from_numpy_array(a)
    pd.testing.assert_frame_equal(g.edges(), jg.edges(), check_dtype=False)


def test_from_scipy_sparse():
    m = sp.coo_matrix(([1.0, 2.0], ([0, 1], [1, 2])), shape=(3, 3))
    g = api.Graph(directed=True, device=CPU)
    g.from_scipy_sparse(m)
    assert g.number_of_edges() == 2
    assert not g.is_renumbered()
    np.testing.assert_array_equal(g.edges()["weight"], [1.0, 2.0])


def test_property_graph_selections_and_types():
    pg = api.PropertyGraph()
    people = pd.DataFrame({"id": [0, 1, 2], "age": [25, 30, 35]})
    shops = pd.DataFrame({"id": [10, 11], "rating": [4.5, 3.0]})
    pg.add_vertex_data(people, "id", type_name="person")
    pg.add_vertex_data(shops, "id", type_name="shop")
    pays = pd.DataFrame({"s": [0, 1, 2], "d": [10, 11, 10], "amount": [5.0, 9.0, 2.0]})
    knows = pd.DataFrame({"s": [0, 1], "d": [1, 2]})
    pg.add_edge_data(pays, ("s", "d"), type_name="pays")
    pg.add_edge_data(knows, ("s", "d"), type_name="knows")

    assert pg.get_num_vertices() == 5
    assert pg.get_num_vertices("person") == 3
    assert pg.get_num_edges("pays") == 3 and pg.get_num_edges("knows") == 2
    assert pg.vertex_property_names == ["age", "rating"]
    assert "amount" in pg.edge_property_names
    assert len(pg.get_vertices()) == 5

    vsel = pg.select_vertices("_TYPE_ == 'person'")
    esel = pg.select_edges("_TYPE_ == 'knows'")
    combined = vsel + esel
    assert isinstance(combined, api.PropertySelection)
    g = pg.extract_subgraph(create_using=_directed(), selection=combined,
                            check_multi_edges=False)
    assert g.core.num_edges == 2

    gw = pg.extract_subgraph(create_using=_directed(), edge_weight_property="amount",
                             default_edge_weight=1.0, check_multi_edges=False)
    assert gw.core.weighted
    assert hasattr(gw, "edge_data") and len(gw.edge_data) == 5

    spans = pg.renumber_vertices_by_type()
    assert spans.loc["person", "stop"] - spans.loc["person", "start"] == 2
    espans = pg.renumber_edges_by_type()
    assert espans.loc["knows", "start"] == 0
    dup = pd.DataFrame({"s": [5, 5], "d": [6, 6]})
    pg2 = api.PropertyGraph()
    pg2.add_edge_data(dup, ("s", "d"))
    assert api.PropertyGraph.has_duplicate_edges(pg2._edge_df)
    with pytest.raises(GraphError):
        pg2.extract_subgraph(create_using=_directed())
    mg = pg2.extract_subgraph(create_using=api.MultiGraph(device=CPU))
    assert mg.core.num_edges == 4  # the two parallel edges, each both ways


def test_multigraph_preserves_parallel_edges():
    df = pd.DataFrame({"src": [0, 0, 0, 1], "dst": [1, 1, 2, 0], "w": [1.0, 2.0, 3.0, 4.0]})
    mg = api.MultiGraph(device=CPU)
    mg.from_pandas_edgelist(df, source="src", destination="dst", edge_attr="w")
    assert mg.number_of_edges() == 4
    g = api.Graph(device=CPU)
    g.from_pandas_edgelist(df, source="src", destination="dst", edge_attr="w")
    assert g.number_of_edges() == 2
    for ours, theirs in ((mg, japi.MultiGraph()), (g, japi.Graph())):
        theirs.from_pandas_edgelist(df, source="src", destination="dst", edge_attr="w")
        pd.testing.assert_frame_equal(ours.edges(), theirs.edges(), check_dtype=False)


# ---------------------------------------------------------------- NumberMap


def _id_frames():
    rng = np.random.default_rng(11)
    n, e = 300, 2000
    ids = rng.choice(np.iinfo(np.int64).max, n, replace=False).astype(np.int64) - (1 << 62)
    s, d = rng.integers(0, n, e), rng.integers(0, n, e)
    s[:40] = d[:40]  # self-loops; the draws repeat pairs, so parallel edges too
    yield "int64", pd.DataFrame({"a": ids[s], "b": ids[d]}), "a", "b"
    names = np.array([f"user-{x:x}" for x in ids])
    yield "str", pd.DataFrame({"a": names[s], "b": names[d]}), "a", "b"
    yield "two_columns", pd.DataFrame(
        {"a0": names[s], "a1": s % 7, "b0": names[d], "b1": d % 7}), ["a0", "a1"], ["b0", "b1"]


@pytest.mark.parametrize("kind", ["int64", "str", "two_columns"])
def test_number_map_internal_ids_equal_jax(kind):
    _, df, sc, dc = next(f for f in _id_frames() if f[0] == kind)
    src, dst, nm = NumberMap.renumber(df, sc, dc, device=CPU)
    jsrc, jdst, jnm = JaxNumberMap.renumber(df, sc, dc)
    assert src.dtype == torch.int32 and src.device == torch.device(CPU)
    np.testing.assert_array_equal(src.numpy(), jsrc)
    np.testing.assert_array_equal(dst.numpy(), jdst)
    assert nm.num_vertices == jnm.num_vertices
    every = np.arange(nm.num_vertices)
    ext, jext = nm.to_external(torch.from_numpy(every)), jnm.to_external(every)
    if isinstance(ext, pd.DataFrame):
        pd.testing.assert_frame_equal(ext, jext)
        keys = list(ext.itertuples(index=False, name=None))
    else:
        np.testing.assert_array_equal(ext, jext)
        keys = ext
    np.testing.assert_array_equal(nm.to_internal(keys), every)  # round trip
    np.testing.assert_array_equal(nm.to_internal(keys), jnm.to_internal(keys))
    unknown = [("no-such-user", 0)] if isinstance(ext, pd.DataFrame) else (
        ["no-such-user"] if kind == "str" else [np.int64(1 << 62)])
    with pytest.raises(GraphError, match="unknown external vertex id"):
        nm.to_internal(unknown)


# -------------------------------------- each wrapper against the port's core


def _core(name, g):
    """(wrapper result, the same from the port's core function mapped
    through to_external) for the wrapper ``name`` on the api.Graph g."""
    c = g.core
    ext = g.to_external
    vid = g.vertex_ids_external()

    def vframe(**cols):
        return pd.DataFrame({"vertex": vid, **{k: v.numpy() for k, v in cols.items()}})

    def pred(p):
        p = p.numpy()
        return np.where(p >= 0, ext(np.maximum(p, 0)), -1)

    if name == "pagerank":
        return alg.pagerank(g), vframe(pagerank=ct.pagerank(c, tol=1e-5)[0])
    if name == "hits":
        h, a, _ = ct.hits(c)
        return alg.hits(g), vframe(hubs=h, authorities=a)
    if name == "katz_centrality":
        return alg.katz_centrality(g), vframe(katz_centrality=ct.katz_centrality(c)[0])
    if name == "eigenvector_centrality":
        return alg.eigenvector_centrality(g), vframe(
            eigenvector_centrality=ct.eigenvector_centrality(c)[0])
    if name == "betweenness_centrality":
        return alg.betweenness_centrality(g, k=5), vframe(
            betweenness_centrality=ct.betweenness_centrality(c, k=5))
    if name == "degree_centrality":
        return alg.degree_centrality(g), vframe(degree_centrality=ct.degree_centrality(c))
    if name in ("bfs", "sssp"):
        start = g.to_internal(["v0"])
        d, p = getattr(ct, name)(c, start)
        got = getattr(alg, name)(g, "v0")
        return got, pd.DataFrame({"vertex": vid, "distance": d.numpy(), "predecessor": pred(p)})
    if name == "connected_components":
        return alg.connected_components(g), vframe(labels=ct.weakly_connected_components(c))
    if name == "strongly_connected_components":
        return alg.strongly_connected_components(g), vframe(
            labels=ct.strongly_connected_components(c))
    if name == "core_number":
        return alg.core_number(g), vframe(core_number=ct.core_number(c))
    if name in ("louvain", "leiden"):
        got, q = getattr(alg, name)(g)
        lab, cq = getattr(ct, name)(c)
        assert q == cq
        return got, vframe(partition=lab)
    if name == "triangle_count":
        return alg.triangle_count(g), vframe(counts=ct.triangle_count(c))
    if name in ("jaccard", "sorensen", "overlap"):
        v1, v2, cf = getattr(ct, name)(c, use_weight=True)
        got = getattr(alg, name)(g, use_weight=True)
        return got, pd.DataFrame({"first": ext(v1), "second": ext(v2),
                                  f"{name}_coeff": cf.numpy()})
    if name == "uniform_neighbor_sample":
        starts = ["v0", "v5", "v33"]
        got = alg.uniform_neighbor_sample(g, starts, [3, 2])
        r = ct.uniform_neighbor_sample(c, g.to_internal(starts), [3, 2])
        return got, pd.DataFrame({"sources": ext(r["sources"]),
                                  "destinations": ext(r["destinations"]),
                                  "hop_id": r["hop"].numpy(), "indices": r["weights"].numpy()})
    if name in ("random_walks", "node2vec"):
        starts = ["v0", "v7"]
        got = getattr(alg, name)(g, starts, 6)
        want = getattr(ct, name)(c, g.to_internal(starts), 6)
        return (pd.DataFrame({"walks": list(got[0]), "weights": list(got[1])}),
                pd.DataFrame({"walks": list(want[0].numpy()), "weights": list(want[1].numpy())}))
    if name in ("k_core", "ego_graph"):
        if name == "k_core":
            got = alg.k_core(g, 4)
            sub, vmap = ct.k_core(c, 4, degree_type="outgoing")
        else:
            got = alg.ego_graph(g, "v0", radius=2)
            sub, vmap = ct.ego_graph(c, int(g.to_internal(["v0"])[0]), 2)
        s, d, w = ct.core.decompress_to_edgelist(sub)
        e = np.asarray(ext(vmap))
        want = pd.DataFrame({"src": e[s.numpy()], "dst": e[d.numpy()], "weight": w.numpy()})
        return _undirected(got.edges()), _undirected(want)
    if name == "force_atlas2":
        pos = ct.force_atlas2(c, max_iter=20).numpy()
        return alg.force_atlas2(g, max_iter=20), pd.DataFrame(
            {"vertex": vid, "x": pos[:, 0], "y": pos[:, 1]})
    if name == "minimum_spanning_tree":
        s, d, w = ct.minimum_spanning_tree(c)
        return alg.minimum_spanning_tree(g), pd.DataFrame(
            {"src": ext(s), "dst": ext(d), "weight": w.numpy()})
    raise KeyError(name)


def _undirected(df):
    """Each edge once as (smaller id, larger id, weight), sorted."""
    a, b = df["src"].to_numpy(), df["dst"].to_numpy()
    out = pd.DataFrame({"lo": np.minimum(a, b), "hi": np.maximum(a, b),
                        "weight": df["weight"].to_numpy()})
    return out.drop_duplicates().sort_values(["lo", "hi"], ignore_index=True)


WRAPPERS = [
    "pagerank", "hits", "katz_centrality", "eigenvector_centrality", "betweenness_centrality",
    "degree_centrality", "bfs", "sssp", "connected_components", "strongly_connected_components",
    "core_number", "louvain", "leiden", "triangle_count", "jaccard", "sorensen", "overlap",
    "uniform_neighbor_sample", "random_walks", "node2vec", "k_core", "ego_graph",
    "force_atlas2", "minimum_spanning_tree",
]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_equals_core_call(name, named_pair):
    got, want = _core(name, named_pair[0])
    pd.testing.assert_frame_equal(got.reset_index(drop=True), want.reset_index(drop=True),
                                  check_dtype=False, check_exact=True)


# wrappers whose result does not depend on a draw, against the JAX API:
# (tolerance of the value column, or None for equal)
JAX_PARITY = {
    "pagerank": TOL_SCORE_REL, "hits": TOL_SCORE_REL, "katz_centrality": TOL_SCORE_REL,
    "eigenvector_centrality": TOL_SCORE_REL, "betweenness_centrality": TOL_SCORE_REL,
    "degree_centrality": None, "bfs": None, "sssp": TOL_SCORE_REL,
    "connected_components": None, "strongly_connected_components": None, "core_number": None,
    "triangle_count": None, "overlap": TOL_COEFF_ABS, "sorensen": TOL_COEFF_ABS,
    "minimum_spanning_tree": None,
}


@pytest.mark.parametrize("name", list(JAX_PARITY))
def test_wrapper_matches_jax_api(name, named_pair):
    g, jg = named_pair
    if name in ("bfs", "sssp"):
        got, want = getattr(alg, name)(g, "v0"), getattr(jalg, name)(jg, "v0")
    elif name in ("overlap", "sorensen"):
        got = getattr(alg, name)(g, use_weight=True)
        want = getattr(jalg, name)(jg, use_weight=True)
    elif name == "betweenness_centrality":  # all sources: no draw
        got, want = alg.betweenness_centrality(g), jalg.betweenness_centrality(jg)
    else:
        got, want = getattr(alg, name)(g), getattr(jalg, name)(jg)
    assert list(got.columns) == list(want.columns)
    tol = JAX_PARITY[name]
    for col in got.columns:
        a, b = got[col].to_numpy(), want[col].to_numpy()
        if tol is None or a.dtype.kind not in "f":
            np.testing.assert_array_equal(a, b)
        elif tol == TOL_COEFF_ABS:
            np.testing.assert_allclose(a, b, atol=tol, rtol=0)
        else:
            _assert_rel(a, b, tol)


def test_walk_wrappers_structure(named_pair):
    g, _ = named_pair
    e = g.edges()
    edges = set(zip(g.to_internal(e["src"]), g.to_internal(e["dst"])))
    edges |= {(d, s) for s, d in edges}
    for fn in (alg.random_walks, alg.node2vec):
        walks, ws = fn(g, ["v0", "v7"], 6)
        assert walks.shape == (2, 7) and ws.shape == (2, 6)
        np.testing.assert_array_equal(walks[:, 0], g.to_internal(["v0", "v7"]))
        for row in walks:  # karate has no sink: every step is an edge
            assert all((int(a), int(b)) in edges for a, b in zip(row[:-1], row[1:]))


def test_api_device_and_doctests():
    g = api.Graph(device=CPU)
    assert g.device == torch.device(CPU) and api.DiGraph(device=CPU).is_directed()
    for mod in (api_graph, alg):
        assert doctest.testmod(mod, raise_on_error=True).failed == 0


def test_experimental_datasets_and_compat_nx():
    from cugraph_tpu.experimental import compat_nx as jnx
    from cugraph_tpu.experimental import karate as jkarate

    from cugraph_tpu_torch.experimental import compat_nx, karate

    g = karate.get_graph(device=CPU)
    assert g is karate.get_graph(device=CPU)  # built once a device
    assert g.core.device == torch.device(CPU)
    pd.testing.assert_frame_equal(g.edges(), jkarate.get_graph().edges(), check_dtype=False)
    G = nx.karate_club_graph()
    assert compat_nx.triangles(G, device=CPU) == jnx.triangles(G)
    assert compat_nx.number_connected_components(G, device=CPU) == 1
    assert compat_nx.number_connected_components(g) == jnx.number_connected_components(G)
    assert compat_nx.shortest_path_length(g, 0) == jnx.shortest_path_length(
        jkarate.get_graph(), 0)
