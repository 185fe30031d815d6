"""The GNN stores of cugraph_tpu_torch against cugraph_tpu's.

The asserts of the JAX package's store tests (tests/test_gnn.py) run on
the port (``device="cpu"``), and both packages' stores are filled from
one karate frame and held against each other: features and edge lookups
exactly, take-all samples (fanout -1) as sets of edges. An MG-backed
store (``dist.MGPropertyGraph`` on a 2 x 1 gloo mesh, in the ranks of
``_torch_dist_worker.run_mg_store``) is fed the JAX store's uniforms and
gives its frame exactly.
"""

import functools

import numpy as np
import pandas as pd
import pytest
import torch

import cugraph_tpu.gnn as jgnn
import cugraph_tpu_torch.gnn as ctgnn
from cugraph_tpu.testing import karate_edgelist
from cugraph_tpu_torch.gnn import (
    EdgeAttr,
    EdgeLayout,
    FeatureStorage,
    GraphStore,
    PyGStore,
    TensorAttr,
    to_pyg,
)


def _karate_frames():
    src, dst, w = karate_edgelist()
    v_ids = np.arange(34)
    edges = pd.DataFrame({"src": src, "dst": dst, "w": w})
    nodes = pd.DataFrame({"id": v_ids, "f0": v_ids * 1.0, "f1": v_ids * 2.0})
    return edges, nodes


def _stores(edge_type="", node_type=""):
    """(port store, JAX store) over the same frames."""
    edges, nodes = _karate_frames()
    stores = GraphStore(device="cpu"), jgnn.GraphStore()
    for s in stores:
        s.add_edge_data(edges, ("src", "dst"), edge_type=edge_type)
        s.add_node_data(nodes, "id", node_type=node_type)
    return stores


# ------------------------------------------------------ the JAX asserts


def test_graph_store():
    src, _, _ = karate_edgelist()
    store, _ = _stores()
    assert store.num_edges == len(src)
    samp = store.sample_neighbors([0, 1], fanout=3)
    assert len(samp) <= 6
    feats = store.get_node_storage(["f0", "f1"], "").fetch([5, 7])
    assert isinstance(feats, torch.Tensor) and feats.device.type == "cpu"
    np.testing.assert_allclose(feats.numpy(), [[5.0, 10.0], [7.0, 14.0]])
    sub, vmap = store.egonet(0, k=1)
    assert len(vmap) >= 2


def test_graph_store_dgl_surface():
    src, dst, w = karate_edgelist()
    store, _ = _stores(edge_type="knows", node_type="person")
    assert store.ntypes == ["person"] and store.etypes == ["knows"]
    assert not store.has_multiple_etypes
    assert store.num_nodes("person") == 34
    assert store.num_edges_dict == {"knows": len(src)}
    assert len(store.get_vertex_ids()) == 34
    s_, d_ = store.find_edges([0, 2], etype="knows")
    assert s_.tolist() == [src[0], src[2]] and d_.tolist() == [dst[0], dst[2]]
    ef = store.get_edge_storage(["w"], "knows").fetch([1, 3])
    np.testing.assert_allclose(ef.numpy()[:, 0], [w[1], w[3]], rtol=1e-6)


def test_graph_store_edge_dir_sampling():
    store = GraphStore(device="cpu")
    store.add_edge_data(pd.DataFrame({"src": [0, 1, 2, 3], "dst": [9, 9, 9, 0]}), ["src", "dst"])
    res_in = store.sample_neighbors([9], fanout=-1, edge_dir="in")
    assert set(res_in["sources"]) == {0, 1, 2}
    assert set(res_in["destinations"]) == {9}
    res_out = store.sample_neighbors([3], fanout=-1, edge_dir="out")
    assert set(res_out["sources"]) == {3}
    assert set(res_out["destinations"]) == {0}
    assert store.is_mg is False
    assert store.gdata is store.pg


def test_pyg_store_protocol():
    store = PyGStore(device="cpu")
    src = np.array([0, 1, 2, 3, 0])
    dst = np.array([1, 2, 3, 0, 2])
    assert store.put_edge_index((src, dst), EdgeAttr(edge_type="knows"))
    attrs = store.get_all_edge_attrs()
    assert attrs[0].edge_type == "knows" and attrs[0].layout == EdgeLayout.COO
    r, c = store.get_edge_index(EdgeAttr(edge_type="knows"))
    assert set(zip(r, c)) == set(zip(src, dst))

    feats = np.arange(8, dtype=np.float32).reshape(4, 2)
    store.put_tensor(feats, TensorAttr(group_name="", attr_name="x"))
    got = store.get_tensor(TensorAttr(group_name="", attr_name="x", index=[2, 0]))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), feats[[2, 0]])
    names = {a.attr_name for a in store.get_all_tensor_attrs()}
    assert "x" in names

    row, col, nodes, hop = store.neighbor_sample([0], [2], replace=False)
    assert len(row) == len(col) == len(hop)
    assert row.max() < len(nodes) and col.max() < len(nodes)

    fs, gs = to_pyg(store.pg, device="cpu")
    assert fs is gs


def test_feature_storage_backends():
    store = GraphStore(device="cpu")
    store.add_node_data(
        pd.DataFrame({"v": [0, 1, 2], "f0": [1.0, 2.0, 3.0], "f1": [4.0, 5.0, 6.0]}), "v")
    t = store.get_node_storage(["f0", "f1"], backend_lib="torch").fetch([2, 0])
    assert isinstance(t, torch.Tensor)
    np.testing.assert_allclose(t.numpy(), [[3.0, 6.0], [1.0, 4.0]])
    fs_n = store.get_node_storage(["f0"], backend_lib="numpy")
    assert isinstance(fs_n.fetch([1]), np.ndarray)
    # the port delivers torch or numpy; a JAX array is not one of them
    for bad in ("jax", "tf"):
        with pytest.raises(ValueError, match="backend_lib"):
            store.get_node_storage(["f0"], backend_lib=bad)
        with pytest.raises(ValueError, match="backend_lib"):
            PyGStore(backend_lib=bad, device="cpu")


def test_mg_store_branch_raises():
    """An MG-backed store samples on its mesh and never on one device: a
    fanout of -1, which the mesh sampler does not take, raises GraphError
    (the JAX package's rule) before any graph is built."""
    from cugraph_tpu_torch.utils.error import GraphError

    store, _ = _stores()

    class _MG:
        def is_mg(self):
            return True

    store.pg = _MG()
    with pytest.raises(GraphError, match="fanout > 0"):
        store.sample_neighbors([0], fanout=-1)


# ------------------------------------------------------- MG-backed stores

MG_SHAPE = (2, 1)
MG_KEY = 13


@functools.lru_cache(maxsize=None)
def _mg_frame():
    rng = np.random.default_rng(3)
    return pd.DataFrame({"src": rng.integers(0, 40, 300), "dst": rng.integers(0, 40, 300)})


def _jax_mg_uniforms(n_seeds, fanouts, n_dev, key):
    """The uniforms JAX's mg_uniform_neighbor_sample draws from ``key``."""
    import jax

    rng_key = jax.random.PRNGKey(key)
    sizes = [max(-(-n_seeds // n_dev) * n_dev, n_dev)]
    for k in fanouts:
        sizes.append(sizes[-1] * k)
    us = []
    for h, k in enumerate(fanouts):
        rng_key, sub = jax.random.split(rng_key)
        us.append(np.asarray(jax.random.uniform(sub, (sizes[h], k))))
    return us


MG_SEEDS = [0, 1, 7, 39]


@functools.lru_cache(maxsize=None)
def _mg_store_runs():
    import _torch_dist_worker as worker

    us = _jax_mg_uniforms(len(MG_SEEDS), [3, 3], MG_SHAPE[0] * MG_SHAPE[1], MG_KEY)
    return worker.spawn(worker.run_mg_store, MG_SHAPE[0] * MG_SHAPE[1], MG_SHAPE, _mg_frame(),
                        MG_SEEDS, {"in": us, "out": us})


@pytest.mark.parametrize("edge_dir", ["in", "out"])
def test_mg_store_sample_neighbors_matches_jax(edge_dir):
    """An MG-backed store (2 x 1 gloo mesh) fed the JAX uniforms gives the
    JAX store's frame on a mesh of the same shape, in each direction."""
    import jax

    from cugraph_tpu.dist.mesh import make_mesh as jax_make_mesh
    from cugraph_tpu.dist.mg_property_graph import MGPropertyGraph as JaxMGPropertyGraph

    pg = JaxMGPropertyGraph(jax_make_mesh(MG_SHAPE))
    pg.add_edge_data(_mg_frame(), ("src", "dst"))
    want = jgnn.GraphStore(property_graph=pg).sample_neighbors(
        MG_SEEDS, fanout=3, num_hops=2, edge_dir=edge_dir, rng_key=jax.random.PRNGKey(MG_KEY))
    assert len(want) > 0
    for r in _mg_store_runs():
        assert r["is_mg"]
        got = r[edge_dir + "_uniforms"]
        for k in ("sources", "destinations", "hop"):
            np.testing.assert_array_equal(got[k], want[k].to_numpy(), err_msg=k)
        assert r[edge_dir + "_edge_data"] == len(_mg_frame())


@pytest.mark.parametrize("edge_dir", ["in", "out"])
def test_mg_store_generator_sample_is_edges(edge_dir):
    """From a generator: every sampled (source, destination) an edge of
    the frame, hop 0 leaving (out) or entering (in) the seeds, at most
    fanout a seed; the same frame on every rank."""
    edges = set(zip(_mg_frame()["src"].tolist(), _mg_frame()["dst"].tolist()))
    runs = _mg_store_runs()
    got = runs[0][edge_dir]
    for other in runs[1:]:
        for k in got:
            np.testing.assert_array_equal(other[edge_dir][k], got[k])
    assert len(got["sources"]) > 0
    for s, d in zip(got["sources"], got["destinations"]):
        assert (int(s), int(d)) in edges
    hop0 = got["hop"] == 0
    ends = got["sources" if edge_dir == "out" else "destinations"][hop0]
    assert set(ends.tolist()) <= set(MG_SEEDS)
    for s in MG_SEEDS:
        assert (ends == s).sum() <= 3
    assert "fanout > 0" in runs[0]["fanout_-1"]


# -------------------------------------------------- parity with the JAX stores


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("storage", ["node", "edge"])
def test_fetch_matches_jax(backend, storage):
    port, jax_store = _stores(edge_type="knows", node_type="person")
    ids = [7, 0, 33, 5] if storage == "node" else [3, 77, 0, 12]
    if storage == "node":
        got = port.get_node_storage(["f1", "f0"], "person", backend_lib=backend).fetch(ids)
        want = jax_store.get_node_storage(["f1", "f0"], "person").fetch(ids)
    else:
        got = port.get_edge_storage(["w"], "knows", backend_lib=backend).fetch(ids)
        want = jax_store.get_edge_storage(["w"], "knows").fetch(ids)
    got = got.numpy() if backend == "torch" else got
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_vector_property_fetch_matches_jax():
    from cugraph_tpu.api.property_graph import PropertyGraph as JaxPropertyGraph
    from cugraph_tpu_torch.api import PropertyGraph

    df = pd.DataFrame({"v": [0, 1, 2], "x0": [1.0, 2.0, 3.0], "x1": [4.0, 5.0, 6.0]})
    got_want = []
    for pg_cls, fs_cls, kw in ((PropertyGraph, FeatureStorage, {"device": "cpu"}),
                               (JaxPropertyGraph, jgnn.FeatureStorage, {})):
        pg = pg_cls()
        pg.add_vertex_data(df, "v", vector_properties={"emb": ["x0", "x1"]})
        got_want.append(np.asarray(fs_cls(pg, ["emb"], "", **kw).fetch([2, 0])))
    np.testing.assert_array_equal(*got_want)


def test_find_edges_and_counts_match_jax():
    port, jax_store = _stores(edge_type="knows", node_type="person")
    ids = np.array([0, 5, 77, 40])
    for a, b in zip(port.find_edges(ids, etype="knows"), jax_store.find_edges(ids, etype="knows")):
        np.testing.assert_array_equal(a, b)
    for attr in ("num_vertices", "num_edges", "ntypes", "etypes", "num_nodes_dict",
                 "num_edges_dict"):
        assert getattr(port, attr) == getattr(jax_store, attr)
    np.testing.assert_array_equal(np.sort(port.get_vertex_ids()),
                                  np.sort(jax_store.get_vertex_ids()))


def _edge_set(frame):
    return set(zip(frame["sources"].tolist(), frame["destinations"].tolist(),
                   frame["hop"].tolist()))


@pytest.mark.parametrize("edge_dir", ["in", "out"])
@pytest.mark.parametrize("num_hops", [1, 2])
def test_take_all_sample_neighbors_matches_jax(edge_dir, num_hops):
    port, jax_store = _stores()
    nodes = [0, 33, 5]
    got = port.sample_neighbors(nodes, fanout=-1, num_hops=num_hops, edge_dir=edge_dir)
    want = jax_store.sample_neighbors(nodes, fanout=-1, num_hops=num_hops, edge_dir=edge_dir)
    assert len(got) == len(want) > 0
    assert _edge_set(got) == _edge_set(want)


def _pyg_pair():
    src, dst, _ = karate_edgelist()
    feats = np.random.default_rng(4).random((34, 3)).astype(np.float32)
    stores = PyGStore(device="cpu"), jgnn.PyGStore()
    for s, pkg in zip(stores, (ctgnn, jgnn)):
        s.put_edge_index((src, dst), pkg.EdgeAttr(edge_type="knows"))
        s.put_tensor(feats, pkg.TensorAttr(group_name="", attr_name="x"))
    return stores


def test_pyg_get_edge_index_and_tensor_match_jax():
    port, jax_store = _pyg_pair()
    for a, b in zip(port.get_edge_index(EdgeAttr(edge_type="knows")),
                    jax_store.get_edge_index(jgnn.EdgeAttr(edge_type="knows"))):
        np.testing.assert_array_equal(a, b)
    got, want = port.get_all_edge_attrs(), jax_store.get_all_edge_attrs()
    assert [(a.edge_type, a.layout.value, a.size) for a in got] == [
        (a.edge_type, a.layout.value, a.size) for a in want]
    for index in ([9, 3, 30], None):
        got = port.get_tensor(TensorAttr(group_name="", attr_name="x", index=index))
        want = jax_store.get_tensor(jgnn.TensorAttr(group_name="", attr_name="x", index=index))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = port.multi_get_tensor([TensorAttr(group_name="", attr_name="x", index=[1])])
    assert len(got) == 1 and got[0].shape == (1, 3)
    assert port.remove_tensor(TensorAttr(group_name="", attr_name="x"))
    with pytest.raises(KeyError):
        port.get_tensor(TensorAttr(group_name="", attr_name="x"))


@pytest.mark.parametrize("fanouts", [[-1], [-1, -1]])
def test_take_all_neighbor_sample_matches_jax(fanouts):
    port, jax_store = _pyg_pair()
    seeds = [0, 33, 12]
    row, col, nodes, hop = port.neighbor_sample(seeds, fanouts)
    jrow, jcol, jnodes, jhop = jax_store.neighbor_sample(seeds, fanouts)
    np.testing.assert_array_equal(nodes, jnodes)
    got = set(zip(nodes[row.numpy()].tolist(), nodes[col.numpy()].tolist(), hop.tolist()))
    want = set(zip(jnodes[jrow].tolist(), jnodes[jcol].tolist(), np.asarray(jhop).tolist()))
    assert len(row) == len(jrow) and got == want
    # local ids index the node set (sorted by internal id), every seed in it
    assert len(set(nodes.tolist())) == len(nodes) and set(seeds) <= set(nodes.tolist())
