"""cugraph_tpu_torch.service against cugraph_tpu.service, test by test of
tests/test_service.py, on the same CSV.

Each handler result is held to the JAX handler's: graph info, extension
counts, ego graphs and WCC labels equal; PageRank, SSSP and Katz within
``SCORE_ATOL``; BFS distances equal. The samplers draw from different
generators by design (torch's against JAX's), so their results are held
to what both must satisfy: at most fanout edges a start, each an edge of
the graph, walks of max_depth + 1 vertices. Over HTTP a port
server answers the JAX package's client and a JAX server the port's
client. The MG tests run the handler on every rank of a spawned gloo
group, (2, 1) and (1, 2), each rank making the same calls; no process
group is started in the pytest process.
"""

import numpy as np
import pandas as pd
import pytest

import _torch_dist_worker as worker
from cugraph_tpu import service as jax_service
from cugraph_tpu.testing import karate_edgelist
from cugraph_tpu_torch.service import (
    CugraphHandler,
    CugraphServiceError,
    CugraphTpuClient,
    CugraphTpuServer,
)

SCORE_ATOL = 1e-6


@pytest.fixture()
def edge_csv(tmp_path):
    src, dst, w = karate_edgelist()
    path = tmp_path / "edges.csv"
    pd.DataFrame({"src": src, "dst": dst, "weight": w}).to_csv(path, index=False)
    return str(path)


def _edge_set(csv):
    df = pd.read_csv(csv)
    return set(zip(df["src"], df["dst"])) | set(zip(df["dst"], df["src"]))


def _handlers(edge_csv):
    h, j = CugraphHandler(device="cpu"), jax_service.CugraphHandler()
    for x in (h, j):
        x.load_csv_as_edge_data(edge_csv, vertex_col_names=["src", "dst"])
    return h, j


def test_handler_lifecycle(edge_csv):
    h, j = CugraphHandler(device="cpu"), jax_service.CugraphHandler()
    info = h.get_server_info()
    assert set(info) == set(j.get_server_info())
    assert info["device_platform"] == "cpu" and info["num_devices"] == 1
    assert h.uptime() >= 0
    for x in (h, j):
        gid = x.create_graph()
        assert gid in x.get_graph_ids()
        x.load_csv_as_edge_data(edge_csv, vertex_col_names=["src", "dst"], graph_id=gid)
    assert h.get_graph_info(gid) == j.get_graph_info(gid)
    assert h.get_graph_info(gid)["num_edges"] == len(pd.read_csv(edge_csv))
    assert h.get_graph_edge_data(gid) == j.get_graph_edge_data(gid)
    h.delete_graph(gid)
    assert gid not in h.get_graph_ids()
    with pytest.raises(CugraphServiceError):
        h.get_graph_info(gid)


def test_handler_algorithms(edge_csv):
    h, j = _handlers(edge_csv)
    res, want = h.pagerank(tol=1e-8), j.pagerank(tol=1e-8)
    assert res["vertex"] == want["vertex"]
    np.testing.assert_allclose(res["pagerank"], want["pagerank"], rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(sum(res["pagerank"]), 1.0, rtol=1e-4)
    edges = _edge_set(edge_csv)
    for x in (h, j):
        samp = x.uniform_neighbor_sample([1, 2], [2])
        assert 0 < len(samp["sources"]) <= 4
        assert all(e in edges for e in zip(samp["sources"], samp["destinations"]))
        walks = x.node2vec([1], 3)  # internal ids, in both packages
        assert len(walks["vertex_paths"]) == 4 and walks["path_sizes"] == [4]
    egos, want = h.batched_ego_graphs([1, 2], radius=1), j.batched_ego_graphs([1, 2], radius=1)
    assert egos["seed_offsets"] == want["seed_offsets"] and len(egos["seed_offsets"]) == 3
    for k in range(2):
        lo, hi = egos["seed_offsets"][k:k + 2]
        assert sorted(zip(egos["srcs"][lo:hi], egos["dsts"][lo:hi])) == sorted(
            zip(want["srcs"][lo:hi], want["dsts"][lo:hi]))
    for call in (lambda x: x.bfs(0), lambda x: x.wcc()):
        assert call(h) == call(j)
    res, want = h.sssp(0), j.sssp(0)
    assert res["vertex"] == want["vertex"]
    np.testing.assert_array_equal(res["distance"], want["distance"])
    res, want = h.katz_centrality(alpha=0.05, tol=1e-8), j.katz_centrality(alpha=0.05, tol=1e-8)
    np.testing.assert_allclose(res["katz_centrality"], want["katz_centrality"], atol=SCORE_ATOL)


def test_handler_extensions(tmp_path, edge_csv):
    ext = tmp_path / "ext.py"
    ext.write_text(
        "import pandas as pd\n"
        "def create_ring_graph(n):\n"
        "    return pd.DataFrame({'src': list(range(n)),"
        " 'dst': [(i+1)%n for i in range(n)]})\n"
    )
    h, j = CugraphHandler(device="cpu"), jax_service.CugraphHandler()
    assert h.load_graph_creation_extensions(str(tmp_path)) == 1
    assert j.load_graph_creation_extensions(str(tmp_path)) == 1
    gid = h.call_graph_creation_extension("create_ring_graph", 5)
    assert gid == j.call_graph_creation_extension("create_ring_graph", 5)
    assert h.get_graph_info(gid) == j.get_graph_info(gid)
    assert h.get_graph_info(gid)["num_edges"] == 5
    assert h.pagerank(gid, tol=1e-8)["vertex"] == j.pagerank(gid, tol=1e-8)["vertex"]
    h.unload_graph_creation_extensions()
    with pytest.raises(CugraphServiceError):
        h.call_graph_creation_extension("create_ring_graph", 5)


@pytest.mark.parametrize("server_side, client_side", [("port", "port"), ("port", "jax"),
                                                      ("jax", "port")])
def test_e2e_http(edge_csv, server_side, client_side):
    """A client of either package against a server of either, on
    localhost: the wire format is one."""
    server = (CugraphTpuServer(port=0, device="cpu") if server_side == "port"
              else jax_service.CugraphTpuServer(port=0))
    server.start()
    try:
        cls = CugraphTpuClient if client_side == "port" else jax_service.CugraphTpuClient
        client = cls(port=server.port)
        assert client.uptime() >= 0
        client.load_csv_as_edge_data(edge_csv, vertex_col_names=["src", "dst"])
        assert client.get_graph_info(0)["num_edges"] == len(pd.read_csv(edge_csv))
        res = client.pagerank(0, tol=1e-6)
        np.testing.assert_allclose(sum(res["pagerank"]), 1.0, rtol=1e-4)
        ref = jax_service.CugraphHandler()
        ref.load_csv_as_edge_data(edge_csv, vertex_col_names=["src", "dst"])
        want = ref.pagerank(tol=1e-6)
        assert res["vertex"] == want["vertex"]
        np.testing.assert_allclose(res["pagerank"], want["pagerank"], atol=SCORE_ATOL)
        assert client.call("bfs", 0) == ref.bfs(0)
        with pytest.raises(Exception, match="invalid graph id"):
            client.get_graph_info(12345)
        with pytest.raises(Exception, match="forbidden"):
            client.call("_pg", 0)
    finally:
        server.stop()


def _mg_runs(edge_csv, shape):
    return worker.spawn(worker.run_service, shape[0] * shape[1], shape, edge_csv)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_handler_mg_backed_graph(edge_csv, shape):
    """PageRank and BFS on a mesh-backed graph route to mg_pagerank and
    mg_bfs on every rank and match the single-device handler, the port's
    and the JAX package's."""
    want = jax_service.CugraphHandler()
    want.load_csv_as_edge_data(edge_csv, vertex_col_names=["src", "dst"])
    j_pr, j_bfs = want.pagerank(tol=1e-8), want.bfs(0)
    for r in _mg_runs(edge_csv, shape):
        assert r["info"] == {"mesh_shape": list(shape), "num_devices": 2}
        assert r["bad_shape_raised"] and not r["own_group"]
        sg, mg = r["sg"], r["mg"]
        assert mg["pagerank"]["vertex"] == sg["pagerank"]["vertex"] == j_pr["vertex"]
        np.testing.assert_allclose(mg["pagerank"]["pagerank"], sg["pagerank"]["pagerank"],
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(mg["pagerank"]["pagerank"], j_pr["pagerank"], atol=SCORE_ATOL)
        assert mg["bfs"]["vertex"] == sg["bfs"]["vertex"] == j_bfs["vertex"]
        assert mg["bfs"]["distance"] == sg["bfs"]["distance"] == j_bfs["distance"]
        assert mg["bfs"]["predecessor"] == sg["bfs"]["predecessor"]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_handler_mg_routing(edge_csv, shape):
    """SSSP, WCC and Katz route to mg_sssp, mg_wcc and
    mg_katz_centrality and match the single-device handler; the sampler
    routes to mg_uniform_neighbor_sample: the same on every rank, each
    edge an edge of the CSV, and the single-device contract (the same
    keys, hop 0 first with min(fanout, out-degree) edges a start)."""
    df = pd.read_csv(edge_csv)
    edges = set(zip(df["src"], df["dst"]))
    out_deg = df["src"].value_counts().to_dict()
    starts, fanout = [0, 5, 33], 4
    hop0 = sum(min(fanout, out_deg.get(s, 0)) for s in starts)
    runs = _mg_runs(edge_csv, shape)
    for r in runs:
        sg, mg = r["sg"], r["mg"]
        assert mg["sssp"]["vertex"] == sg["sssp"]["vertex"]
        np.testing.assert_array_equal(mg["sssp"]["distance"], sg["sssp"]["distance"])
        assert mg["wcc"] == sg["wcc"]
        np.testing.assert_allclose(mg["katz"]["katz_centrality"], sg["katz"]["katz_centrality"],
                                   atol=SCORE_ATOL)
        assert r["sample"] == runs[0]["sample"]
        for sample in (r["sample"], r["sg_sample"]):
            assert set(sample) == {"sources", "destinations", "indices"}
            assert len(sample["sources"]) == len(sample["destinations"]) > hop0
            for s, d in zip(sample["sources"], sample["destinations"]):
                assert (s, d) in edges
            first = sample["sources"][:hop0]
            assert sorted(first) == sorted(s for s in starts
                                           for _ in range(min(fanout, out_deg.get(s, 0))))


def test_handler_starts_and_ends_its_own_group(edge_csv):
    """With no group up, distribute_graph starts a one-rank gloo group on
    localhost (the handler is on the CPU), and the server's stop ends it."""
    (r,) = worker.spawn(worker.run_service_own_group, 1, edge_csv)
    assert r["info"] == {"mesh_shape": [1, 1], "num_devices": 1}
    assert (r["backend"], r["world"], r["own_group"]) == ("gloo", 1, True)
    np.testing.assert_allclose(r["mg"]["pagerank"], r["sg"]["pagerank"], atol=SCORE_ATOL)
    assert not r["up_after_stop"]
