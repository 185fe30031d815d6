"""Rules of the cugraph_tpu_torch package.

- It, chip_smoke.py and the rank bodies of the multi-process tests
  (tests/_torch_dist_worker.py) import nothing of jax, flax or
  cugraph_tpu.
- device=None means CUDA: without CUDA every entry point raises
  RuntimeError instead of running on the CPU.
- CPU tensors take the kernels' plain versions: no launch is counted,
  in one process or in the ranks of a gloo group, for every kernel and
  every entry point (the community, components and cores algorithms
  included).
"""

import ast
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
import cugraph_tpu_torch as ct
from cugraph_tpu_torch import api, experimental, gnn, microbench, service
from cugraph_tpu_torch.examples import community_detection, train_graphsage
from cugraph_tpu_torch.core.renumber import NumberMap
from cugraph_tpu_torch.core.serialize import deserialize_graph, load_graph
from cugraph_tpu_torch import dist as ctd
from cugraph_tpu_torch.algos import traversal
from cugraph_tpu_torch.gnn import GCN, GraphSAGE
from cugraph_tpu_torch.prims.cuda import (
    assemble_chunks,
    bfs_pull_level,
    cumsum_flat,
    gather_rows,
    gather_window_sum,
    multiwin_reduce,
    pull_aggregate,
    push_aggregate,
    seg_scan_rows,
    segment_sums_from_cumsum,
    spmm_rows,
    spmv_minplus,
    spmv_sum,
    stream_scale,
)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "cugraph_tpu")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((ROOT / "cugraph_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "time_brandes.py", ROOT / "time_spmv.py",
        ROOT / "tests" / "_torch_dist_worker.py"]
    assert len(files) > 15
    for mod in ("dist/mg_algos.py", "algos/community.py", "algos/components.py",
                "algos/cores.py", "prims/keyed.py", "prims/intersection.py",
                "prims/cuda/scan.py", "prims/cuda/assemble.py", "core/coarsen.py",
                "algos/link_prediction.py", "prims/random_select.py", "generators/simple.py",
                "generators/rmat.py", "sampling/uniform_neighbor_sample.py",
                "sampling/random_walks.py", "utils/validation.py", "utils/timer.py",
                "core/renumber.py", "core/serialize.py", "algos/tree.py",
                "algos/linear_assignment.py", "algos/layout.py", "api/graph.py",
                "api/algorithms.py", "api/nx_compat.py", "api/property_graph.py",
                "api/__init__.py", "testing/datasets.py", "experimental/datasets.py",
                "experimental/compat_nx.py", "gnn/loader.py", "gnn/graph_store.py",
                "gnn/pyg_store.py", "dist/mg_gnn.py", "dist/mg_community.py",
                "service/server.py", "service/client.py", "examples/train_graphsage.py",
                "examples/community_detection.py", "dist/mg_sampling.py",
                "dist/mg_similarity.py", "dist/mg_centrality.py",
                "dist/mg_property_graph.py", "prims/cuda/probes.py", "microbench.py"):
        assert ROOT / "cugraph_tpu_torch" / mod in files
    bad = [
        (str(f.relative_to(ROOT)), mod)
        for f in files
        for mod in _imported_roots(f)
        if mod in FORBIDDEN
    ]
    assert bad == []


def _karate_nx():
    import networkx as nx

    return nx.karate_club_graph()


def _edge_frame():
    import pandas as pd

    return pd.DataFrame({"source": ["a", "b"], "destination": ["b", "c"]})


ENTRY_POINTS = {
    "from_edgelist": lambda: ct.from_edgelist([0, 1], [1, 0]),
    "rmat_edgelist": lambda: ct.rmat_edgelist(4, 16),
    "compute_renumber_map": lambda: ct.compute_renumber_map([0, 1], [1, 0]),
    "apply_renumber_map": lambda: ct.apply_renumber_map([1, 0], [0, 1]),
    "coalesce_edgelist": lambda: ct.core.coalesce_edgelist([0, 1], [1, 0]),
    "symmetrize_edgelist": lambda: ct.core.symmetrize_edgelist([0, 1], [1, 0]),
    "GraphSAGE": lambda: GraphSAGE(8),
    "GCN": lambda: GCN(8),
    "initialize_distributed": lambda: ctd.initialize_distributed(),
    "make_mesh": lambda: ctd.make_mesh(),
    "make_global_mesh": lambda: ctd.make_global_mesh(),
    "init_sage_params": lambda: ctd.mg_gnn.init_sage_params(torch.Generator(), 4, 4, 2),
    "sage_params_from_jax": lambda: ctd.mg_gnn.sage_params_from_jax(
        {k: np.zeros((2, 2)) for k in ctd.mg_gnn.SAGE_PARAMS}),
    "path_graph_edgelist": lambda: ct.simple_generators.path_graph_edgelist(4),
    "complete_graph_edgelist": lambda: ct.simple_generators.complete_graph_edgelist(4),
    "mesh_2d_edgelist": lambda: ct.simple_generators.mesh_2d_edgelist(2, 2),
    "mesh_3d_edgelist": lambda: ct.simple_generators.mesh_3d_edgelist(2, 2, 2),
    "erdos_renyi_gnp_edgelist": lambda: ct.simple_generators.erdos_renyi_gnp_edgelist(8, 0.5),
    "api.Graph.from_pandas_edgelist": lambda: api.Graph().from_pandas_edgelist(_edge_frame()),
    "api.DiGraph": lambda: api.DiGraph(),
    "api.MultiGraph": lambda: api.MultiGraph(),
    "NumberMap.renumber": lambda: NumberMap.renumber(_edge_frame(), "source", "destination"),
    "deserialize_graph": lambda: deserialize_graph(b"never read"),
    "load_graph": lambda: load_graph("never-opened.npz"),
    "Dataset.get_graph": lambda: experimental.karate.get_graph(),
    "api.algorithms.pagerank(nx)": lambda: api.algorithms.pagerank(_karate_nx()),
    "api.from_networkx": lambda: api.from_networkx(_karate_nx()),
    "PropertyGraph.extract_subgraph": lambda: _property_graph().extract_subgraph(),
    # a mesh whose ranks sit on cards
    "mg_rmat_edgelist": lambda: ct.mg_rmat_edgelist(_CARD_MESH, 4, 16),
    "GraphStore": lambda: gnn.GraphStore(),
    "FeatureStorage": lambda: gnn.FeatureStorage(api.PropertyGraph(), ["f"], ""),
    "PyGStore": lambda: gnn.PyGStore(),
    "to_pyg": lambda: gnn.to_pyg(api.PropertyGraph()),
    # a graph on the card
    "NeighborLoader": lambda: gnn.NeighborLoader(_CARD_GRAPH, [0], [2]),
    "LinkNeighborLoader": lambda: gnn.LinkNeighborLoader(_CARD_GRAPH, [[0, 1]], [2]),
    "make_sage_train_step": lambda: ctd.mg_gnn.make_sage_train_step(_CARD_MESH, _mg_graph()),
    "mg_sssp": lambda: ctd.mg_algos.mg_sssp(_CARD_MESH, _mg_graph(), 0),
    "mg_katz_centrality": lambda: ctd.mg_algos.mg_katz_centrality(_CARD_MESH, _mg_graph(), 0.1),
    "mg_eigenvector_centrality": lambda: ctd.mg_algos.mg_eigenvector_centrality(
        _CARD_MESH, _mg_graph()),
    "mg_hits": lambda: ctd.mg_algos.mg_hits(_CARD_MESH, _mg_graph()),
    "mg_wcc": lambda: ctd.mg_algos.mg_wcc(_CARD_MESH, _mg_graph()),
    "mg_core_number": lambda: ctd.mg_algos.mg_core_number(_CARD_MESH, _mg_graph()),
    "mg_extract_bfs_paths": lambda: ctd.mg_algos.mg_extract_bfs_paths(
        _CARD_MESH, _mg_graph(), None, None, [0]),
    "mg_modularity": lambda: ctd.mg_community.mg_modularity(_CARD_MESH, _mg_graph(), [0] * 4),
    "mg_louvain": lambda: ctd.mg_community.mg_louvain(_CARD_MESH, _mg_graph()),
    "mg_leiden": lambda: ctd.mg_community.mg_leiden(_CARD_MESH, _mg_graph()),
    "mg_uniform_neighbor_sample": lambda: ctd.mg_sampling.mg_uniform_neighbor_sample(
        _CARD_MESH, _mg_graph(), [0], [2]),
    "mg_random_walks": lambda: ctd.mg_sampling.mg_random_walks(_CARD_MESH, _mg_graph(), [0], 2),
    "mg_jaccard": lambda: ctd.mg_similarity.mg_jaccard(_CARD_MESH, _mg_graph(), ([0], [1])),
    "mg_sorensen": lambda: ctd.mg_similarity.mg_sorensen(_CARD_MESH, _mg_graph(), ([0], [1])),
    "mg_overlap": lambda: ctd.mg_similarity.mg_overlap(_CARD_MESH, _mg_graph(), ([0], [1])),
    "mg_triangle_count": lambda: ctd.mg_similarity.mg_triangle_count(_CARD_MESH, _mg_graph()),
    "mg_betweenness_centrality": lambda: ctd.mg_centrality.mg_betweenness_centrality(
        _CARD_MESH, _CARD_GRAPH),
    "mg_edge_betweenness_centrality": lambda: ctd.mg_centrality.mg_edge_betweenness_centrality(
        _CARD_MESH, _CARD_GRAPH),
    "MGPropertyGraph.extract_subgraph": lambda: _mg_property_graph().extract_subgraph(),
    "CugraphHandler": lambda: service.CugraphHandler(),
    "CugraphTpuServer": lambda: service.CugraphTpuServer(port=0),
    "examples.train_graphsage": lambda: train_graphsage.main(["--scale", "4", "--steps", "1"]),
    "examples.community_detection": lambda: community_detection.main([]),
    "microbench.main": lambda: microbench.main([]),
    "microbench.run": lambda: microbench.run(),
    "microbench.probe_inputs": lambda: microbench.probe_inputs(["x"]),
}
_CARD_MESH = types.SimpleNamespace(shape=(1, 1), rows=1, cols=1, i=0, j=0,
                                   device=torch.device("cuda"))
_CARD_GRAPH = types.SimpleNamespace(device=torch.device("cuda"))


def _mg_graph():
    """A 1 x 1 share of a 4-vertex graph; only its shape is read before
    the mesh's device is."""
    from cugraph_tpu_torch.dist.partition import Partition2D

    part = Partition2D.create(1, 1, 4)
    return types.SimpleNamespace(partition=part, vp=part.vp, num_vertices=4, rows=1, cols=1,
                                 weighted=False, is_symmetric=True)


def _property_graph():
    pg = api.PropertyGraph()
    pg.add_edge_data(_edge_frame(), ("source", "destination"))
    return pg


def _mg_property_graph():
    import pandas as pd

    from cugraph_tpu_torch.dist.mg_property_graph import MGPropertyGraph

    pg = MGPropertyGraph(_CARD_MESH)
    pg.add_edge_data(pd.DataFrame({"s": [0, 1], "d": [1, 2]}), ("s", "d"))
    return pg


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_default_device_without_cuda_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()


def test_cpu_tensors_launch_no_kernel(monkeypatch):
    counters = (spmv_sum, spmv_minplus, spmm_rows, cumsum_flat, assemble_chunks, stream_scale,
                gather_rows, gather_window_sum, multiwin_reduce, seg_scan_rows, bfs_pull_level)
    before = [fn.launches for fn in counters]
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    g = ct.from_edgelist(src, dst, num_vertices=50, device="cpu")
    gw = ct.from_edgelist(src, dst, rng.random(300), num_vertices=50, device="cpu")
    x = torch.from_numpy(rng.random(50).astype(np.float32))
    spmv_sum(g.csc(), x)
    pull_aggregate(g, x)
    push_aggregate(g, x)
    spmv_minplus(g.csc(), x)
    spmm_rows(g.csc(), x[:, None].repeat(1, 8), precision="bf16")
    ct.pagerank(g, max_iterations=3)
    ct.bfs(g, 0)
    ct.hits(gw, max_iterations=3)
    ct.katz_centrality(gw, max_iterations=3)
    ct.eigenvector_centrality(gw, max_iterations=3)
    ct.betweenness_centrality(g, k=4)
    ct.edge_betweenness_centrality(g, k=4)
    ct.degree_centrality(g)
    ct.sssp(gw, 0)
    monkeypatch.setattr(traversal, "SSSP_SWEEP_MIN_EDGES", 0)  # the sweep branch
    dist, pred = ct.sssp(gw, 0)
    ct.extract_bfs_paths(gw, dist, pred, [int(torch.isfinite(dist).nonzero()[-1])])
    traversal.two_hop_neighbors(g)
    segment_sums_from_cumsum(cumsum_flat(torch.ones(g.num_edges)), g.csc().offsets, 50)
    assemble_chunks(x[:48].view(12, 4), torch.tensor([2, 0]), torch.tensor([1, 0]), 2, 6)
    monkeypatch.setattr(microbench, "N_TILES", 8)
    monkeypatch.setattr(microbench, "REPS", 1)
    microbench.main(["--device", "cpu", "--rows", "512", "--table-rows", "64"])
    table = x[:48].view(12, 4).repeat(1, 8)
    stream_scale(table, 2.0)
    gather_rows(table.to(torch.bfloat16), torch.tensor([3, 0, 11]))
    ids = torch.ones(4, 2, dtype=torch.int32)
    gather_window_sum(table, ids, ids)
    multiwin_reduce(torch.tensor([0]), x[:8, None].repeat(1, 128), torch.zeros(8, 128).long(), 2)
    seg_scan_rows(table, (table > 0.5).float())
    gs = ct.from_edgelist(src, dst, num_vertices=50, symmetrize=True, device="cpu")
    ct.weakly_connected_components(g)
    ct.strongly_connected_components(g)
    ct.k_core(gs, 2, ct.core_number(gs))
    labels, _ = ct.louvain(gs)
    ct.leiden(gs)
    ct.analyze_clustering_edge_cut(gs, labels)
    ct.analyze_clustering_ratio_cut(gs, labels)
    ct.triangle_count(gs)
    ct.ktruss(gs, 3)
    ct.ecg(gs, ensemble_size=2)
    ct.ego_graph(gs, 0, 2)
    ct.spectral_balanced_cut_clustering(gs, 2)
    ct.spectral_modularity_maximization_clustering(gs, 2)
    gsw = ct.from_edgelist(src, dst, rng.random(300), num_vertices=50, symmetrize=True,
                           device="cpu")
    for kind in (ct.jaccard, ct.sorensen, ct.overlap, ct.cosine):
        kind(gs)
        kind(gsw, use_weight=True)
    ct.all_pairs_similarity(gs, topk=5)
    ct.minimum_spanning_tree(gsw)
    ct.maximum_spanning_tree(gsw)
    ct.hungarian(gw, [0, 1, 2])
    ct.force_atlas2(gs, max_iter=3)
    ga = api.Graph(device="cpu").from_numpy_edgelist(src, dst)
    api.algorithms.pagerank(ga)
    api.algorithms.bfs(ga, int(src[0]))
    api.algorithms.sssp(ga, int(src[0]))
    ct.uniform_neighbor_sample(gw, [0, 1, 2], [3, -1])
    ct.random_walks(gw, [0, 1], 4)
    ct.random_walks(gw, [0, 1], 4, biased=True)
    ct.node2vec(gw, [0, 1], 4, p=0.5, q=2.0)
    shards = ct.mg_rmat_edgelist(types.SimpleNamespace(shape=(2, 1), device=torch.device("cpu")),
                                 5, 64)
    assert [s_.shape for s_, _ in ct.rmat_chunk_source(shards)()] == [(32,), (32,)]
    assert [fn.launches for fn in counters] == before == [0] * len(counters)


def test_cpu_trainer_step_launches_no_kernel():
    """One minibatch step on the CPU (loader -> block -> GraphSAGE ->
    cross-entropy -> backward -> Adam) above the dense branch: the sparse
    aggregation and its backward take the plain version."""
    counters = (spmv_sum, spmv_minplus, spmm_rows, cumsum_flat, assemble_chunks)
    before = [fn.launches for fn in counters]
    rng = np.random.default_rng(1)
    v = 9000  # above DENSE_MAX_VERTICES, so the blocks' graphs are not dense
    src, dst = rng.integers(0, v, 60000), rng.integers(0, v, 60000)
    g = ct.from_edgelist(src, dst, num_vertices=v, device="cpu")
    feats = torch.from_numpy(rng.normal(size=(v, 8)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, v))
    model = GraphSAGE(8, 8, 3, device="cpu")
    opt = torch.optim.Adam(model.parameters())
    block = next(iter(gnn.NeighborLoader(g, np.arange(v), [-1, -1], batch_size=1500)))
    assert block.graph.num_vertices > 8192
    ids = block.n_ids.long()
    out = model(block.graph, feats[ids])
    loss = torch.nn.functional.cross_entropy(out[: block.num_seeds], labels[ids][: block.num_seeds])
    loss.backward()
    opt.step()
    assert model.convs[0].lin_nbr.weight.grad.abs().max() > 0
    assert [fn.launches for fn in counters] == before == [0] * len(counters)


def test_cpu_ranks_launch_no_kernel():
    """The MG entry points in two gloo ranks on the CPU, mesh (2, 1)."""
    for r in worker.spawn(worker.run_launch_counts, 2):
        assert r["shape"] == (2, 1)
        assert r["before"] == r["after"] == [0, 0, 0]


def _exported_names(path):
    """Names bound at the top level of a package's __init__.py: imports,
    assignments and definitions."""
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return names


def _public_functions(path):
    """The public functions a module defines at its top level."""
    return {node.name for node in ast.parse(path.read_text(), filename=str(path)).body
            if isinstance(node, ast.FunctionDef) and not node.name.startswith("_")}


@pytest.mark.parametrize("package, port", [("__init__.py", ct), ("api/__init__.py", api),
                                           ("gnn/__init__.py", gnn),
                                           ("service/__init__.py", service),
                                           ("dist/mg_community.py", ctd.mg_community)])
def test_every_jax_export_exists_in_the_port(package, port):
    if package.endswith("__init__.py"):
        names = _exported_names(ROOT / "cugraph_tpu" / package)
    else:  # a module: the functions it defines
        names = _public_functions(ROOT / "cugraph_tpu" / package)
    assert len(names) > 3
    if port is ct:
        assert "__version__" in names and ct.__version__
    missing = sorted(n for n in names if not hasattr(port, n))
    assert missing == []


def _public_names(path):
    """The public functions and classes a module defines at its top level."""
    return {node.name for node in ast.parse(path.read_text(), filename=str(path)).body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_")}


@pytest.mark.parametrize("module", ["mg_sampling", "mg_similarity", "mg_centrality",
                                    "mg_property_graph"])
def test_every_public_name_of_the_mg_modules_exists(module):
    """Each public function and class of the JAX ``dist/`` module, in the
    port's module of the same name; and ``mg_prims.dcsr_lookup``."""
    import importlib

    names = _public_names(ROOT / "cugraph_tpu" / "dist" / f"{module}.py")
    assert names
    port = importlib.import_module(f"cugraph_tpu_torch.dist.{module}")
    assert sorted(n for n in names if not hasattr(port, n)) == []
    assert callable(ctd.mg_prims.dcsr_lookup)
    assert hasattr(ctd, module) or module == "mg_property_graph"  # as dist/__init__ imports them
