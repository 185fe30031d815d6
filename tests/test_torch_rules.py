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
from cugraph_tpu_torch import dist as ctd
from cugraph_tpu_torch.algos import traversal
from cugraph_tpu_torch.gnn import GCN, GraphSAGE
from cugraph_tpu_torch.prims.cuda import (
    assemble_chunks,
    cumsum_flat,
    pull_aggregate,
    push_aggregate,
    segment_sums_from_cumsum,
    spmm_rows,
    spmv_minplus,
    spmv_sum,
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
        ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_dist_worker.py"]
    assert len(files) > 15
    for mod in ("dist/mg_algos.py", "algos/community.py", "algos/components.py",
                "algos/cores.py", "prims/keyed.py", "prims/intersection.py",
                "prims/cuda/scan.py", "prims/cuda/assemble.py", "core/coarsen.py",
                "algos/link_prediction.py", "prims/random_select.py", "generators/simple.py",
                "generators/rmat.py", "sampling/uniform_neighbor_sample.py",
                "sampling/random_walks.py"):
        assert ROOT / "cugraph_tpu_torch" / mod in files
    bad = [
        (str(f.relative_to(ROOT)), mod)
        for f in files
        for mod in _imported_roots(f)
        if mod in FORBIDDEN
    ]
    assert bad == []


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
    # a mesh whose ranks sit on cards
    "mg_rmat_edgelist": lambda: ct.mg_rmat_edgelist(
        types.SimpleNamespace(shape=(1, 1), device=torch.device("cuda")), 4, 16),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_default_device_without_cuda_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()


def test_cpu_tensors_launch_no_kernel(monkeypatch):
    counters = (spmv_sum, spmv_minplus, spmm_rows, cumsum_flat, assemble_chunks)
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
    ct.uniform_neighbor_sample(gw, [0, 1, 2], [3, -1])
    ct.random_walks(gw, [0, 1], 4)
    ct.random_walks(gw, [0, 1], 4, biased=True)
    ct.node2vec(gw, [0, 1], 4, p=0.5, q=2.0)
    shards = ct.mg_rmat_edgelist(types.SimpleNamespace(shape=(2, 1), device=torch.device("cpu")),
                                 5, 64)
    assert [s_.shape for s_, _ in ct.rmat_chunk_source(shards)()] == [(32,), (32,)]
    assert [fn.launches for fn in counters] == before == [0] * len(counters)


def test_cpu_ranks_launch_no_kernel():
    """The MG entry points in two gloo ranks on the CPU, mesh (2, 1)."""
    for r in worker.spawn(worker.run_launch_counts, 2):
        assert r["shape"] == (2, 1)
        assert r["before"] == r["after"] == [0, 0, 0]
