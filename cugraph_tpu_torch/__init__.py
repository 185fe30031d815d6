"""cugraph_tpu_torch: the PyTorch and CUDA port of cugraph_tpu for one
NVIDIA H100 (Hopper, sm_90a).

It keeps the JAX package's module names so that each counterpart is easy
to find. The layers, from the entry points down:

- ``core``       graph containers: renumbering, symmetrization, CSR/CSC
  built on the device, decompress, transpose, relabel, induced subgraph
  and coarsening.
- ``generators`` R-MAT edge lists from a ``torch.Generator``.
- ``algos``      PageRank, HITS, Katz, eigenvector, degree and betweenness
  centrality, BFS, SSSP, path extraction, two-hop neighbors; weakly and
  strongly connected components, core number and k-core; modularity,
  Louvain, Leiden, ECG, triangle count, k-truss, ego graph, spectral
  clustering and the clustering metrics.
- ``gnn``        GraphSAGE/GCN aggregation and models (``nn.Module``).
- ``prims``      the generic per-vertex reduce, the frontier push, the
  dense SpMM, the vertex and whole-edge reductions, the keyed (by-cluster)
  aggregation and the neighbor intersections;
  ``prims.cuda`` holds the hand-written CUDA kernels (``csrc/``):
  ``spmv_sum``, ``spmv_minplus``, ``spmm_rows``, and ``cumsum_flat`` and
  ``assemble_chunks``, which are entry points of their own.
- ``dist``       the multi-GPU layer on ``torch.distributed`` (imported on
  its own): the 2D edge partition, one process per card, MG PageRank,
  BFS, GNN aggregation and the GraphSAGE forward.

Every entry point takes ``device=None``, which means the CUDA card, and
raises ``RuntimeError`` when there is none; pass ``device="cpu"`` to run
the kernels' plain versions on the CPU. Algorithms run on the graph's
device.
"""

from . import utils
from .algos import (
    analyze_clustering_edge_cut,
    analyze_clustering_modularity,
    analyze_clustering_ratio_cut,
    betweenness_centrality,
    bfs,
    core_number,
    degree_centrality,
    ecg,
    edge_betweenness_centrality,
    ego_graph,
    eigenvector_centrality,
    extract_bfs_paths,
    hits,
    k_core,
    katz_centrality,
    ktruss,
    leiden,
    louvain,
    modularity,
    pagerank,
    spectral_balanced_cut_clustering,
    spectral_modularity_maximization_clustering,
    sssp,
    strongly_connected_components,
    triangle_count,
    weakly_connected_components,
)
from .core import (
    CompressedAdj,
    Graph,
    apply_renumber_map,
    compute_renumber_map,
    from_edgelist,
)
from .generators import rmat_edgelist, scramble_vertex_ids
