"""cugraph_tpu_torch: the PyTorch and CUDA port of cugraph_tpu for one
NVIDIA H100 (Hopper, sm_90a).

It keeps the JAX package's module names so that each counterpart is easy
to find. The layers, from the entry points down:

- ``core``       graph containers: renumbering, symmetrization, CSR/CSC
  built on the device, decompress, transpose, relabel, induced subgraph
  and coarsening.
- ``generators`` R-MAT edge lists from a ``torch.Generator``, per-rank
  R-MAT shards for the multi-GPU ingest, and the simple generators (path,
  complete, meshes, Erdős–Rényi).
- ``algos``      PageRank, HITS, Katz, eigenvector, degree and betweenness
  centrality, BFS, SSSP, path extraction, two-hop neighbors; weakly and
  strongly connected components, core number and k-core; modularity,
  Louvain, Leiden, ECG, triangle count, k-truss, ego graph, spectral
  clustering and the clustering metrics; the link-prediction
  coefficients (Jaccard, Sorensen, overlap, cosine); minimum and maximum
  spanning trees and the Hungarian assignment (scipy on the host, as in
  the JAX package); the Force Atlas 2 layout.
- ``sampling``   uniform neighbor sampling, random walks and node2vec.
- ``gnn``        GraphSAGE/GCN aggregation and models (``nn.Module``).
- ``prims``      the generic per-vertex reduce, the frontier push, the
  dense SpMM, the vertex and whole-edge reductions, the keyed (by-cluster)
  aggregation, the neighbor intersections and the random edge selection;
  ``prims.cuda`` holds the hand-written CUDA kernels (``csrc/``):
  ``spmv_sum``, ``spmv_minplus``, ``spmm_rows``, and ``cumsum_flat`` and
  ``assemble_chunks``, which are entry points of their own.
- ``api``        the user-facing layer (imported on its own): ``Graph``,
  ``DiGraph`` and ``MultiGraph`` with pandas frames in and out and
  external ids of any dtype (``core.renumber.NumberMap``), the dataframe
  algorithm wrappers, networkx interop and ``PropertyGraph``; beside it
  ``experimental`` (datasets, an nx-style namespace) and ``testing``
  (the small datasets).
- ``core.serialize`` the JAX package's npz wire format for a graph;
  ``utils.validation`` (the expensive checks).
- ``utils.timer`` the port's tracing: ``span``, which marks calls,
  iterations, levels, blocking reads, kernel launches and set-up phases
  (``cgt/...``) as events of a running ``torch.profiler``'s trace and is a
  shared no-op without one; ``setup_spans``, the set-up phases of this
  process (this import, kernel loads and builds, ingest), kept with their
  host and device times whether a profiler ran or not; and
  ``profiler_trace``, which writes a Chrome trace of a block, spans and
  kernels together.
- ``dist``       the multi-GPU layer on ``torch.distributed`` (imported on
  its own): the 2D edge partition, one process per card, MG PageRank,
  BFS, GNN aggregation and the GraphSAGE forward.

Every entry point takes ``device=None``, which means the CUDA card, and
raises ``RuntimeError`` when there is none; pass ``device="cpu"`` to run
the kernels' plain versions on the CPU. Algorithms run on the graph's
device.
"""

import time as _time

_import_start = _time.perf_counter()

from . import prims, utils  # noqa: E402
from .algos import (  # noqa: E402
    all_pairs_similarity,
    analyze_clustering_edge_cut,
    analyze_clustering_modularity,
    analyze_clustering_ratio_cut,
    betweenness_centrality,
    bfs,
    core_number,
    cosine,
    degree_centrality,
    ecg,
    edge_betweenness_centrality,
    ego_graph,
    eigenvector_centrality,
    extract_bfs_paths,
    force_atlas2,
    hits,
    hungarian,
    jaccard,
    k_core,
    katz_centrality,
    ktruss,
    leiden,
    louvain,
    maximum_spanning_tree,
    minimum_spanning_tree,
    modularity,
    overlap,
    pagerank,
    spectral_balanced_cut_clustering,
    spectral_modularity_maximization_clustering,
    sorensen,
    sssp,
    strongly_connected_components,
    triangle_count,
    weakly_connected_components,
)
from .core import (  # noqa: E402
    CompressedAdj,
    Graph,
    apply_renumber_map,
    compute_renumber_map,
    from_edgelist,
)
from .core import renumber  # noqa: E402
from .generators import (  # noqa: E402
    mg_rmat_edgelist,
    rmat_chunk_source,
    rmat_edgelist,
    scramble_vertex_ids,
)
from .generators import simple as simple_generators  # noqa: E402
from .sampling import node2vec, random_walks, uniform_neighbor_sample  # noqa: E402
from .utils import timer as _timer  # noqa: E402

__version__ = "0.1.0"

_timer.record_setup_span("cgt/setup.import", _import_start, _time.perf_counter())
del _time, _timer, _import_start
