"""cugraph_tpu_torch: the PyTorch and CUDA port of cugraph_tpu for one
NVIDIA H100 (Hopper, sm_90a).

It keeps the JAX package's module names so that each counterpart is easy
to find. The layers, from the entry points down:

- ``core``       graph containers: renumbering, symmetrization, CSR/CSC
  built on the device, decompress and transpose.
- ``generators`` R-MAT edge lists from a ``torch.Generator``.
- ``algos``      PageRank, HITS, Katz, eigenvector, degree and betweenness
  centrality, BFS, SSSP, path extraction, two-hop neighbors.
- ``gnn``        GraphSAGE/GCN aggregation and models (``nn.Module``).
- ``prims``      the generic per-vertex reduce, the frontier push and the
  dense SpMM;
  ``prims.cuda`` holds the hand-written CUDA kernels (``csrc/``):
  ``spmv_sum``, ``spmv_minplus`` and ``spmm_rows``.
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
    betweenness_centrality,
    bfs,
    degree_centrality,
    edge_betweenness_centrality,
    eigenvector_centrality,
    extract_bfs_paths,
    hits,
    katz_centrality,
    pagerank,
    sssp,
)
from .core import (
    CompressedAdj,
    Graph,
    apply_renumber_map,
    compute_renumber_map,
    from_edgelist,
)
from .generators import rmat_edgelist, scramble_vertex_ids
