"""Multi-GPU layer: the 2D edge partition over torch.distributed.

Counterpart of ``cugraph_tpu/dist/``. One process per card (NCCL between
cards, gloo on the CPU); each rank holds its share of the graph and of
every vertex array, and runs the port's kernels on its local blocks.
"""

from .partition import Partition2D
from .mesh import Mesh2D, initialize_distributed, make_global_mesh, make_mesh, mesh_shape_for
from .mg_graph import MGGraph, distribute_graph, distribute_edgelist
from . import mg_prims, mg_algos, mg_sampling, mg_gnn, mg_community, mg_similarity, mg_centrality
