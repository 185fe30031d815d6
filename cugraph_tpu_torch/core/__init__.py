from .coarsen import coarsen_graph
from .convert import decompress_to_edgelist, induced_subgraph, relabel, transpose
from .csr import CompressedAdj, Graph, from_edgelist
from .renumber import apply_renumber_map, compute_renumber_map
from .symmetrize import coalesce_edgelist, symmetrize_edgelist
