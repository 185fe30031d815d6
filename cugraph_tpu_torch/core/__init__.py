from .csr import CompressedAdj, Graph, from_edgelist
from .renumber import apply_renumber_map, compute_renumber_map
