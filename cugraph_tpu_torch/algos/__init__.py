from .centrality import (
    betweenness_centrality,
    degree_centrality,
    edge_betweenness_centrality,
    eigenvector_centrality,
    katz_centrality,
)
from .link_analysis import hits, pagerank
from .traversal import bfs, extract_bfs_paths, sssp, two_hop_neighbors
