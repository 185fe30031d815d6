from .centrality import (
    betweenness_centrality,
    degree_centrality,
    edge_betweenness_centrality,
    eigenvector_centrality,
    katz_centrality,
)
from .link_analysis import hits, pagerank
from .link_prediction import all_pairs_similarity, cosine, jaccard, overlap, sorensen
from .traversal import bfs, extract_bfs_paths, sssp, two_hop_neighbors
from .community import (
    analyze_clustering_edge_cut,
    analyze_clustering_modularity,
    analyze_clustering_ratio_cut,
    ecg,
    ego_graph,
    ktruss,
    leiden,
    louvain,
    modularity,
    spectral_balanced_cut_clustering,
    spectral_modularity_maximization_clustering,
    triangle_count,
)
from .components import strongly_connected_components, weakly_connected_components
from .cores import core_number, k_core
from .layout import force_atlas2
from .linear_assignment import hungarian
from .tree import maximum_spanning_tree, minimum_spanning_tree
