"""NetworkX drop-in namespace (ref: experimental/compat/nx).

Exposes nx-signature functions backed by the port:
    from cugraph_tpu_torch.experimental import compat_nx as nx
    nx.pagerank(G)    # G may be an nx.Graph or a cugraph_tpu_torch api.Graph
An nx graph is converted onto ``device`` (default: the card).
"""

from ..api.algorithms import (
    betweenness_centrality,
    bfs,
    connected_components,
    core_number,
    degree_centrality,
    eigenvector_centrality,
    hits,
    jaccard,
    k_core,
    katz_centrality,
    louvain,
    pagerank,
    sssp,
    strongly_connected_components,
    triangle_count,
)


def triangles(G, device=None):
    return triangle_count(G, device=device)


def shortest_path_length(G, source, device=None):
    df = sssp(G, source, device=device)
    return dict(zip(df["vertex"], df["distance"]))


def number_connected_components(G, device=None):
    labels = connected_components(G, device=device)
    vals = labels["labels"] if hasattr(labels, "columns") else labels.values()
    return len(set(vals))
