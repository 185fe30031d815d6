"""Single-source shortest paths from a root each, as GAP's SSSP kernel
runs them on a weighted graph.

Nominal edges, as Graph500's SSSP and the BFS queries count them: the
generated tuples inside the root's connected component, loops and repeats
counted. Compulsory bytes, what any implementation reads and writes once,
however many rounds it takes: the reached vertices' minors and weights (4
bytes each a stored edge) and offsets (4 bytes a vertex), and the
distances and predecessors (V x 4 each) written once.
"""

from __future__ import annotations


def run(port, graph, root, params: dict):
    """(result, note): (distances, predecessors), and no note."""
    return port.sssp(graph, root, **params), None


def nominal_edges(facts, roots, params: dict) -> list:
    return facts.per_root(facts.comp_tuples, roots)


def compulsory_bytes(facts, roots, params: dict) -> list:
    edges = facts.per_root(facts.comp_edges, roots)
    verts = facts.per_root(facts.comp_vertices, roots)
    return [8 * e + 4 * n + 8 * facts.num_vertices for e, n in zip(edges, verts)]
