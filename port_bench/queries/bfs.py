"""BFS queries from a root each, as Graph500 and GAP search.

Nominal edges, Graph500's traversed edges: the generated tuples inside the
root's connected component, loops and repeats counted. Compulsory bytes:
the reached vertices' minors (4 bytes a stored edge) and offsets (4 bytes a
vertex) read once, and the distances and predecessors (V x 4 each) written
once.
"""

from __future__ import annotations


def run(port, graph, root, params: dict):
    """(result, note): (distances, predecessors), and no note."""
    return port.bfs(graph, root, **params), None


def nominal_edges(facts, roots, params: dict) -> list:
    return facts.per_root(facts.comp_tuples, roots)


def compulsory_bytes(facts, roots, params: dict) -> list:
    edges = facts.per_root(facts.comp_edges, roots)
    verts = facts.per_root(facts.comp_vertices, roots)
    return [4 * e + 4 * n + 8 * facts.num_vertices for e, n in zip(edges, verts)]
