"""PageRank queries: GAP's PR kernel, a fixed count of iterations with the
tolerance stop off, so that every query does the same work.

Nominal edges: the stored (symmetrized, coalesced) edges once an
iteration. Compulsory bytes of one iteration's SpMV: the minors (4 bytes an
edge), the offsets ((V + 1) x 4), the vector read (V x 4) and the result
written (V x 4), whatever implements it.
"""

from __future__ import annotations


def run(port, graph, arg, params: dict):
    """(result, note): the scores, and the iteration count the port ran."""
    del arg
    scores, iterations = port.pagerank(graph, **params)
    return scores, iterations


def run_mg(port, mesh, graph, arg, params: dict):
    """(result, note) on a cell across cards: this rank's range of the
    scores, and the iteration count."""
    del arg
    return port.dist.mg_algos.mg_pagerank(mesh, graph, **params)


def nominal_edges(facts, args, params: dict) -> list:
    return [facts.stored_edges * params["max_iterations"] for _ in args]


def compulsory_bytes(facts, args, params: dict) -> list:
    v, e = facts.num_vertices, facts.stored_edges
    sweep = 4 * e + 4 * (v + 1) + 4 * v + 4 * v
    return [sweep * params["max_iterations"] for _ in args]
