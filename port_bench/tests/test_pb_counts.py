"""The reference graph, its facts, and each analytic's nominal edges and
compulsory bytes on a graph small enough to count by hand."""

import pytest
import torch

import cugraph_tpu_torch as port
from port_bench.queries import bfs as bfs_q
from port_bench.queries import pagerank as pr_q
from port_bench.reference import bfs as bfs_ref
from port_bench.reference import graph as refgraph

# a reciprocal pair, a path, a self-loop, a repeated tuple, a vertex with
# only a loop, two vertices without a tuple
SRC = torch.tensor([0, 1, 1, 2, 3, 3, 5], dtype=torch.int32)
DST = torch.tensor([1, 0, 2, 2, 4, 4, 5], dtype=torch.int32)
V = 8


@pytest.fixture
def ref():
    return refgraph.build(SRC, DST, V)


def test_reference_graph(ref):
    pairs = [(int(k) // V, int(k) % V) for k in ref.keys]
    assert pairs == [(0, 1), (1, 0), (1, 2), (2, 1), (2, 2), (3, 4), (4, 3), (5, 5)]
    assert ref.offsets.tolist() == [0, 1, 3, 5, 6, 7, 8, 8, 8]
    g = port.from_edgelist(SRC, DST, num_vertices=V, symmetrize=True, device="cpu")
    assert refgraph.graph_mismatch(g, ref) == 0
    keep = torch.arange(SRC.numel()) != 2  # (1, 2) and its reciprocal go
    short = port.from_edgelist(SRC[keep], DST[keep], num_vertices=V, symmetrize=True,
                               device="cpu")
    assert refgraph.graph_mismatch(short, refgraph.build(SRC[keep], DST[keep], V)) == 0
    assert refgraph.graph_mismatch(short, ref) > 0
    assert refgraph.components(ref).tolist() == [0, 0, 0, 3, 3, 5, 6, 7]


def test_pagerank_counts(ref):
    facts = refgraph.Facts(ref, SRC)
    params = {"alpha": 0.85, "max_iterations": 20, "tol": 0.0}
    assert pr_q.nominal_edges(facts, [None, None], params) == [160, 160]
    sweep = 4 * 8 + 4 * 9 + 4 * 8 + 4 * 8
    assert pr_q.compulsory_bytes(facts, [None], params) == [20 * sweep]


def test_bfs_counts(ref):
    facts = refgraph.Facts(ref, SRC)
    roots = [1, 4, 5, 0]
    assert bfs_q.nominal_edges(facts, roots, {}) == [4, 2, 1, 4]
    assert bfs_q.compulsory_bytes(facts, roots, {}) == [
        4 * 5 + 4 * 3 + 8 * V, 4 * 2 + 4 * 2 + 8 * V, 4 + 4 + 8 * V, 4 * 5 + 4 * 3 + 8 * V]


def test_reference_bfs(ref):
    dist, pred = bfs_ref.search(ref, 0)
    m = bfs_ref.UNREACHED
    assert dist.tolist() == [0, 1, 2, m, m, m, m, m]
    assert pred.tolist() == [-1, 0, 1, -1, -1, -1, -1, -1]
    assert bfs_ref.invalid(ref, 0, dist, pred, dist) == 0
    bad = pred.clone()
    bad[2] = 0  # 0 is not a neighbour of 2
    assert bfs_ref.invalid(ref, 0, dist, bad, dist) == 1
    far = dist.clone()
    far[2] = 3
    assert bfs_ref.invalid(ref, 0, far, pred, dist) == 1
