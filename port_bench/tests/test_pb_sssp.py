"""SSSP's reference and counts on graphs small enough to check by hand: the
weighted reference graph (a pair's smallest weight, both directions), its
distances against a heap Dijkstra in plain Python, the rules of the
comparison, the nominal edges and compulsory bytes; and the refusal of a
weighted configuration across cards."""

import heapq
import json
import random

import pytest
import torch
from pb_helpers import SEED

import cugraph_tpu_torch as port
from port_bench import harness
from port_bench.queries import sssp as sssp_q
from port_bench.reference import graph as refgraph
from port_bench.reference import sssp as sssp_ref

# a repeated pair with two weights (0-1 by 9 and, reversed, by 4), a path,
# a self-loop, a vertex with only a loop, two vertices without a tuple
SRC = torch.tensor([0, 1, 1, 2, 3, 0, 5, 2], dtype=torch.int32)
DST = torch.tensor([1, 0, 2, 2, 4, 2, 5, 0], dtype=torch.int32)
W = torch.tensor([9, 4, 3, 7, 5, 8, 2, 10], dtype=torch.float32)
V = 8
INF = float("inf")


@pytest.fixture
def ref():
    return refgraph.build(SRC, DST, V, W)


def dijkstra(src, dst, w, v, root):
    """Distances from ``root`` by a binary heap over the undirected tuples,
    each (u, x, w) an edge both ways; repeats are parallel edges."""
    adj = [[] for _ in range(v)]
    for a, b, c in zip(src, dst, w):
        adj[a].append((b, c))
        adj[b].append((a, c))
    dist = [INF] * v
    dist[root] = 0
    heap = [(0, root)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for x, c in adj[u]:
            if d + c < dist[x]:
                dist[x] = d + c
                heapq.heappush(heap, (d + c, x))
    return dist


def test_weighted_reference_graph(ref):
    pairs = [(int(k) // V, int(k) % V) for k in ref.keys]
    assert pairs == [(0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1), (2, 2), (3, 4), (4, 3),
                     (5, 5)]
    # 0-1 keeps 4 of (9, 4); 0-2 keeps 8 of (8, 10); each weight both ways
    assert ref.weights.tolist() == [4, 8, 4, 3, 8, 3, 7, 5, 5, 2]
    g = port.from_edgelist(SRC, DST, W, num_vertices=V, symmetrize=True, device="cpu")
    assert refgraph.graph_mismatch(g, ref) == 0
    heavier = W.clone()
    heavier[2] = 6  # 1-2 and 2-1
    g2 = port.from_edgelist(SRC, DST, heavier, num_vertices=V, symmetrize=True, device="cpu")
    assert refgraph.graph_mismatch(g2, ref) == 2
    bare = port.from_edgelist(SRC, DST, num_vertices=V, symmetrize=True, device="cpu")
    assert refgraph.graph_mismatch(bare, ref) == 1
    assert refgraph.graph_mismatch(g, refgraph.build(SRC, DST, V)) == 1
    with pytest.raises(ValueError):
        refgraph.build(SRC, DST, V, W + 0.5)


def test_reference_sssp_by_hand(ref):
    want = [0, 4, 7, INF, INF, INF, INF, INF]
    assert sssp_ref.search(ref, 0).tolist() == want
    dist = torch.tensor(want, dtype=torch.float32)
    pred = torch.tensor([-1, 0, 1, -1, -1, -1, -1, -1], dtype=torch.int32)
    full = sssp_ref.search(ref, 0)
    assert sssp_ref.invalid(ref, 0, dist, pred, full) == 0
    off = dist.clone()
    off[2] += 1  # a distance off by one
    assert sssp_ref.invalid(ref, 0, off, pred, full) == 1
    detour = pred.clone()
    detour[2] = 0  # a neighbour, but 0 + 8 > 7
    assert sssp_ref.invalid(ref, 0, dist, detour, full) == 1
    stranger = pred.clone()
    stranger[1] = 2  # a neighbour on no shortest path to 1
    assert sssp_ref.invalid(ref, 0, dist, stranger, full) == 1
    rooted = pred.clone()
    rooted[0] = 1  # the root has none
    assert sssp_ref.invalid(ref, 0, dist, rooted, full) == 1
    far = pred.clone()
    far[4] = 3  # unreached vertices have none
    assert sssp_ref.invalid(ref, 0, dist, far, full) == 1
    assert sssp_ref.invalid(ref, 3, *port.sssp(
        port.from_edgelist(SRC, DST, W, num_vertices=V, symmetrize=True, device="cpu"), 3),
        sssp_ref.search(ref, 3)) == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_sssp_equals_dijkstra(seed):
    rng = random.Random(seed)
    v, m = 60, 150
    src = [rng.randrange(v) for _ in range(m)]
    dst = [rng.randrange(v) for _ in range(m)]
    w = [rng.randint(1, 255) for _ in range(m)]
    ref = refgraph.build(torch.tensor(src, dtype=torch.int32),
                         torch.tensor(dst, dtype=torch.int32), v,
                         torch.tensor(w, dtype=torch.float32))
    for root in range(0, v, 7):
        assert sssp_ref.search(ref, root).tolist() == dijkstra(src, dst, w, v, root)


def test_chunked_search_and_predecessors(monkeypatch):
    """Pieces of a few edges give the same distances, and the control's
    predecessors pass the rules on its own distances."""
    rng = random.Random(SEED)
    v, m = 200, 400
    src = torch.tensor([rng.randrange(v) for _ in range(m)], dtype=torch.int32)
    dst = torch.tensor([rng.randrange(v) for _ in range(m)], dtype=torch.int32)
    w = torch.tensor([rng.randint(1, 255) for _ in range(m)], dtype=torch.float32)
    ref = refgraph.build(src, dst, v, w)
    whole = sssp_ref.search(ref, 5)
    monkeypatch.setattr(sssp_ref, "CHUNK", 7)
    assert torch.equal(sssp_ref.search(ref, 5), whole)
    dist = sssp_ref.search(ref, 5, carry=torch.bfloat16).float()
    pred = sssp_ref.predecessors(ref, 5, dist, torch.bfloat16)
    assert sssp_ref.invalid(ref, 5, whole.float(), sssp_ref.predecessors(
        ref, 5, whole.float(), torch.float32), whole) == 0
    assert sssp_ref.invalid(ref, 5, dist, pred, whole) > 0  # bfloat16 rounds the far ones


def test_sssp_counts(ref):
    facts = refgraph.Facts(ref, SRC)
    roots = [1, 4, 5, 6]
    # components {0, 1, 2}: 6 tuples, 7 stored edges; {3, 4}: 1, 2; {5}: 1, 1; {6}: 0
    assert sssp_q.nominal_edges(facts, roots, {}) == [6, 1, 1, 0]
    assert sssp_q.compulsory_bytes(facts, roots, {}) == [
        8 * 7 + 4 * 3 + 8 * V, 8 * 2 + 4 * 2 + 8 * V, 8 + 4 + 8 * V, 4 + 8 * V]


def test_weighted_cell_across_cards_refused(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "kron10w-mg.sssp", "config": "gap-kron-s24w",
                              "traffic": "sssp", "chips": 4, "why": "a test cell"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="weighted configuration"):
        harness.run_rank(tiny_root, "kron10w-mg.sssp", SEED, 0.3, False, torch.device("cpu"),
                         0.0, log=lambda msg: None)
