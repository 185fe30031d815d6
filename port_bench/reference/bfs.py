"""Breadth-first search by hand, and the comparison that judges the port's
distances and predecessors as Graph500 validates a BFS tree.

Each vertex's distance must equal the reference's hop count (INT32_MAX
where unreached); the root and unreached vertices have predecessor -1;
every other reached vertex's predecessor p must be a stored neighbour with
distance one less. The reading is the count of vertices that break one of
these rules, over every sampled query: the limit is 0.
"""

from __future__ import annotations

import torch

from .graph import RefGraph

UNREACHED = 2**31 - 1


def search(ref: RefGraph, root: int, id_dtype=None):
    """(dist, pred) int32 from ``root``, level by level over the frontier's
    stored out-edges; pred the smallest frontier neighbour. With
    ``id_dtype`` (the control) each predecessor id passes through that
    dtype."""
    v, dev = ref.num_vertices, ref.keys.device
    dist = torch.full((v,), UNREACHED, dtype=torch.int32, device=dev)
    pred = torch.full((v,), -1, dtype=torch.int32, device=dev)
    dist[root] = 0
    frontier = torch.tensor([root], dtype=torch.int64, device=dev)
    level = 0
    while frontier.numel():
        starts = ref.offsets[frontier]
        degs = ref.offsets[frontier + 1] - starts
        total = int(degs.sum())
        owner = torch.repeat_interleave(
            torch.arange(frontier.numel(), device=dev), degs, output_size=total)
        pos = torch.arange(total, device=dev) + (starts - torch.cumsum(degs, 0) + degs)[owner]
        nbr = ref.dst[pos].long()
        parent = frontier[owner]
        del owner, pos
        fresh = dist[nbr] == UNREACHED
        nbr, parent = nbr[fresh], parent[fresh]
        best = torch.full((v,), v, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, nbr, parent, "amin")
        frontier = torch.unique(nbr)
        level += 1
        found = best[frontier]
        if id_dtype is not None:
            found = found.to(id_dtype).to(torch.int64)
        dist[frontier] = level
        pred[frontier] = found.to(torch.int32)
    return dist, pred


def invalid(ref: RefGraph, root: int, dist: torch.Tensor, pred: torch.Tensor,
            want: torch.Tensor) -> int:
    """Vertices whose distance differs from ``want`` or whose predecessor
    breaks the rules above."""
    v = ref.num_vertices
    bad = dist.ne(want)
    inner = want.ne(UNREACHED)
    inner[root] = False
    bad |= ~inner & pred.ne(-1)
    p = pred.long()
    ok = (p >= 0) & (p < v)
    ids = torch.nonzero(inner & ok).squeeze(1)
    pi = p[ids]
    good = (want[pi] == want[ids] - 1) & ref.has_edges(pi, ids)
    bad[ids[~good]] = True
    bad |= inner & ~ok
    return int(bad.sum())


def check(ref: RefGraph, samples, notes, params: dict, limits: dict) -> dict:
    """{name: (reading, limit)}."""
    del notes
    count = 0
    for root, (dist, pred) in samples:
        want, _ = search(ref, root)
        count += invalid(ref, root, dist, pred, want)
    return {"bfs_invalid": (count, limits["bfs_invalid"])}


def control(ref: RefGraph, args, params: dict):
    """The control in the program's place: each search with its
    predecessor ids carried in bfloat16, the step below the float32 ids of
    the port's dense levels."""
    return [(search(ref, root, id_dtype=torch.bfloat16), None) for root in args]
