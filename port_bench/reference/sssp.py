"""Single-source shortest paths by hand, and the comparison that judges the
port's distances and predecessors as Graph500 validates an SSSP tree.

Each vertex's distance must equal the reference's, computed exactly in
int64 over the stored graph's whole weights (+inf where unreached); the
root and unreached vertices have predecessor -1; every other reached
vertex's predecessor p must be a stored in-neighbour with dist[p] +
w(p, v) == dist[v]. The reading is the count of vertices that break one of
these rules, over every sampled query: the limit is 0 (whole weights of at
most 255 keep the port's float32 distances exact far beyond any path
here).
"""

from __future__ import annotations

import torch

from .graph import CHUNK, RefGraph

UNREACHED = 2**62  # the int64 search's +inf


def _out_edge_chunks(ref: RefGraph, frontier: torch.Tensor):
    """(parent, position) of the stored out-edges of ``frontier``, in
    pieces of about ``CHUNK`` edges (a vertex's edges stay in one piece)."""
    dev = frontier.device
    starts = ref.offsets[frontier]
    degs = ref.offsets[frontier + 1] - starts
    cum = torch.cumsum(degs, 0)
    total = int(cum[-1])
    pieces = max(total - 1, 0) // CHUNK + 1
    marks = torch.arange(1, pieces, dtype=torch.int64, device=dev) * CHUNK
    ends = torch.searchsorted(cum, marks, right=True).tolist() + [frontier.numel()]
    lo = 0
    for hi in ends:
        if hi <= lo:
            continue
        st, dg = starts[lo:hi], degs[lo:hi]
        n = int(dg.sum())
        owner = torch.repeat_interleave(torch.arange(hi - lo, device=dev), dg, output_size=n)
        pos = torch.arange(n, device=dev) + (st - torch.cumsum(dg, 0) + dg)[owner]
        yield frontier[lo:hi][owner], pos
        lo = hi


def search(ref: RefGraph, root: int, carry=None) -> torch.Tensor:
    """float64 distances from ``root`` (+inf where unreached): Bellman-Ford
    over the out-edges of the vertices that improved in the last round,
    each round's candidates min-reduced per vertex. Exact in int64; with
    ``carry`` (the control), in float32 with every distance rounded
    through that dtype."""
    v, dev = ref.num_vertices, ref.keys.device
    if carry is None:
        dist = torch.full((v,), UNREACHED, dtype=torch.int64, device=dev)
    else:
        dist = torch.full((v,), float("inf"), dtype=torch.float32, device=dev)
    dist[root] = 0
    frontier = torch.tensor([root], dtype=torch.int64, device=dev)
    while frontier.numel():
        best = torch.full_like(dist, UNREACHED if carry is None else float("inf"))
        for parent, pos in _out_edge_chunks(ref, frontier):
            w = ref.weights[pos]
            if carry is None:
                cand = dist[parent] + w.long()
            else:
                cand = (dist[parent] + w.float()).to(carry).float()
            best.scatter_reduce_(0, ref.dst[pos].long(), cand, "amin")
            del parent, pos, w, cand
        improved = best < dist
        dist = torch.where(improved, best, dist)
        frontier = torch.nonzero(improved).squeeze(1)
    if carry is None:
        return torch.where(dist == UNREACHED, float("inf"), dist.double())
    return dist.double()


def predecessors(ref: RefGraph, root: int, dist: torch.Tensor, carry) -> torch.Tensor:
    """int32 predecessors of float32 distances reached in ``carry``'s
    rounding: each reached vertex but the root takes its smallest stored
    in-neighbour p with round(dist[p] + w) == dist[v], -1 elsewhere."""
    v = ref.num_vertices
    pred = torch.full((v,), v, dtype=torch.int64, device=dist.device)
    for i in range(0, ref.num_edges, CHUNK):
        u, d = ref.src[i:i + CHUNK].long(), ref.dst[i:i + CHUNK].long()
        cand = (dist[u] + ref.weights[i:i + CHUNK].float()).to(carry).float()
        on = torch.isfinite(cand) & (cand == dist[d]) & (d != root)
        pred.scatter_reduce_(0, d[on], u[on], "amin")
    return torch.where(pred < v, pred, -1).to(torch.int32)


def invalid(ref: RefGraph, root: int, dist: torch.Tensor, pred: torch.Tensor,
            want: torch.Tensor) -> int:
    """Vertices whose distance differs from ``want`` (float64, +inf where
    unreached) or whose predecessor breaks the rules above."""
    v = ref.num_vertices
    bad = dist.double().ne(want)
    inner = torch.isfinite(want)
    inner[root] = False
    p = pred.long()
    bad |= ~inner & p.ne(-1)
    ok = (p >= 0) & (p < v)
    bad |= inner & ~ok
    ids = torch.nonzero(inner & ok).squeeze(1)
    pi = p[ids]
    q = pi * v + ids
    pos = torch.searchsorted(ref.keys, q).clamp(max=ref.num_edges - 1)
    on_path = ref.keys[pos].eq(q) & (want[pi] + ref.weights[pos].double()).eq(want[ids])
    bad[ids[~on_path]] = True
    return int(bad.sum())


def check(ref: RefGraph, samples, notes, params: dict, limits: dict) -> dict:
    """{name: (reading, limit)}."""
    del notes
    if ref.weights is None:
        raise ValueError("SSSP is judged on a weighted configuration")
    count = 0
    for root, (dist, pred) in samples:
        count += invalid(ref, root, dist, pred, search(ref, root))
    return {"sssp_invalid": (count, limits["sssp_invalid"])}


def control(ref: RefGraph, args, params: dict):
    """The control in the program's place: each search with its distances
    carried in bfloat16, the step below the port's float32, and its
    predecessors taken from those distances."""
    out = []
    for root in args:
        dist = search(ref, root, carry=torch.bfloat16).float()
        out.append(((dist, predecessors(ref, root, dist, torch.bfloat16)), None))
    return out
