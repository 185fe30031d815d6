"""Neighbor-list intersection prims: pair intersections and triangles.

Counterpart of ``cugraph_tpu/prims/intersection.py`` (ref:
cpp/src/prims/per_v_pair_transform_dst_nbr_intersection.cuh and
transform_reduce_dst_nbr_intersection_of_e_endpoints_by_v.cuh).
Adjacency lists are sorted by (major, minor), so "x in N(v)" is a search
for the packed key v * V + x among the sorted edge keys (``edge_keys``,
``edge_multiplicity``).

Neither the pair intersection nor the triangles keep the JAX package's
tiles: it probes a (pairs, max_degree) or (E, max_oriented_degree)
candidate tile, and on an RMAT graph the top vertex keeps ~10^5 edges,
so at scale 18 and above the tile would not fit on the card. Here each
pair (or oriented edge) expands only its own row, in chunks of at most
about ``PAIR_BUDGET`` (``wedge_budget``) slots (``ragged_chunks``):

- a pair (v1, v2) expands the row of its endpoint of lower degree and
  searches the other's (the intersection and its weight sum are
  symmetric), so its slots are min(deg v1, deg v2);
- an oriented edge (u -> v) expands its wedges (u -> v, u -> x), each
  closed by a search for v * V + x. The counts per vertex do not depend
  on the orientation, so callers orient towards the higher degree, which
  bounds each out-degree by ~sqrt(2E).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from ..core.csr import CompressedAdj, Graph, _build_adj

WEDGE_BUDGET = 1 << 24  # wedges expanded at once: ~8 int64 arrays of this length
PAIR_BUDGET = 1 << 24  # pair slots expanded at once, as WEDGE_BUDGET


def edge_keys(adj: CompressedAdj) -> torch.Tensor:
    """major * num_minors + minor of every edge (int64), sorted, since the
    adjacency is sorted by (major, minor)."""
    return adj.majors.to(torch.int64) * max(adj.num_minors, 1) + adj.minors.to(torch.int64)


def edge_multiplicity(
    keys: torch.Tensor, num_minors: int, majors: torch.Tensor, minors: torch.Tensor
) -> torch.Tensor:
    """How many edges (major, minor) an adjacency holds (int64; 0 where it
    holds none), by two binary searches in its sorted ``edge_keys``. The
    arguments broadcast."""
    probe = majors.to(torch.int64) * max(num_minors, 1) + minors.to(torch.int64)
    return torch.searchsorted(keys, probe, right=True) - torch.searchsorted(keys, probe)


def ragged_chunks(
    counts: torch.Tensor, budget: int
) -> Iterator[Tuple[int, int, torch.Tensor, torch.Tensor]]:
    """Items expanded by their counts, a chunk of consecutive items at a
    time whose counts sum to about ``budget`` at most (one item above it
    makes a chunk of its own). Yields (i0, i1, owner, rank) for items
    [i0, i1): the item of each slot (int64) and the slot's index within
    its item. One host read of the chunk bounds per call."""
    counts = counts.to(torch.int64)
    n = counts.numel()
    if n == 0:
        return
    dev = counts.device
    cum = torch.cumsum(counts, 0)
    total = int(cum[-1])
    if total == 0:
        return
    targets = torch.arange(1, -(-total // budget), device=dev) * budget
    bounds = torch.searchsorted(cum, targets, right=True)
    bounds = torch.unique(torch.cat([bounds.new_zeros(1), bounds, bounds.new_full((1,), n)]))
    ends = cum[(bounds - 1).clamp(min=0)]
    ends[0] = 0
    bounds, ends = bounds.tolist(), ends.tolist()
    for i in range(len(bounds) - 1):
        i0, i1, s0 = bounds[i], bounds[i + 1], ends[i]
        n_s = ends[i + 1] - s0
        if n_s == 0:
            continue
        owner = torch.repeat_interleave(torch.arange(i0, i1, device=dev), counts[i0:i1],
                                        output_size=n_s)
        rank = torch.arange(n_s, device=dev) - (cum[owner] - counts[owner] - s0)
        yield i0, i1, owner, rank


def per_v_pair_dst_nbr_intersection(
    g: Graph,
    v1: torch.Tensor,
    v2: torch.Tensor,
    *,
    max_degree: Optional[int] = None,
    vertex_weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """|N(v1) ∩ N(v2)| per pair (int32), and the sum of vertex_weights over
    the intersection (float32, summed in float64) when given. As in the
    JAX package, a common neighbour counts as often as it appears in
    v1's list (parallel edges).

    Each pair expands the row of its endpoint of lower out-degree (v1 on
    a tie) and searches the other's, ``PAIR_BUDGET`` slots at a time, so no
    (pairs, max_degree) tile is built; ``max_degree``, the JAX function's
    tile width, is accepted and not needed. Where v2's row is the one
    expanded, each distinct neighbour found counts its multiplicity in
    v1's row."""
    adj = g.csr()
    dev = adj.offsets.device
    v1 = v1.to(device=dev, dtype=torch.int64).reshape(-1)
    v2 = v2.to(device=dev, dtype=torch.int64).reshape(-1)
    offsets = adj.offsets.to(torch.int64)
    deg = offsets[1:] - offsets[:-1]
    swap = deg[v2] < deg[v1]
    tiled, searched = torch.where(swap, v2, v1), torch.where(swap, v1, v2)
    counts = torch.zeros(v1.numel(), dtype=torch.int64, device=dev)
    wsums = None
    if vertex_weights is not None:
        wsums = torch.zeros(v1.numel(), dtype=torch.float64, device=dev)
    keys = edge_keys(adj)
    for _, _, owner, rank in ragged_chunks(deg[tiled], PAIR_BUDGET):
        eidx = offsets[tiled[owner]] + rank
        cand = adj.minors[eidx].to(torch.int64)
        found = edge_multiplicity(keys, adj.num_minors, searched[owner], cand)
        # v1's row expanded: every occurrence found counts once; v2's row
        # expanded: the first occurrence of each neighbour counts its
        # multiplicity in v1's row
        first = (rank == 0) | (cand != adj.minors[(eidx - 1).clamp(min=0)].to(torch.int64))
        mult = torch.where(swap[owner], found * first, (found > 0).to(torch.int64))
        hit = mult > 0
        owner, cand, mult = owner[hit], cand[hit], mult[hit]
        counts.index_add_(0, owner, mult)
        if wsums is not None:
            wsums.index_add_(0, owner, vertex_weights[cand].to(torch.float64) * mult)
    return counts.to(torch.int32), None if wsums is None else wsums.to(torch.float32)


def degree_oriented_adj(
    src: torch.Tensor, dst: torch.Tensor, num_vertices: int, weights=None
) -> CompressedAdj:
    """A DAG adjacency over the undirected edges {src, dst}, each listed
    once (self-loops dropped): every edge points from the endpoint of lower
    (degree, id) to the higher one, degrees counted over these edges."""
    keep = src != dst
    a, b = src[keep].to(torch.int64), dst[keep].to(torch.int64)
    deg = torch.bincount(a, minlength=num_vertices) + torch.bincount(b, minlength=num_vertices)
    rank = deg * num_vertices + torch.arange(num_vertices, device=deg.device)
    fwd = rank[a] < rank[b]
    u, w = torch.where(fwd, a, b), torch.where(fwd, b, a)
    wts = None if weights is None else weights[keep]
    return _build_adj(u.to(torch.int32), w.to(torch.int32), wts, num_vertices, num_vertices)


def closed_wedges(
    oriented: CompressedAdj, wedge_budget: int = WEDGE_BUDGET
) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Every triangle of a DAG adjacency once, as the indices of its three
    edges (u -> v, u -> x, v -> x) in the adjacency's edge order, one chunk
    of at most ~wedge_budget expanded wedges at a time."""
    e = oriented.num_edges
    if e == 0:
        return
    majors = oriented.majors.to(torch.int64)
    minors = oriented.minors.to(torch.int64)
    offsets = oriented.offsets.to(torch.int64)
    keys = edge_keys(oriented)
    count = (offsets[1:] - offsets[:-1])[majors]  # wedges of each edge: deg+(u)
    for _, _, edge, rank in ragged_chunks(count, wedge_budget):
        # wedge j of edge (u -> v) pairs it with u's j-th out-edge (u -> x)
        e_ux = offsets[majors[edge]] + rank
        probe = minors[edge] * oriented.num_minors + minors[e_ux]
        e_vx = torch.searchsorted(keys, probe).clamp(max=e - 1)
        found = keys[e_vx] == probe
        yield edge[found], e_ux[found], e_vx[found]


def triangle_counts_per_vertex(
    oriented: CompressedAdj, num_vertices: int, *, wedge_budget: int = WEDGE_BUDGET
) -> torch.Tensor:
    """Per-vertex triangle counts (int32) from a DAG adjacency: each
    triangle {u, v, x} is found once, from its edge u -> v with u -> x and
    v -> x, and each corner gets +1 (ref semantics:
    transform_reduce_dst_nbr_intersection_of_e_endpoints_by_v)."""
    counts = torch.zeros(num_vertices, dtype=torch.int64, device=oriented.minors.device)
    for e_uv, e_ux, _ in closed_wedges(oriented, wedge_budget):
        for corner in (oriented.majors[e_uv], oriented.minors[e_uv], oriented.minors[e_ux]):
            counts += torch.bincount(corner.to(torch.int64), minlength=num_vertices)
    return counts.to(torch.int32)


def edge_triangle_support(
    oriented: CompressedAdj, *, wedge_budget: int = WEDGE_BUDGET
) -> torch.Tensor:
    """Per-edge support (int64, in the adjacency's edge order): the number
    of triangles each edge of a DAG adjacency closes, which is
    |N(u) ∩ N(v)| in the undirected graph."""
    support = torch.zeros(oriented.num_edges, dtype=torch.int64, device=oriented.minors.device)
    for ids in closed_wedges(oriented, wedge_budget):
        for e in ids:
            support += torch.bincount(e, minlength=oriented.num_edges)
    return support
