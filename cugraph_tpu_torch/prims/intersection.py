"""Neighbor-list intersection prims: pair intersections and triangles.

Counterpart of ``cugraph_tpu/prims/intersection.py`` (ref:
cpp/src/prims/per_v_pair_transform_dst_nbr_intersection.cuh and
transform_reduce_dst_nbr_intersection_of_e_endpoints_by_v.cuh).
Adjacency lists are sorted by (major, minor), so "x in N(v)" is a binary
search in v's offset range. ``per_v_pair_dst_nbr_intersection`` keeps the
JAX package's (pairs, max_degree) candidate tile.

Triangles do not: the JAX prim probes a (E, max_oriented_degree) tile,
and on an RMAT graph oriented by vertex id the top vertex keeps ~10^5
out-edges, so the tile would not fit at scale 18 and above. Here each
oriented edge (u -> v) expands only its own wedges (u -> v, u -> x), in
chunks of at most ``wedge_budget`` wedges, and each wedge is closed by a
search for the packed key v * V + x among the sorted edge keys. The
counts per vertex do not depend on the orientation, so callers orient
towards the higher degree, which bounds each out-degree by ~sqrt(2E).
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import torch

from ..core.csr import CompressedAdj, Graph, _build_adj

WEDGE_BUDGET = 1 << 24  # wedges expanded at once: ~8 int64 arrays of this length


def _contains_sorted(
    minors: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, query: torch.Tensor
) -> torch.Tensor:
    """Vectorized binary search: is query present in minors[lo:hi]?
    minors is sorted within each [lo, hi) segment; the arguments
    broadcast."""
    n = minors.numel()
    shape = torch.broadcast_shapes(lo.shape, hi.shape, query.shape)
    if n == 0:
        return torch.zeros(shape, dtype=torch.bool, device=minors.device)
    lo = lo.to(torch.int64).expand(shape)
    hi0 = hi.to(torch.int64).expand(shape)
    hi = hi0
    query = query.expand(shape)
    for _ in range(math.ceil(math.log2(max(n, 2))) + 1):
        mid = (lo + hi) // 2
        go_right = minors[mid.clamp(0, n - 1)] < query
        active = lo < hi
        lo = torch.where(go_right & active, mid + 1, lo)
        hi = torch.where(~go_right & active, mid, hi)
    return (lo < hi0) & (minors[lo.clamp(0, n - 1)] == query)


def _candidate_tile(
    adj: CompressedAdj, verts: torch.Tensor, width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, width) tile of the first ``width`` neighbors of each vertex, and
    its mask."""
    verts = verts.to(torch.int64)
    starts = adj.offsets[verts].to(torch.int64)
    degs = adj.offsets[verts + 1].to(torch.int64) - starts
    slot = torch.arange(width, dtype=torch.int64, device=verts.device)[None, :]
    mask = slot < degs[:, None]
    if adj.num_edges == 0:
        return torch.zeros(mask.shape, dtype=adj.minors.dtype, device=verts.device), mask
    cand = adj.minors[(starts[:, None] + slot).clamp(0, adj.num_edges - 1)]
    return cand, mask


def per_v_pair_dst_nbr_intersection(
    g: Graph,
    v1: torch.Tensor,
    v2: torch.Tensor,
    *,
    max_degree: int,
    vertex_weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """|N(v1) ∩ N(v2)| per pair (int32), and the sum of vertex_weights over
    the intersection when given. max_degree must be at least the largest
    out-degree among v1."""
    adj = g.csr()
    cand, mask = _candidate_tile(adj, v1, max_degree)
    v2 = v2.to(torch.int64)
    lo2 = adj.offsets[v2][:, None]
    hi2 = adj.offsets[v2 + 1][:, None]
    member = _contains_sorted(adj.minors, lo2, hi2, cand) & mask
    counts = member.sum(1, dtype=torch.int32)
    wsums = None
    if vertex_weights is not None:
        wv = vertex_weights[cand.to(torch.int64).clamp(0, g.num_vertices - 1)]
        wsums = torch.where(member, wv, 0.0).sum(1)
    return counts, wsums


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
    e, v = oriented.num_edges, oriented.num_majors
    if e == 0:
        return
    dev = oriented.minors.device
    majors = oriented.majors.to(torch.int64)
    minors = oriented.minors.to(torch.int64)
    offsets = oriented.offsets.to(torch.int64)
    keys = majors * v + minors  # sorted: the adjacency is sorted by (major, minor)
    count = (offsets[1:] - offsets[:-1])[majors]  # wedges of each edge: deg+(u)
    cum = torch.cumsum(count, 0)
    total = int(cum[-1])
    if total == 0:
        return
    targets = torch.arange(1, -(-total // wedge_budget), device=dev) * wedge_budget
    bounds = torch.searchsorted(cum, targets, right=True)
    bounds = torch.unique(torch.cat([bounds.new_zeros(1), bounds, bounds.new_full((1,), e)]))
    ends = cum[(bounds - 1).clamp(min=0)]
    ends[0] = 0
    bounds, ends = bounds.tolist(), ends.tolist()
    for i in range(len(bounds) - 1):
        e0, e1, w0 = bounds[i], bounds[i + 1], ends[i]
        n_w = ends[i + 1] - w0
        edge = torch.repeat_interleave(
            torch.arange(e0, e1, device=dev), count[e0:e1], output_size=n_w
        )
        # wedge j of edge (u -> v) pairs it with u's j-th out-edge (u -> x)
        first = cum[edge] - count[edge] - w0
        e_ux = offsets[majors[edge]] + torch.arange(n_w, device=dev) - first
        del first
        probe = minors[edge] * v + minors[e_ux]
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
