"""Distributed similarity (Jaccard, Sorensen, overlap) and triangle counts.

Counterpart of ``cugraph_tpu/dist/mg_similarity.py`` (ref: the MG
instantiation of cpp/src/link_prediction/similarity_impl.cuh, whose
nbr_intersection gathers remote adjacency lists by device_gatherv,
prims/detail/nbr_intersection.cuh). Every rank holds the same pair list.
Each rank contributes its slice of the expanded endpoint's neighbour list
(its DCSR src-side run, ``mg_graph.src_dcsr``), the slices are
all-gathered (the gatherv), and every rank tests the full candidate set
against its own slice of the other endpoint's list. Each (v, x) edge lives
on exactly one rank, so a SUM all-reduce of the hits is the exact
intersection, and a MAX all-reduce of the hit ids (-1 elsewhere) recovers
the members (``_mg_intersection_members``).

Differences by design: the JAX package tiles each pair's candidates at a
fixed width k, the graph's largest local degree, which at RMAT scale 18
made a 413 MB tile a round. Here each pair expands only its own list, that
of its endpoint of lower global degree, and the pairs go in chunks of
about ``PAIR_BUDGET`` candidates over all ranks (``_pair_hits``), as the
single-device ``prims/intersection.py`` does. A candidate is searched
among the rank's edges as a packed (source, global dst) key, whose
array is made for the call (the runs are sorted by global dst). Weighted sums run in float64 and round to float32 once, as
on one device. Results are tensors on the mesh's device, the same on
every rank; the per-graph derived arrays are kept in ``MGGraph.cache``,
not in a module-level cache.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..prims.intersection import PAIR_BUDGET, chunk_bounds
from ..utils.device import as_tensor, resolve_device
from ..utils.dtypes import VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects, expects_vertex_ids
from .mesh import Mesh2D, all_gather_rows
from .mg_graph import MGGraph, src_dcsr
from .mg_prims import dcsr_lookup

TRIANGLE_BATCH = 1 << 20  # oriented edges taken as pairs a round, over all ranks


class _Dcsr(NamedTuple):
    """A rank's src-side adjacency: sorted span-local sources with an edge,
    their offsets and the total, each edge's global dst (sorted within a
    source's run)."""

    nzd: torch.Tensor
    offsets: torch.Tensor
    dsts: torch.Tensor


def _graph_dcsr(mesh: Mesh2D, mgg: MGGraph) -> _Dcsr:
    a = src_dcsr(mesh, mgg)
    return _Dcsr(a.src_nzd, a.src_nzd_offsets, a.src_csr_dsts)


def _global_max(x: int, device) -> int:
    t = torch.tensor([x], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t)


def _max_local_degree(mesh: Mesh2D, mgg: MGGraph) -> int:
    """The largest local source degree over the ranks (the JAX package's
    candidate tile width k, and ``_mg_intersection_members``' default):
    a MAX all-reduce, so every rank calls it."""
    off = src_dcsr(mesh, mgg).src_nzd_offsets
    local = int((off[1:] - off[:-1]).max()) if off.numel() > 1 else 0
    return _global_max(max(local, 1), off.device)


def _edge_keys(adj: _Dcsr, width: int) -> torch.Tensor:
    """span-local src * width + global dst of every edge, int64: sorted,
    since the runs are sorted by source and, within one, by global dst.
    Made for one call and dropped after it."""
    deg = (adj.offsets[1:] - adj.offsets[:-1]).to(torch.int64)
    src = torch.repeat_interleave(adj.nzd.to(torch.int64), deg, output_size=adj.dsts.numel())
    return src * width + adj.dsts.to(torch.int64)


def _local_runs(adj: _Dcsr, span: int, j: int, v: torch.Tensor):
    """(lo, local degree) of global ids in this rank's column span; 0
    outside it and for ids < 0."""
    local = v - j * span
    mine = (v >= 0) & (local >= 0) & (local < span)
    lo, deg = dcsr_lookup(adj.nzd, adj.offsets, local.clamp(0, max(span - 1, 0)))
    return lo, torch.where(mine, deg, 0)


def _gather_ragged(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's (f, m_rank) int64 block, concatenated along dim 1 in
    rank order: the sizes by one all-gather, the blocks padded to the
    largest by another. Returns (blocks, each column's source rank)."""
    sizes = all_gather_rows(torch.tensor([t.shape[1]], dtype=torch.int64, device=t.device))
    width = int(sizes.max())
    pad = torch.zeros((t.shape[0], width), dtype=t.dtype, device=t.device)
    pad[:, : t.shape[1]] = t
    blocks = all_gather_rows(pad.t().contiguous())  # (P * width, f)
    keep = torch.arange(width, device=t.device)[None, :] < sizes[:, None]  # (P, width)
    src_rank = torch.arange(sizes.numel(), device=t.device)[:, None].expand_as(keep)[keep]
    return blocks[keep.reshape(-1)].t(), src_rank


def _intersect_in_shard(adj: _Dcsr, keys: torch.Tensor, width: int, lo_t, deg_t, local_s,
                        counted_once, i0: int, i1: int, with_slots: bool):
    """One chunk of pairs [i0, i1) (JAX mg_similarity.py:62): this rank
    expands its slice of each pair's tiled list (its runs at ``lo_t``,
    ``deg_t`` long), every rank's slices are gathered, and each candidate x
    is searched among this rank's edges (``keys``) of the pair's searched
    vertex (span-local id ``local_s``). Returns (pair, x, mult, source
    rank, slot) of the candidates found here; mult counts x once, or,
    where ``counted_once`` (the lists were swapped), its multiplicity in
    the searched list at x's first occurrence in the tiled one. Source
    rank and slot (x's index in that rank's run) only ``with_slots``."""
    dev = lo_t.device
    counts = deg_t[i0:i1]
    m = int(counts.sum())  # this rank's share of the chunk
    pair = torch.repeat_interleave(torch.arange(i0, i1, device=dev), counts, output_size=m)
    slot = torch.arange(m, device=dev) - (torch.cumsum(counts, 0) - counts)[pair - i0]
    eidx = lo_t[pair] + slot
    x = adj.dsts[eidx].to(torch.int64)
    first = (slot == 0) | (x != adj.dsts[(eidx - 1).clamp(min=0)].to(torch.int64))
    fields = [pair, x, first.to(torch.int64)] + ([slot] if with_slots else [])
    cand, src_rank = _gather_ragged(torch.stack(fields))
    pair, x, first = cand[0], cand[1], cand[2]
    # a searched vertex outside this rank's span has no key here: its
    # span-local id lies outside [0, span)
    probe = local_s[pair] * width + x
    found = torch.searchsorted(keys, probe, right=True) - torch.searchsorted(keys, probe)
    mult = torch.where(counted_once[pair], found * first, (found > 0).to(torch.int64))
    hit = mult > 0
    slots = cand[3][hit] if with_slots else None
    return pair[hit], x[hit], mult[hit], src_rank[hit], slots


def _pair_hits(mesh: Mesh2D, span: int, adj: _Dcsr, keys: torch.Tensor, width: int,
               v1: torch.Tensor, v2: torch.Tensor, *, swap: bool = True,
               with_slots: bool = False) -> Tuple[Iterator[tuple], torch.Tensor, torch.Tensor]:
    """The hits of |N(v1) ∩ N(v2)| that this rank finds, chunk by chunk,
    and the pairs' global degrees (D1, D2) (one SUM all-reduce). With
    ``swap`` each pair expands the list of its endpoint of lower global
    degree (v1 on a tie); the chunks hold about ``PAIR_BUDGET`` gathered
    candidates, so every rank cuts them at the same pairs. A common
    neighbour counts as often as it appears in v1's list (parallel
    edges), as in the JAX package. ``keys`` are ``_edge_keys(adj,
    width)``."""
    lo1, d1 = _local_runs(adj, span, mesh.j, v1)
    lo2, d2 = _local_runs(adj, span, mesh.j, v2)
    degs = torch.stack([d1, d2])
    dist.all_reduce(degs)
    big1, big2 = degs[0], degs[1]
    sw = (big2 < big1) if swap else torch.zeros_like(v1, dtype=torch.bool)
    lo_t, deg_t = torch.where(sw, lo2, lo1), torch.where(sw, d2, d1)
    local_s = torch.where(sw, v1, v2) - mesh.j * span
    budget_counts = torch.where(sw, big2, big1)

    def chunks():
        for i0, i1, _ in chunk_bounds(budget_counts, PAIR_BUDGET):
            yield _intersect_in_shard(adj, keys, width, lo_t, deg_t, local_s, sw, i0, i1,
                                      with_slots)

    return chunks(), big1, big2


def _pairs(mesh: Mesh2D, mgg: MGGraph, pairs) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(mesh.device)
    v1 = as_tensor(pairs[0], torch.int64, dev).reshape(-1)
    v2 = as_tensor(pairs[1], torch.int64, dev).reshape(-1)
    expects_vertex_ids(torch.cat([v1, v2]), mgg.num_vertices, "pairs")
    return v1, v2


def _mg_intersection(mesh: Mesh2D, mgg: MGGraph, v1: torch.Tensor, v2: torch.Tensor,
                     vertex_weights: Optional[torch.Tensor] = None):
    """|N(v1) ∩ N(v2)| (int64) of replicated pairs, the float64 sum of
    ``vertex_weights`` over the intersection (or None), and the pairs'
    global degrees, on every rank (JAX mg_similarity.py:128, which takes
    the tile width k instead)."""
    span = mgg.rows * mgg.vp
    inter = torch.zeros(v1.numel(), dtype=torch.int64, device=v1.device)
    wsum = None if vertex_weights is None else torch.zeros(v1.numel(), dtype=torch.float64,
                                                             device=v1.device)
    adj = _graph_dcsr(mesh, mgg)
    hits, d1, d2 = _pair_hits(mesh, span, adj, _edge_keys(adj, mgg.num_vertices),
                              mgg.num_vertices, v1, v2)
    for pair, x, mult, _, _ in hits:
        inter.index_add_(0, pair, mult)
        if wsum is not None:
            wsum.index_add_(0, pair, vertex_weights[x] * mult)
    dist.all_reduce(inter)
    if wsum is not None:
        dist.all_reduce(wsum)
    return inter, wsum, d1, d2


def _vertex_sums(mesh: Mesh2D, mgg: MGGraph, per_edge: torch.Tensor) -> torch.Tensor:
    """Per-vertex float64 sums of a per-edge value over each vertex's
    out-edges, (V,) on every rank: this rank's edges summed by global src
    in its edge order, then a SUM all-reduce."""
    span = mgg.rows * mgg.vp
    blk = mgg.out_block
    out = torch.zeros(mgg.num_vertices, dtype=torch.float64, device=per_edge.device)
    out.index_add_(0, blk.majors.to(torch.int64) + mesh.j * span, per_edge)
    dist.all_reduce(out)
    return out


def _mg_nbr_vertex_weight_sums(mesh: Mesh2D, mgg: MGGraph, vw: torch.Tensor) -> torch.Tensor:
    """out[u] = sum over the edges (u, x) of vw[x] (JAX mg_similarity.py:
    133): the weighted similarity's neighbourhood size, float64 on every
    rank, from the replicated (V,) vertex weights ``vw``."""
    return _vertex_sums(mesh, mgg, vw[src_dcsr(mesh, mgg).src_csr_dsts.to(torch.int64)])


def mg_similarity(mesh: Mesh2D, mgg: MGGraph, pairs, kind: str = "jaccard",
                  use_weight: bool = False) -> torch.Tensor:
    """Similarity coefficients (f32) for (v1, v2) pair arrays that every
    rank passes alike; every rank gets them all.

    use_weight=True takes the reference's weighted semantics, as the
    single-device ``algos/link_prediction.py``: the vertex weight w_x is
    the sum of x's edge weights; a pair's intersection weighs the w_x of
    its common neighbours, an endpoint's size the w_x of its own
    neighbours; the sums in float64."""
    expects(mgg.is_symmetric, f"{kind} requires a symmetric graph")
    if kind not in ("jaccard", "sorensen", "overlap"):
        raise ValueError(kind)
    v1, v2 = _pairs(mesh, mgg, pairs)
    if use_weight:
        expects(mgg.weighted, "weighted similarity requires edge weights")
        vw = _vertex_sums(mesh, mgg, mgg.out_block.weights.to(torch.float64))
        _, inter_w, _, _ = _mg_intersection(mesh, mgg, v1, v2, vertex_weights=vw)
        inter = inter_w.to(WEIGHT_DTYPE)
        nbr = _mg_nbr_vertex_weight_sums(mesh, mgg, vw).to(WEIGHT_DTYPE)
        a, b = nbr[v1], nbr[v2]
    else:
        counts, _, d1, d2 = _mg_intersection(mesh, mgg, v1, v2)
        inter = counts.to(WEIGHT_DTYPE)
        a, b = d1.to(WEIGHT_DTYPE), d2.to(WEIGHT_DTYPE)  # degrees, also on a weighted graph
    if kind == "jaccard":
        denom = a + b - inter
    elif kind == "sorensen":
        denom = a + b
        inter = 2.0 * inter
    else:
        denom = torch.minimum(a, b)
    return torch.where(denom > 0, inter / torch.clamp(denom, min=1e-30), 0.0)


def mg_jaccard(mesh, mgg, pairs, use_weight: bool = False):
    return mg_similarity(mesh, mgg, pairs, "jaccard", use_weight=use_weight)


def mg_sorensen(mesh, mgg, pairs, use_weight: bool = False):
    return mg_similarity(mesh, mgg, pairs, "sorensen", use_weight=use_weight)


def mg_overlap(mesh, mgg, pairs, use_weight: bool = False):
    return mg_similarity(mesh, mgg, pairs, "overlap", use_weight=use_weight)


def _oriented_dcsr(mesh: Mesh2D, mgg: MGGraph) -> _Dcsr:
    """This rank's oriented src-side adjacency (JAX mg_similarity.py:239):
    its edges with global dst < global src, in the DCSR format. Under a
    degree-descending renumbering this points every undirected edge at
    its endpoint of higher degree, which bounds the oriented degrees by
    ~sqrt(2E); any total order counts right. Made once a graph, kept in
    its cache."""
    hit = mgg.cache.get("oriented_dcsr")
    if hit is None:
        span = mgg.rows * mgg.vp
        nzd, off, dsts = _graph_dcsr(mesh, mgg)
        deg = (off[1:] - off[:-1]).to(torch.int64)
        src = torch.repeat_interleave(nzd.to(torch.int64), deg, output_size=dsts.numel())
        keep = dsts.to(torch.int64) < src + mesh.j * span
        src, o_dsts = src[keep], dsts[keep]
        o_nzd, counts = torch.unique_consecutive(src, return_counts=True)
        o_off = torch.zeros(o_nzd.numel() + 1, dtype=off.dtype, device=off.device)
        o_off[1:] = torch.cumsum(counts, 0)
        hit = _Dcsr(o_nzd.to(VERTEX_DTYPE), o_off, o_dsts.contiguous())
        mgg.cache["oriented_dcsr"] = hit
    return hit


def mg_triangle_count(mesh: Mesh2D, mgg: MGGraph,
                      batch_size: Optional[int] = None) -> torch.Tensor:
    """Per-vertex triangle counts (int64, (V,) on every rank; JAX
    mg_similarity.py:317).

    Each rank's oriented edges (global dst < global src: one of the two
    stored directions of each undirected edge, on exactly one rank) are
    all-gathered ``batch_size`` (default ``TRIANGLE_BATCH``) at a time as
    pairs (u, v) and intersected against the distributed oriented
    adjacency: a triangle {u > v > x} is found once, at its pair (u, v)
    with member x, and its three corners each get +1 where it was found.
    One SUM all-reduce of the counts ends the run."""
    expects(mgg.is_symmetric, "triangle_count requires a symmetric graph")
    dev = resolve_device(mesh.device)
    span = mgg.rows * mgg.vp
    adj = _oriented_dcsr(mesh, mgg)
    n_dev = mgg.rows * mgg.cols
    per_rank = max(-(-int(batch_size or TRIANGLE_BATCH) // n_dev), 1)
    m = adj.dsts.numel()
    rounds = -(-_global_max(m, dev) // per_rank)
    counts = torch.zeros(mgg.num_vertices, dtype=torch.int64, device=dev)
    keys = _edge_keys(adj, mgg.num_vertices)
    for r in range(rounds):
        a, b = min(r * per_rank, m), min((r + 1) * per_rank, m)
        # the edges [a, b) of this rank: their sources from the run starts
        run = torch.searchsorted(adj.offsets[1:].to(torch.int64),
                                 torch.arange(a, b, device=dev), right=True)
        u_loc = adj.nzd[run].to(torch.int64) + mesh.j * span
        v_loc = adj.dsts[a:b].to(torch.int64)
        uv, _ = _gather_ragged(torch.stack([u_loc, v_loc]))
        u, v = uv[0], uv[1]
        hits, _, _ = _pair_hits(mesh, span, adj, keys, mgg.num_vertices, u, v)
        for pair, x, mult, _, _ in hits:
            counts.index_add_(0, u[pair], mult)
            counts.index_add_(0, v[pair], mult)
            counts.index_add_(0, x, mult)
    dist.all_reduce(counts)
    return counts


def _mg_intersection_members(mesh: Mesh2D, mgg: MGGraph, v1: torch.Tensor, v2: torch.Tensor,
                             k: Optional[int] = None):
    """(inter (n,) int64, members (n, P * k) int64), every rank alike, in
    the JAX package's layout (mg_similarity.py:447): column (j * R + i) *
    k + s holds the s-th entry of rank (i, j)'s slice of N(v1) where it is
    in N(v2), -1 elsewhere. k defaults to ``_max_local_degree``; the SUM
    all-reduce gives inter, the MAX all-reduce the members."""
    k = _max_local_degree(mesh, mgg) if k is None else int(k)
    span = mgg.rows * mgg.vp
    r, c = mgg.rows, mgg.cols
    v1 = v1.to(torch.int64).reshape(-1)
    v2 = v2.to(torch.int64).reshape(-1)
    members = torch.full((v1.numel(), r * c * k), -1, dtype=torch.int64, device=v1.device)
    adj = _graph_dcsr(mesh, mgg)
    hits, _, _ = _pair_hits(mesh, span, adj, _edge_keys(adj, mgg.num_vertices), mgg.num_vertices,
                            v1, v2, swap=False, with_slots=True)
    for pair, x, _, src_rank, slot in hits:
        col = (src_rank % c * r + src_rank // c) * k + slot  # rank i * C + j -> j * R + i
        members[pair, col] = x
    inter = (members >= 0).sum(1)
    dist.all_reduce(members, op=dist.ReduceOp.MAX)
    dist.all_reduce(inter)
    return inter, members
