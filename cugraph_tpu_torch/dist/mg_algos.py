"""Distributed algorithms over the 2D-partitioned MGGraph.

Counterpart of ``cugraph_tpu/dist/mg_algos.py``: each is the loop of its
single-device counterpart with the prims swapped for the distributed ones
(``dist/mg_prims.py``). Every rank calls it with its own mesh position and
graph share, and gets back the values of its own vertex range, (vp, ...)
tensors; ``mg_graph.unshard_vertex_values`` gathers the global array.
Where the JAX package keeps the loop's scalars on the device inside one
jit, the port reads them on the host once per iteration, as its
single-device loops do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..algos.traversal import INVALID_DISTANCE, INVALID_VERTEX, MAX_VERTICES
from ..prims.reduce_ops import ANY, MAXIMUM, MINIMUM, PLUS
from ..utils.device import as_tensor, resolve_device
from ..utils.dtypes import VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects, expects_vertex_ids
from . import mg_prims
from .mesh import Mesh2D
from .mg_graph import MGGraph, shard_vertex_values


def _local_ids(mesh: Mesh2D, mgg: MGGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global ids (int64) of this rank's range, and which are < V, on the
    mesh's device (a card mesh raises without CUDA)."""
    lo, _ = mgg.partition.range_of(mesh.i, mesh.j)
    gid = torch.arange(lo, lo + mgg.vp, dtype=torch.int64, device=resolve_device(mesh.device))
    return gid, gid < mgg.num_vertices


def _source_mask(mesh: Mesh2D, mgg: MGGraph, sources) -> torch.Tensor:
    """This rank's (vp,) bool slice of the global source mask; the mesh's
    device must be there (a card mesh raises without CUDA)."""
    dev = resolve_device(mesh.device)
    v = mgg.num_vertices
    sources = as_tensor(sources, torch.int64, dev).reshape(-1)
    expects(bool(((sources >= 0) & (sources < v)).all()), "source vertex out of range")
    src_mask = torch.zeros(v, dtype=torch.bool, device=dev)
    src_mask[sources] = True
    return shard_vertex_values(mesh, mgg, src_mask)


def mg_out_weight_sums(mesh: Mesh2D, mgg: MGGraph) -> torch.Tensor:
    """Per-vertex out weight sums (out-degrees if unweighted), (vp,) f32:
    the column span's sums from ``out_block``, merged over ``row_group``."""
    blk = mgg.out_block
    if blk.weights is None:
        partial = blk.degrees().to(WEIGHT_DTYPE)
    else:
        partial = torch.zeros(blk.num_majors, dtype=WEIGHT_DTYPE, device=blk.weights.device)
        partial.index_add_(0, blk.majors, blk.weights)
    return mg_prims._merge_src_partials(mesh, partial, PLUS)


def mg_in_degrees(mesh: Mesh2D, mgg: MGGraph) -> torch.Tensor:
    """Per-vertex in-degrees, (vp,) int32: the blocks' degrees from
    ``in_block``'s offsets, merged over ``col_group``."""
    return mg_prims._merge_dst_partials(mesh, mgg.in_block.degrees(), PLUS)


# ---------------------------------------------------------------------------
# PageRank: the loop of algos/link_analysis.py (ref pagerank_impl.cuh:209)
# ---------------------------------------------------------------------------


def mg_pagerank(
    mesh: Mesh2D,
    mgg: MGGraph,
    alpha: float = 0.85,
    max_iterations: int = 100,
    tol: float = 1.0e-6,
    personalization: Optional[Tuple[object, object]] = None,
    nstart=None,
    fail_on_nonconvergence: bool = False,
    gather_mode: str = "all_gather",
) -> Tuple[torch.Tensor, int]:
    """Returns (this rank's PageRank scores (vp,) f32, iterations).

    personalization: (vertex_ids, values), the same on every rank, the
    ids in [0, V) (``GraphError`` otherwise, as the single-device
    ``pagerank``); nstart: a global (V,) start vector. The loop runs while
    the global L1 change exceeds V * tol; each iteration is one
    ``per_v_incoming_sorted``, so one ``spmv_sum`` launch on a card
    (``gather_mode="all_gather"``), or R of them around the ring over
    ``row_group`` (``"ring"``: peak src-side memory (vp,), not R*vp;
    another mode raises ValueError)."""
    v = mgg.num_vertices
    gid, vmask = _local_ids(mesh, mgg)
    dev = mesh.device
    out_wsum = mg_out_weight_sums(mesh, mgg)
    dangling = vmask & (out_wsum <= 0)
    inv_out = torch.where(out_wsum > 0, 1.0 / out_wsum.clamp(min=1e-30), 0.0)
    if personalization is not None:
        ids = as_tensor(personalization[0], torch.int64, dev).reshape(-1)
        vals = as_tensor(personalization[1], WEIGHT_DTYPE, dev).reshape(-1)
        expects_vertex_ids(ids, v, "personalization")
        lo = int(gid[0])
        mine = (ids >= lo) & (ids < lo + mgg.vp)
        local = torch.zeros(mgg.vp, dtype=WEIGHT_DTYPE, device=dev)
        local.index_add_(0, ids[mine] - lo, vals[mine])
        total = mg_prims.transform_reduce_v(mesh, local)
        reset = local / total.clamp(min=1e-30)
    else:
        reset = torch.where(vmask, 1.0 / v, 0.0).to(WEIGHT_DTYPE)
    if nstart is not None:
        p0 = shard_vertex_values(mesh, mgg, as_tensor(nstart, WEIGHT_DTYPE, dev))
        tot0 = mg_prims.transform_reduce_v(mesh, torch.where(vmask, p0, 0.0))
        pr = torch.where(vmask, p0 / tot0.clamp(min=1e-30), 0.0)
    else:
        pr = torch.where(vmask, 1.0 / v, 0.0).to(WEIGHT_DTYPE)

    diff, it = float("inf"), 0
    while diff > v * tol and it < max_iterations:
        agg = mg_prims.per_v_incoming_sorted(mesh, mgg, pr * inv_out, gather_mode=gather_mode)
        d_sum = mg_prims.transform_reduce_v(mesh, torch.where(dangling, pr, 0.0))
        new = alpha * (agg + d_sum * reset) + (1.0 - alpha) * reset
        new = torch.where(vmask, new, 0.0)
        diff = float(mg_prims.transform_reduce_v(mesh, (new - pr).abs()))
        pr, it = new, it + 1
    if fail_on_nonconvergence:
        expects(diff <= v * tol, "MG PageRank failed to converge")
    return pr, it


# ---------------------------------------------------------------------------
# BFS: the loop of algos/traversal.py (ref bfs_impl.cuh:205-283)
# ---------------------------------------------------------------------------


def mg_bfs(
    mesh: Mesh2D, mgg: MGGraph, sources, depth_limit: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns this rank's (distances int32, predecessors int32), (vp,)
    each; unreached vertices get INVALID_DISTANCE and -1.

    Up to 2^24 vertices (ids ride f32 exactly) a level is one dense
    min-plus sweep, ``frontier_push_by_dst_sorted`` (``spmv_minplus`` on a
    card): x = global id on the frontier, +inf elsewhere, so y is finite
    where a frontier in-neighbour exists and is then the smallest one,
    the predecessor. Above that, the frontier push with the same rule."""
    v = mgg.num_vertices
    frontier = _source_mask(mesh, mgg, sources)
    limit = int(depth_limit) if depth_limit is not None else v
    dense = v <= MAX_VERTICES
    gid, vmask = _local_ids(mesh, mgg)
    gidf = gid.to(torch.float32)

    def e_op(s, d, sv, dv, w):
        return ~dv, s  # dv = visited[dst]; payload = global src id

    visited = frontier.clone()
    dist = torch.where(frontier, 0, INVALID_DISTANCE).to(VERTEX_DTYPE)
    pred = torch.full((mgg.vp,), INVALID_VERTEX, dtype=VERTEX_DTYPE, device=mesh.device)
    n_frontier = int(mg_prims.transform_reduce_v(mesh, frontier))
    depth = 0
    while n_frontier > 0 and depth < limit:
        if dense:
            touched, y = mg_prims.frontier_push_by_dst_sorted(mesh, mgg, frontier, gidf)
            pred_cand = torch.where(touched, y, -1.0).to(VERTEX_DTYPE)
        else:
            touched, pred_cand = mg_prims.frontier_push_by_dst(
                mesh, mgg, frontier, e_op, reduce_op=ANY, dst_values=visited)
        new = touched & ~visited & vmask
        dist = torch.where(new, depth + 1, dist)
        pred = torch.where(new, pred_cand, pred)
        n_frontier = int(mg_prims.transform_reduce_v(mesh, new))
        visited |= new
        frontier = new
        depth += 1
    return dist, pred


# ---------------------------------------------------------------------------
# SSSP: the sweep loop of algos/traversal.py (ref sssp_impl.cuh)
# ---------------------------------------------------------------------------


def mg_sssp(
    mesh: Mesh2D, mgg: MGGraph, source, cutoff: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns this rank's (distances f32, predecessors int32), (vp,) each;
    unreachable vertices, and those beyond ``cutoff``, get +inf and -1.

    Bellman-Ford over full min-plus sweeps: each round is one
    ``per_v_incoming_sorted_min`` with the weights (``spmv_minplus`` over
    the rank's ``in_block`` on a card, a MIN merge over ``col_group``;
    x + 1 on an unweighted graph), until no distance changes anywhere.
    Predecessors follow the single-device sweep's rule: the smallest src
    among the tree edges, dist[s] + w == dist[d], sources excluded. The
    JAX package's XLA branch relaxes the frontier's edges instead; both
    reach the same distances."""
    v = mgg.num_vertices
    src_mask = _source_mask(mesh, mgg, source)
    _, vmask = _local_ids(mesh, mgg)
    c = float("inf") if cutoff is None else float(cutoff)
    inf = float("inf")
    weighted = mgg.weighted
    dist = torch.where(src_mask, 0.0, inf).to(WEIGHT_DTYPE)
    changed, it = 1, 0
    while changed > 0 and it < v:
        relax = mg_prims.per_v_incoming_sorted_min(mesh, mgg, dist, use_weights=weighted)
        if not weighted:
            relax = relax + 1.0
        relax = torch.where(relax <= c, relax, inf)
        new = torch.minimum(dist, relax)
        changed = int(mg_prims.transform_reduce_v(mesh, (new < dist).to(torch.int32)))
        dist, it = new, it + 1

    def tree_src(s, d, sv, dv, w):
        on_tree = torch.isfinite(dv) & (sv + (1.0 if w is None else w) == dv)
        return torch.where(on_tree, s, v)

    pred = mg_prims.per_v_transform_reduce_incoming_e(
        mesh, mgg, tree_src, reduce_op=MINIMUM, src_values=dist, dst_values=dist)
    keep = (pred < v) & ~src_mask & vmask
    return dist, torch.where(keep, pred, INVALID_VERTEX).to(VERTEX_DTYPE)


# ---------------------------------------------------------------------------
# Katz, eigenvector, HITS: the loops of algos/centrality.py and
# algos/link_analysis.py (ref katz_centrality_impl.cuh,
# eigenvector_centrality_impl.cuh, hits_impl.cuh)
# ---------------------------------------------------------------------------


def _global_max(local: torch.Tensor) -> torch.Tensor:
    m = local.max()
    torch.distributed.all_reduce(m, op=torch.distributed.ReduceOp.MAX)
    return m


def mg_katz_centrality(
    mesh: Mesh2D,
    mgg: MGGraph,
    alpha: float,
    beta: float = 1.0,
    max_iterations: int = 1000,
    tol: float = 1.0e-6,
) -> torch.Tensor:
    """This rank's (vp,) Katz centralities, x = alpha * A^T x + beta from
    x = 0, L2-normalized over the graph. The loop runs while the global L1
    change exceeds V * tol; each iteration is one ``per_v_incoming_sorted``
    (the weighted ``spmv_sum`` over the rank's ``in_block`` on a card)."""
    v = mgg.num_vertices
    _, vmask = _local_ids(mesh, mgg)
    x = torch.zeros(mgg.vp, dtype=WEIGHT_DTYPE, device=vmask.device)
    diff, it = float("inf"), 0
    while diff > v * tol and it < max_iterations:
        new = alpha * mg_prims.per_v_incoming_sorted(mesh, mgg, x) + beta
        new = torch.where(vmask, new, 0.0)
        diff = float(mg_prims.transform_reduce_v(mesh, (new - x).abs()))
        x, it = new, it + 1
    norm2 = mg_prims.transform_reduce_v(mesh, x * x)
    return x / torch.sqrt(norm2).clamp(min=1e-30)


def mg_eigenvector_centrality(
    mesh: Mesh2D, mgg: MGGraph, max_iterations: int = 1000, tol: float = 1.0e-6
) -> torch.Tensor:
    """This rank's (vp,) eigenvector centralities: power iteration on
    A^T + I from x = 1/V, L2-normalized over the graph each step, while
    the global L1 change exceeds V * tol."""
    v = mgg.num_vertices
    _, vmask = _local_ids(mesh, mgg)
    x = torch.where(vmask, 1.0 / v, 0.0).to(WEIGHT_DTYPE)
    diff, it = float("inf"), 0
    while diff > v * tol and it < max_iterations:
        new = torch.where(vmask, mg_prims.per_v_incoming_sorted(mesh, mgg, x) + x, 0.0)
        norm2 = mg_prims.transform_reduce_v(mesh, new * new)
        new = new / torch.sqrt(norm2).clamp(min=1e-30)
        diff = float(mg_prims.transform_reduce_v(mesh, (new - x).abs()))
        x, it = new, it + 1
    return x


def mg_hits(
    mesh: Mesh2D, mgg: MGGraph, max_iterations: int = 100, tol: float = 1.0e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's (vp,) (hubs, authorities). Each iteration pulls
    authorities from hubs (``per_v_incoming_sorted``, the weighted
    ``spmv_sum`` over ``in_block``) and pushes hubs back
    (``per_v_outgoing_sorted``, over ``out_block``, merged over
    ``row_group``), each divided by its global max (floored at 1e-30); the
    loop runs while the global L1 change of the hubs exceeds ``tol`` (not
    V * tol: the JAX package's and the single-device rule). Both vectors
    end divided by their global sums."""
    v = mgg.num_vertices
    _, vmask = _local_ids(mesh, mgg)
    h = torch.where(vmask, 1.0 / v, 0.0).to(WEIGHT_DTYPE)
    a = torch.zeros_like(h)
    diff, it = float("inf"), 0
    while diff > tol and it < max_iterations:
        a = mg_prims.per_v_incoming_sorted(mesh, mgg, h)
        a = a / _global_max(a).clamp(min=1e-30)
        h_new = mg_prims.per_v_outgoing_sorted(mesh, mgg, a)
        h_new = h_new / _global_max(h_new).clamp(min=1e-30)
        diff = float(mg_prims.transform_reduce_v(mesh, (h_new - h).abs()))
        h, it = h_new, it + 1
    hs = mg_prims.transform_reduce_v(mesh, h)
    as_ = mg_prims.transform_reduce_v(mesh, a)
    return h / hs.clamp(min=1e-30), a / as_.clamp(min=1e-30)


# ---------------------------------------------------------------------------
# GNN aggregation (SpMM): the GraphSAGE substrate, distributed
# ---------------------------------------------------------------------------


def mg_spmm_aggregate(
    mesh: Mesh2D, mgg: MGGraph, features: torch.Tensor, op: str = "mean"
) -> torch.Tensor:
    """This rank's (vp, F) features -> its aggregated (vp, F): op over the
    in-neighbours' rows, edge weights ignored.

    sum and mean follow the bf16 contract of the JAX package's kernel
    branch (operands rounded to bf16, sums in f32), on a card and on the
    CPU: ``per_v_incoming_sorted_spmm``; mean divides by max(in-degree, 1).
    max is the plain per-rank amax and a MAX merge, isolated rows 0."""
    expects(op in ("sum", "mean", "max"), f"unknown op {op!r}")
    if op == "max":
        agg = mg_prims.per_v_transform_reduce_incoming_e(
            mesh, mgg, lambda s, d, sv, dv, w: sv, reduce_op=MAXIMUM, src_values=features)
        return torch.where(torch.isfinite(agg), agg, 0.0)
    agg = mg_prims.per_v_incoming_sorted_spmm(mesh, mgg, features)
    if op == "mean":
        deg = mg_in_degrees(mesh, mgg).clamp(min=1).to(agg.dtype)
        agg = agg / deg[:, None]
    return agg


# ---------------------------------------------------------------------------
# WCC and core number: the loops of algos/components.py and algos/cores.py
# (ref weakly_connected_components_impl.cuh, core_number_impl.cuh)
# ---------------------------------------------------------------------------


def mg_wcc(mesh: Mesh2D, mgg: MGGraph) -> torch.Tensor:
    """This rank's (vp,) int32 component labels, each the smallest vertex
    id of its weakly connected component, as the single-device
    ``weakly_connected_components`` gives them.

    Min-label propagation from the singletons until no label changes
    anywhere (JAX mg_algos.py:562). Up to ``MAX_VERTICES`` (labels ride
    f32 exactly) a sweep is two min-plus products without weights: down,
    ``per_v_incoming_sorted_min`` over ``in_block``, and up,
    ``per_v_outgoing_sorted_min`` over ``out_block`` (``spmv_minplus``
    on a card). Above it the labels stay int32 and the sweeps take the
    generic MIN prims, as the JAX package's XLA branch does (:628-636).
    ``mg_wcc.sweeps`` holds the last call's sweep count."""
    gid, _ = _local_ids(mesh, mgg)
    labels = gid.to(VERTEX_DTYPE)
    dense = mgg.num_vertices <= MAX_VERTICES
    changed, sweeps = 1, 0
    while changed > 0:
        if dense:
            lf = labels.to(torch.float32)
            cand = torch.minimum(mg_prims.per_v_incoming_sorted_min(mesh, mgg, lf),
                                 mg_prims.per_v_outgoing_sorted_min(mesh, mgg, lf))
            new = torch.where(torch.isfinite(cand),
                              torch.minimum(labels, cand.to(VERTEX_DTYPE)), labels)
        else:
            down = mg_prims.per_v_transform_reduce_incoming_e(
                mesh, mgg, lambda s, d, sv, dv, w: sv, reduce_op=MINIMUM, src_values=labels)
            up = mg_prims.per_v_transform_reduce_outgoing_e(
                mesh, mgg, lambda s, d, sv, dv, w: dv, reduce_op=MINIMUM, dst_values=labels)
            new = torch.minimum(labels, torch.minimum(down, up))
        changed = int(mg_prims.transform_reduce_v(mesh, (new != labels).to(torch.int32)))
        labels, sweeps = new, sweeps + 1
    mg_wcc.sweeps = sweeps
    return labels


mg_wcc.sweeps = 0

DEGREE_TYPES = ("incoming", "outgoing", "incoming_outgoing")


def mg_core_number(
    mesh: Mesh2D, mgg: MGGraph, degree_type: str = "incoming_outgoing"
) -> torch.Tensor:
    """This rank's (vp,) int32 core numbers, the peeling of the
    single-device ``core_number`` (JAX mg_algos.py:910): at level k, alive
    vertices of residual degree <= k drop out with core number k until a
    round drops none anywhere; then k grows, until no vertex is alive.

    The residual degree is an unweighted ``spmv_sum`` of the 0/1 alive
    mask in each direction ``degree_type`` needs, as the JAX sorted
    branch does (:960-977): ``per_v_incoming_sorted`` over ``in_block``
    and ``per_v_outgoing_sorted`` over ``out_block``, rounded to int32,
    exact while degrees stay under 2^24. Edge weights are ignored.
    ``mg_core_number.rounds`` holds the last call's inner round count."""
    expects(degree_type in DEGREE_TYPES, f"invalid degree_type {degree_type!r}")
    _, vmask = _local_ids(mesh, mgg)

    def residual_degree(alive):
        af = alive.to(torch.float32)
        out = torch.zeros(mgg.vp, dtype=torch.int32, device=af.device)
        if degree_type in ("outgoing", "incoming_outgoing"):
            d_out = mg_prims.per_v_outgoing_sorted(mesh, mgg, af, use_weights=False)
            out += torch.round(d_out).to(torch.int32)
        if degree_type in ("incoming", "incoming_outgoing"):
            d_in = mg_prims.per_v_incoming_sorted(mesh, mgg, af, use_weights=False)
            out += torch.round(d_in).to(torch.int32)
        return out

    alive = vmask.clone()
    core = torch.zeros(mgg.vp, dtype=torch.int32, device=vmask.device)
    n_alive = int(mg_prims.transform_reduce_v(mesh, alive.to(torch.int32)))
    k, rounds = 0, 0
    while n_alive > 0:
        while True:
            drop = alive & (residual_degree(alive) <= k)
            dropped = int(mg_prims.transform_reduce_v(mesh, drop.to(torch.int32)))
            rounds += 1
            if dropped == 0:
                break
            core = torch.where(drop, k, core)
            alive &= ~drop
            n_alive -= dropped
        k += 1
    mg_core_number.rounds = rounds
    return core


mg_core_number.rounds = 0


# ---------------------------------------------------------------------------
# Path extraction (ref extract_bfs_paths_impl.cuh)
# ---------------------------------------------------------------------------


def _replicated_lookup(mesh: Mesh2D, mgg: MGGraph, vals_l: torch.Tensor, keys: torch.Tensor,
                       fill) -> torch.Tensor:
    """vals[keys] for global keys that every rank holds alike, from the
    owners' (vp,) slices: each rank puts in what it owns, and a SUM
    all-reduce over the world joins them (JAX ``_replicated_lookup``,
    mg_algos.py:1097). Keys outside [0, V) give ``fill``."""
    lo, _ = mgg.partition.range_of(mesh.i, mesh.j)
    loc = keys - lo
    ok = (loc >= 0) & (loc < mgg.vp) & (keys < mgg.num_vertices)
    contrib = torch.where(ok, vals_l[loc.clamp(0, mgg.vp - 1)], torch.zeros_like(vals_l[:1]))
    found = ok.to(torch.int32)
    torch.distributed.all_reduce(contrib)
    torch.distributed.all_reduce(found)
    return torch.where(found > 0, contrib, torch.full_like(contrib, fill))


def mg_extract_bfs_paths(
    mesh: Mesh2D, mgg: MGGraph, distances: torch.Tensor, predecessors: torch.Tensor, destinations
) -> Tuple[torch.Tensor, int]:
    """Paths from this rank's (vp,) ``mg_bfs`` or ``mg_sssp`` results:
    (paths (n, max_len) int32, source first, padded with -1 at the front,
    max_len), the contract of the single-device ``extract_bfs_paths``.
    Every rank passes the same destinations, in [0, V), and gets the same
    paths, a tensor on the mesh's device (the JAX package returns numpy).

    Each hop is a lookup at the owner joined by a SUM all-reduce over the
    world, on the device; the host reads only max_len."""
    dev = resolve_device(mesh.device)
    dest = as_tensor(destinations, torch.int64, dev).reshape(-1)
    expects_vertex_ids(dest, mgg.num_vertices, "destinations")
    d = _replicated_lookup(mesh, mgg, distances, dest, INVALID_DISTANCE)
    finite = (d != INVALID_DISTANCE) & torch.isfinite(d.to(torch.float32))
    max_len = int(torch.where(finite, d, 0).max()) + 1
    cur = dest.to(VERTEX_DTYPE)
    steps = []
    for _ in range(max_len):
        steps.append(cur)
        hop = _replicated_lookup(mesh, mgg, predecessors, cur.clamp(min=0).to(torch.int64),
                                 INVALID_VERTEX)
        cur = torch.where(cur >= 0, hop, INVALID_VERTEX)
    return torch.stack(steps, 1).flip(1), max_len
