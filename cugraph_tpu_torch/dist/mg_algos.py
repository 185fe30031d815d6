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
from ..prims.reduce_ops import ANY, MAXIMUM, PLUS
from ..utils.device import as_tensor
from ..utils.dtypes import VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects
from . import mg_prims
from .mesh import Mesh2D
from .mg_graph import MGGraph, shard_vertex_values


def _local_ids(mesh: Mesh2D, mgg: MGGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global ids (int64) of this rank's range, and which are < V."""
    lo, _ = mgg.partition.range_of(mesh.i, mesh.j)
    gid = torch.arange(lo, lo + mgg.vp, dtype=torch.int64, device=mesh.device)
    return gid, gid < mgg.num_vertices


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
) -> Tuple[torch.Tensor, int]:
    """Returns (this rank's PageRank scores (vp,) f32, iterations).

    personalization: (vertex_ids, values), the same on every rank; nstart:
    a global (V,) start vector. The loop runs while the global L1 change
    exceeds V * tol; each iteration is one ``per_v_incoming_sorted``, so
    one ``spmv_sum`` launch on a card."""
    v = mgg.num_vertices
    gid, vmask = _local_ids(mesh, mgg)
    dev = mesh.device
    out_wsum = mg_out_weight_sums(mesh, mgg)
    dangling = vmask & (out_wsum <= 0)
    inv_out = torch.where(out_wsum > 0, 1.0 / out_wsum.clamp(min=1e-30), 0.0)
    if personalization is not None:
        ids = as_tensor(personalization[0], torch.int64, dev).reshape(-1)
        vals = as_tensor(personalization[1], WEIGHT_DTYPE, dev).reshape(-1)
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
        agg = mg_prims.per_v_incoming_sorted(mesh, mgg, pr * inv_out)
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
    min-plus sweep, ``per_v_incoming_sorted_min`` (``spmv_minplus`` on a
    card): x = global id on the frontier, +inf elsewhere, so y is finite
    where a frontier in-neighbour exists and is then the smallest one,
    the predecessor. Above that, the frontier push with the same rule."""
    v = mgg.num_vertices
    sources = as_tensor(sources, torch.int64, mesh.device).reshape(-1)
    expects(bool(((sources >= 0) & (sources < v)).all()), "source vertex out of range")
    src_mask = torch.zeros(v, dtype=torch.bool, device=mesh.device)
    src_mask[sources] = True
    frontier = shard_vertex_values(mesh, mgg, src_mask)
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
            x = torch.where(frontier, gidf, float("inf"))
            y = mg_prims.per_v_incoming_sorted_min(mesh, mgg, x)
            touched = torch.isfinite(y)
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
