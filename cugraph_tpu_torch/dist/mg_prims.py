"""Distributed prims: what each rank computes over its blocks, and the
collectives that join the ranks.

Counterpart of ``cugraph_tpu/dist/mg_prims.py``. Where the JAX package
runs these inside ``shard_map`` and names a mesh axis, each rank here
calls them on its own tensors with its ``Mesh2D`` (ref comm mapping,
SURVEY.md §2.3):

- the reference's device_bcast over col_comm -> all-gather over
  ``mesh.row_group`` (the src-side values of the column span);
- its device_reduce to the owner rank -> reduce-scatter over
  ``mesh.col_group`` (each rank keeps its own range's merged values);
- its host scalar allreduce -> all-reduce over the world.

Local shapes: vertex values (vp, ...); per-block dst partials (C * vp,
...), indexed by the ``in_block`` major b * vp + local dst. The e_op
signature is the single-device prims' (global src and dst ids, gathered
values, weights), so the algorithm bodies read the same.

The generic prims are plain torch. The kernel-backed prims keep the JAX
package's names (``per_v_incoming_sorted*``) so that a reader finds each
counterpart; the port has no sorted layout, and each runs one of its
kernels over the rank's ``in_block``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from ..prims.cuda import spmm_rows, spmv_minplus, spmv_sum
from ..prims.reduce_ops import MINIMUM, PLUS, ReduceOp
from .mesh import Mesh2D, all_gather_rows, reduce_scatter_rows
from .mg_graph import MGGraph

_DIST_OP = {"sum": dist.ReduceOp.SUM, "amin": dist.ReduceOp.MIN, "amax": dist.ReduceOp.MAX}


def gather_src_values(mesh: Mesh2D, values_local: Optional[torch.Tensor]):
    """Local (vp, ...) vertex values -> the column span's (R*vp, ...): an
    all-gather over ``row_group`` (group rank i holds range j*R + i)."""
    if values_local is None:
        return None
    return all_gather_rows(values_local, mesh.row_group)


def gather_dst_values(mesh: Mesh2D, values_local: Optional[torch.Tensor]):
    """Local (vp, ...) -> (C, vp, ...): the dst range of each block. Block
    b's range, b*R + i, is owned by rank (i, b), group rank b of
    ``col_group``."""
    if values_local is None:
        return None
    out = all_gather_rows(values_local, mesh.col_group)
    return out.view((mesh.cols,) + tuple(values_local.shape))


def _merge_dst_partials(mesh: Mesh2D, partials: torch.Tensor, reduce_op: ReduceOp):
    """(C*vp, ...) per-block partials -> (vp, ...) for this rank's own
    range: a reduce-scatter over ``col_group`` hands block b to group rank
    b. Sum, min and max alike: torch reduce-scatters each."""
    return reduce_scatter_rows(partials, _DIST_OP[reduce_op.scatter], mesh.col_group)


def _merge_src_partials(mesh: Mesh2D, partials: torch.Tensor, reduce_op: ReduceOp):
    """(R*vp, ...) column-span partials -> (vp, ...) for this rank's own
    range: a reduce-scatter over ``row_group`` (group rank i keeps span
    slice i, range j*R + i)."""
    return reduce_scatter_rows(partials, _DIST_OP[reduce_op.scatter], mesh.row_group)


def transform_reduce_v(mesh: Mesh2D, values_local: torch.Tensor) -> torch.Tensor:
    """Global sum of per-vertex values, a 0-d tensor on every rank (an
    all-reduce over the world; the JAX package psums over both axes)."""
    total = values_local.sum(0)
    dist.all_reduce(total)
    return total


def _global_edge_ids(mesh: Mesh2D, mgg: MGGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (src, dst) ids of the ``in_block`` edges, in its order."""
    blk, vp, r = mgg.in_block, mgg.vp, mgg.rows
    src = blk.minors + mesh.j * r * vp
    dst = (blk.majors // vp * r + mesh.i) * vp + blk.majors % vp
    return src, dst


def _edge_values(mesh, mgg, e_op, src_values, dst_values):
    blk = mgg.in_block
    src_g, dst_g = _global_edge_ids(mesh, mgg)
    sv = dv = None
    if src_values is not None:
        sv = gather_src_values(mesh, src_values).index_select(0, blk.minors)
    if dst_values is not None:
        blocks = gather_dst_values(mesh, dst_values)
        dv = blocks.reshape((-1,) + tuple(blocks.shape[2:])).index_select(0, blk.majors)
    return e_op(src_g, dst_g, sv, dv, blk.weights)


def per_v_transform_reduce_incoming_e(
    mesh: Mesh2D,
    mgg: MGGraph,
    e_op: Callable,
    *,
    reduce_op: ReduceOp = PLUS,
    src_values: Optional[torch.Tensor] = None,
    dst_values: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MG pull-reduce: (vp, ...) values for this rank's own range (ref
    per_v_transform_reduce_incoming_outgoing_e.cuh :915-966, the JAX
    package's "all_gather" mode): the e_op over the local edges, reduced
    by block dst, then merged over ``col_group``."""
    e_vals = _edge_values(mesh, mgg, e_op, src_values, dst_values)
    blk = mgg.in_block
    partials = reduce_op.segment(e_vals, blk.majors, blk.num_majors)
    return _merge_dst_partials(mesh, partials, reduce_op)


def per_v_transform_reduce_outgoing_e(
    mesh: Mesh2D,
    mgg: MGGraph,
    e_op: Callable,
    *,
    reduce_op: ReduceOp = PLUS,
    src_values: Optional[torch.Tensor] = None,
    dst_values: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MG push-reduce (reduce by src, ref :972-1037): partials over the
    column span, merged over ``row_group``."""
    e_vals = _edge_values(mesh, mgg, e_op, src_values, dst_values)
    blk = mgg.in_block
    partials = reduce_op.segment(e_vals, blk.minors, blk.num_minors)
    return _merge_src_partials(mesh, partials, reduce_op)


def frontier_push_by_dst(
    mesh: Mesh2D,
    mgg: MGGraph,
    frontier_local: torch.Tensor,
    e_op: Callable,
    *,
    reduce_op: ReduceOp,
    src_values: Optional[torch.Tensor] = None,
    dst_values: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MG frontier push (ref transform_reduce_v_frontier_outgoing_e_by_dst:
    frontier bcast over col_comm :254, shuffle to the dst owner :437-449):
    the frontier mask is gathered over ``row_group``, the kept payloads are
    reduced by block dst and merged over ``col_group``. e_op returns
    (keep, payload). Returns (touched (vp,) bool, reduced (vp, ...))."""
    blk = mgg.in_block
    active = gather_src_values(mesh, frontier_local).index_select(0, blk.minors)
    keep, payload = _edge_values(mesh, mgg, e_op, src_values, dst_values)
    keep = keep & active
    majors = blk.majors[keep]
    reduced = _merge_dst_partials(
        mesh, reduce_op.segment(payload[keep], majors, blk.num_majors), reduce_op)
    hits = torch.zeros(blk.num_majors, dtype=torch.int32, device=majors.device)
    hits.index_add_(0, majors, torch.ones_like(majors))
    touched = _merge_dst_partials(mesh, hits, PLUS) > 0
    return touched, reduced


def per_v_incoming_sorted(mesh: Mesh2D, mgg: MGGraph, msg: torch.Tensor) -> torch.Tensor:
    """y[d] = sum over the in-edges of d of w * msg[s], for this rank's
    range: ``spmv_sum`` over the rank's ``in_block`` on the gathered column
    span, then the merge over ``col_group``. The JAX package runs this on
    per-device sorted Benes layouts (``_sorted_spmv_jit``); the port has
    no sorted layout, and the name marks the counterpart."""
    y = spmv_sum(mgg.in_block, gather_src_values(mesh, msg))
    return _merge_dst_partials(mesh, y, PLUS)


def per_v_incoming_sorted_min(mesh: Mesh2D, mgg: MGGraph, msg: torch.Tensor) -> torch.Tensor:
    """y[d] = min over the in-edges of d of msg[s], +inf where there is
    none (edge weights ignored, the BFS sweep): unweighted
    ``spmv_minplus`` over the rank's ``in_block``, then a MIN merge over
    ``col_group``. Counterpart of the JAX package's min-plus sorted
    layouts; the port has none."""
    y = spmv_minplus(mgg.in_block, gather_src_values(mesh, msg), use_weights=False)
    return _merge_dst_partials(mesh, y, MINIMUM)


def per_v_incoming_sorted_spmm(mesh: Mesh2D, mgg: MGGraph, feats: torch.Tensor) -> torch.Tensor:
    """(vp, F) feature sums over in-edges, edge weights ignored, operands
    rounded to bf16 and sums taken in f32: ``spmm_rows`` in "bf16" mode
    over the rank's (C*vp x R*vp) ``in_block`` on the gathered (R*vp, F)
    column span, then the merge over ``col_group``. It computes the
    function of the JAX package's multi-stream bf16-pair pipeline
    (``spmv2.py`` ``_expand_multi_call``, ``_slab_benes_multi_call``,
    ``_sort_reduce_multi_call``); the port has no sorted layout, and the
    name marks the counterpart. It has no backward yet: it raises when
    ``feats`` asks for a gradient, which would otherwise be lost."""
    if torch.is_grad_enabled() and feats.requires_grad:
        raise NotImplementedError(
            "per_v_incoming_sorted_spmm has no backward: run it under torch.no_grad()"
        )
    x_span = gather_src_values(mesh, feats.to(torch.float32))
    y = spmm_rows(mgg.in_block, x_span, precision="bf16", use_weights=False)
    return _merge_dst_partials(mesh, y, PLUS).to(feats.dtype)
