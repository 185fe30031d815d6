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

from ..core.csr import CompressedAdj, _build_adj
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


def per_v_incoming_sorted(
    mesh: Mesh2D,
    mgg: MGGraph,
    msg: torch.Tensor,
    *,
    use_weights: bool = True,
    gather_mode: str = "all_gather",
) -> torch.Tensor:
    """y[d] = sum over the in-edges of d of w * msg[s] (w = 1 without
    ``use_weights``), for this rank's range: ``spmv_sum`` over the rank's
    ``in_block`` on the gathered column span, then the merge over
    ``col_group``. The JAX package runs this on per-device sorted Benes
    layouts (``_sorted_spmv_jit``); the port has no sorted layout, and the
    name marks the counterpart. ``gather_mode="ring"`` never holds the
    column span (``_incoming_sum_ring``)."""
    if gather_mode == "ring":
        y = _incoming_sum_ring(mesh, mgg, msg, use_weights)
    elif gather_mode == "all_gather":
        y = spmv_sum(mgg.in_block, gather_src_values(mesh, msg), use_weights=use_weights)
    else:
        raise ValueError(f"unknown gather_mode {gather_mode!r}")
    return _merge_dst_partials(mesh, y, PLUS)


def _ring_blocks(mgg: MGGraph) -> Tuple[CompressedAdj, ...]:
    """``in_block`` split by src-row group, once a graph (kept in its
    cache): sub-block k holds the edges whose src lies in span slice k,
    [k*vp, (k+1)*vp), with minors local to that slice; each keeps the
    C*vp majors. One row: ``in_block`` itself."""
    blocks = mgg.cache.get("ring_blocks")
    if blocks is None:
        blk, vp = mgg.in_block, mgg.vp
        if mgg.rows == 1:
            blocks = (blk,)
        else:
            group = blk.minors // vp
            blocks = tuple(
                _build_adj(blk.majors[group == k], blk.minors[group == k] - k * vp,
                           None if blk.weights is None else blk.weights[group == k],
                           blk.num_majors, vp)
                for k in range(mgg.rows))
        mgg.cache["ring_blocks"] = blocks
    return blocks


def _incoming_sum_ring(mesh: Mesh2D, mgg: MGGraph, msg: torch.Tensor, use_weights: bool):
    """The (C*vp,) block partials of ``per_v_incoming_sorted`` over a ring
    on ``row_group`` (JAX ``_incoming_e_ring``, mg_prims.py:457-522): step
    t holds the (vp,) chunk of mesh row k = (i + t) mod R, runs
    ``spmv_sum`` over sub-block k and accumulates, then passes the chunk
    to row i - 1 and takes row i + 1's (``batch_isend_irecv``). Peak
    src-side memory is two (vp,) chunks, not the R*vp column span."""
    blocks = _ring_blocks(mgg)
    r, c = mesh.rows, mesh.cols
    chunk = msg.contiguous()
    acc = spmv_sum(blocks[mesh.i], chunk, use_weights=use_weights)
    send_to = ((mesh.i - 1) % r) * c + mesh.j  # global ranks of the neighbours
    recv_from = ((mesh.i + 1) % r) * c + mesh.j
    for t in range(1, r):
        nxt = torch.empty_like(chunk)
        ops = [dist.P2POp(dist.isend, chunk, send_to, group=mesh.row_group),
               dist.P2POp(dist.irecv, nxt, recv_from, group=mesh.row_group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        chunk = nxt
        acc = acc + spmv_sum(blocks[(mesh.i + t) % r], chunk, use_weights=use_weights)
    return acc


def per_v_incoming_sorted_min(
    mesh: Mesh2D, mgg: MGGraph, msg: torch.Tensor, *, use_weights: bool = False
) -> torch.Tensor:
    """y[d] = min over the in-edges of d of msg[s] (+ w with
    ``use_weights``), +inf where there is none: ``spmv_minplus`` over the
    rank's ``in_block``, then a MIN merge over ``col_group``. Unweighted
    it is the BFS sweep; weighted, the SSSP relaxation. Counterpart of the
    JAX package's min-plus sorted layouts; the port has none."""
    y = spmv_minplus(mgg.in_block, gather_src_values(mesh, msg), use_weights=use_weights)
    return _merge_dst_partials(mesh, y, MINIMUM)


def per_v_outgoing_sorted(
    mesh: Mesh2D, mgg: MGGraph, msg: torch.Tensor, *, use_weights: bool = True
) -> torch.Tensor:
    """y[s] = sum over the out-edges of s of w * msg[d] (w = 1 without
    ``use_weights``), for this rank's range: ``spmv_sum`` over the rank's
    ``out_block`` on the gathered dst ranges of its blocks, then the merge
    over ``row_group`` (HITS' hub step). It computes the function of the
    JAX package's ``per_v_outgoing_sorted`` (transposed sorted layouts)."""
    x_blocks = gather_dst_values(mesh, msg)
    y = spmv_sum(mgg.out_block, x_blocks.reshape((-1,) + tuple(x_blocks.shape[2:])),
                 use_weights=use_weights)
    return _merge_src_partials(mesh, y, PLUS)


def per_v_outgoing_sorted_min(
    mesh: Mesh2D, mgg: MGGraph, msg: torch.Tensor, *, use_weights: bool = False
) -> torch.Tensor:
    """y[s] = min over the out-edges of s of msg[d] (+ w with
    ``use_weights``), +inf where there is none, for this rank's range:
    ``spmv_minplus`` over the rank's ``out_block`` on the gathered dst
    ranges, then a MIN merge over ``row_group`` (JAX mg_prims.py:656,
    mg_wcc's "up" sweep). The twin of ``per_v_outgoing_sorted``."""
    x_blocks = gather_dst_values(mesh, msg)
    y = spmv_minplus(mgg.out_block, x_blocks.reshape(-1), use_weights=use_weights)
    return _merge_src_partials(mesh, y, MINIMUM)


def frontier_push_by_dst_sorted(
    mesh: Mesh2D,
    mgg: MGGraph,
    frontier_local: torch.Tensor,
    values_local: torch.Tensor,
    *,
    use_weights: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frontier push for keep = "src in the frontier", payload = the
    src's f32 value (+ w with ``use_weights``) reduced by MIN (JAX
    mg_prims.py:676): x = the value on the frontier, +inf off it, one
    ``per_v_incoming_sorted_min``; touched is where the result is finite.
    Returns (touched (vp,) bool, reduced (vp,) f32)."""
    x = torch.where(frontier_local, values_local.to(torch.float32), float("inf"))
    reduced = per_v_incoming_sorted_min(mesh, mgg, x, use_weights=use_weights)
    return torch.isfinite(reduced), reduced


def _block_spmm(adj, x: torch.Tensor) -> torch.Tensor:
    return spmm_rows(adj, x, precision="bf16", use_weights=False)


class MGSpmmFunction(torch.autograd.Function):
    """The rank's share of Y = A X over the 2D partition, differentiable in
    X. Forward: all-gather X over ``row_group`` (the column span, R*vp
    rows), ``spmm_rows`` over ``in_block``, reduce-scatter (SUM) over
    ``col_group``. Backward, each step's adjoint in reverse order:
    all-gather dY over ``col_group`` (the C dst ranges of the blocks, C*vp
    rows), ``spmm_rows`` over ``out_block`` (the same edges keyed by their
    span src), reduce-scatter (SUM) over ``row_group``. The adjoints line
    up because ``all_gather_rows`` concatenates in group-rank order and
    ``reduce_scatter_rows`` hands slice k to group rank k, the order of the
    span index (i*vp + k) and of the block index (b*vp + k). Both products
    take the bf16 contract (operands rounded to bf16, f32 sums), as
    ``SpmmRowsFunction`` does on one device; weights get no gradient."""

    @staticmethod
    def forward(ctx, x, mesh, mgg):
        ctx.mesh, ctx.mgg = mesh, mgg
        y = _block_spmm(mgg.in_block, gather_src_values(mesh, x))
        return _merge_dst_partials(mesh, y, PLUS)

    @staticmethod
    def backward(ctx, dy):
        mesh, mgg = ctx.mesh, ctx.mgg
        dy_blocks = all_gather_rows(dy.contiguous(), mesh.col_group)
        dx_span = _block_spmm(mgg.out_block, dy_blocks)
        return _merge_src_partials(mesh, dx_span, PLUS), None, None


def per_v_incoming_sorted_spmm(mesh: Mesh2D, mgg: MGGraph, feats: torch.Tensor) -> torch.Tensor:
    """(vp, F) feature sums over in-edges, edge weights ignored, operands
    rounded to bf16 and sums taken in f32: ``spmm_rows`` in "bf16" mode
    over the rank's (C*vp x R*vp) ``in_block`` on the gathered (R*vp, F)
    column span, then the merge over ``col_group``. It computes the
    function of the JAX package's multi-stream bf16-pair pipeline
    (``spmv2.py`` ``_expand_multi_call``, ``_slab_benes_multi_call``,
    ``_sort_reduce_multi_call``); the port has no sorted layout, and the
    name marks the counterpart. Differentiable in ``feats``
    (``MGSpmmFunction``): its backward runs ``spmm_rows`` over the rank's
    ``out_block``; every rank must then run the backward, as it ran the
    forward."""
    y = MGSpmmFunction.apply(feats.to(torch.float32), mesh, mgg)
    return y.to(feats.dtype)


# ---------------------------------------------------------------------------
# Keyed exchanges to each vertex's owner (JAX mg_prims.py:117-349; ref
# shuffle_comm.cuh, collect_comm.cuh)
# ---------------------------------------------------------------------------


def _bucket_by(dest: torch.Tensor, valid: torch.Tensor, n_buckets: int, capacity: int):
    """Items grouped into ``n_buckets`` buckets of ``capacity`` slots by
    destination, in item order within a bucket. Returns (slot (n,) int64 =
    dest * capacity + rank in its bucket, kept (n,) bool, counts
    (n_buckets,)): items past a bucket's capacity are dropped (kept False)
    and still counted, for the overflow check."""
    n = dest.numel()
    d = torch.where(valid, dest.to(torch.int64), n_buckets)  # invalid -> discard bucket
    order = torch.sort(d, stable=True).indices
    counts_all = torch.bincount(d, minlength=n_buckets + 1)
    start = torch.cumsum(counts_all, 0) - counts_all
    rank = torch.empty(n, dtype=torch.int64, device=dest.device)
    rank[order] = torch.arange(n, device=dest.device) - start[d[order]]
    kept = valid & (rank < capacity)
    slot = torch.where(kept, d.clamp(max=n_buckets - 1) * capacity + rank, 0)
    return slot, kept, counts_all[:n_buckets]


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Equal-split all-to-all along dim 0 over ``group``: slice k goes to
    group rank k, and slice k of the result came from group rank k. Bools
    travel as uint8."""
    wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def _global_sum(x: torch.Tensor) -> int:
    """An integer summed over every rank, read on the host."""
    x = x.to(torch.int64).reshape(1)
    dist.all_reduce(x)
    return int(x)


def _shuffle_axis(items: dict, dest, valid, group, capacity: int):
    """One bucketed all-to-all over ``group`` (ref shuffle_values,
    shuffle_comm.cuh:679): item i goes to group rank dest[i], at most
    ``capacity`` items a destination. Returns (items received, each
    (P*capacity, ...), valid received, items dropped on this rank)."""
    p = dist.get_world_size(group)
    slot, kept, counts = _bucket_by(dest, valid, p, capacity)
    put = slot[kept]
    sent = {}
    for name, a in items.items():
        buf = torch.zeros((p * capacity,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        buf[put] = a[kept]
        sent[name] = buf
    vbuf = torch.zeros(p * capacity, dtype=torch.bool, device=dest.device)
    vbuf[put] = True
    rx = {name: _all_to_all(a, group) for name, a in sent.items()}
    return rx, _all_to_all(vbuf, group), (counts - capacity).clamp(min=0).sum()


def shuffle_to_vertex_owners(
    mesh: Mesh2D, keys: torch.Tensor, items: dict, valid: torch.Tensor, vp: int, capacity: int
):
    """Route (global vertex key, items) to the key's owner in two bucketed
    all-to-alls, over ``col_group`` to the owner's mesh column, then over
    ``row_group`` to its row (JAX mg_prims.py:185; ref
    groupby_gpu_id_and_shuffle_values, shuffle_comm.cuh:729).

    items: a dict of (n, ...) tensors. capacity is per bucket and stage,
    as in the JAX package: items past it are dropped and counted. Returns
    (keys (R*C*capacity,), items, valid, overflow): overflow is the count
    of dropped items summed over every rank, read on the host; a caller
    that sees it > 0 runs again with a larger capacity."""
    r = mesh.rows
    pack = dict(items)
    pack["__key"] = keys
    pack1, valid1, ov1 = _shuffle_axis(pack, (keys // vp) // r, valid, mesh.col_group, capacity)
    pack2, valid2, ov2 = _shuffle_axis(
        pack1, (pack1["__key"] // vp) % r, valid1, mesh.row_group, capacity)
    keys2 = pack2.pop("__key")
    return keys2, pack2, valid2, _global_sum(ov1 + ov2)


def collect_values_for_keys(
    mesh: Mesh2D, keys: torch.Tensor, valid: torch.Tensor, values_local: torch.Tensor,
    vp: int, capacity: int,
):
    """values_local[key] fetched from each key's owner for any global keys
    (JAX mg_prims.py:216; ref collect_values_for_keys, collect_comm.cuh:57):
    the requests go to the owners through ``shuffle_to_vertex_owners``,
    the answers come back by (rank, slot) return address. Returns (values
    (n, ...), found (n,), overflow)."""
    r = mesh.rows
    n = keys.numel()
    dev = keys.device
    me = mesh.j * r + mesh.i  # this rank's range
    k_rx, pack, v_rx, ov = shuffle_to_vertex_owners(
        mesh, keys,
        {"addr": torch.full((n,), me, dtype=torch.int32, device=dev),
         "slot": torch.arange(n, dtype=torch.int32, device=dev)},
        valid, vp, capacity)
    local = k_rx.to(torch.int64) - me * vp
    ok = v_rx & (local >= 0) & (local < vp)
    ans = values_local.index_select(0, local.clamp(0, values_local.shape[0] - 1))
    back = {"val": ans, "slot": pack["slot"], "addr": pack["addr"]}
    b1, bv1, ov3 = _shuffle_axis(back, pack["addr"] // r, ok, mesh.col_group, capacity)
    b2, bv2, ov4 = _shuffle_axis(b1, b1["addr"] % r, bv1, mesh.row_group, capacity)
    slot = b2["slot"].to(torch.int64)[bv2]
    out = torch.zeros((n,) + tuple(values_local.shape[1:]), dtype=values_local.dtype, device=dev)
    out[slot] = b2["val"][bv2]
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    found[slot] = True
    return out, found, ov + _global_sum(ov3 + ov4)


def collect_values_for_unique_keys(
    mesh: Mesh2D, keys: torch.Tensor, valid: torch.Tensor, values_local: torch.Tensor,
    vp: int, capacity: int,
):
    """``collect_values_for_keys`` asking for each distinct key once a rank
    (JAX mg_prims.py:268; ref collect_comm.cuh:187), so a popular key's
    owner gets at most one request a rank. Returns (values, found,
    overflow)."""
    n = keys.numel()
    dev = keys.device
    big = 1 << 30
    k = torch.where(valid, keys.to(torch.int64), big)
    k_s, order = torch.sort(k, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = k_s[1:] != k_s[:-1]
    vals_u, found_u, ov = collect_values_for_keys(
        mesh, torch.where(first, k_s, 0), first & (k_s < big), values_local, vp, capacity)
    # the answer sits at each run's first slot; spread it down the run
    pos = torch.arange(n, device=dev)
    first_pos = torch.cummax(torch.where(first, pos, 0), 0).values
    out = torch.empty((n,) + tuple(values_local.shape[1:]), dtype=values_local.dtype, device=dev)
    out[order] = vals_u[first_pos]
    found = torch.empty(n, dtype=torch.bool, device=dev)
    found[order] = found_u[first_pos]
    return out, found & valid, ov


def cluster_weight_sums(
    mesh: Mesh2D, labels: torch.Tensor, k_local: torch.Tensor, vmask: torch.Tensor,
    vp: int, capacity: int,
):
    """sigma[c] = sum of k over the vertices labelled c, held by c's owner
    (cluster ids are vertex ids; JAX mg_prims.py:306, the keyed store of
    the reference's per_v_transform_reduce_dst_key_aggregated_outgoing_e).
    Each rank sums its own (label, k) runs first, so it sends at most one
    item a distinct label. Returns (sigma_own (vp,), overflow)."""
    n = labels.numel()
    dev = labels.device
    big = 1 << 30
    lab = torch.where(vmask, labels.to(torch.int64), big)
    l_s, order = torch.sort(lab, stable=True)
    k_s = torch.where(vmask, k_local, 0.0)[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = l_s[1:] != l_s[:-1]
    rid = torch.cumsum(first.to(torch.int64), 0) - 1
    agg = torch.zeros(n, dtype=k_local.dtype, device=dev).index_add_(0, rid, k_s)
    run_k = agg[rid] * first
    keys_rx, pack, v_rx, ov = shuffle_to_vertex_owners(
        mesh, l_s, {"k": run_k}, first & (l_s < big), vp, capacity)
    local = keys_rx - (mesh.j * mesh.rows + mesh.i) * vp
    ok = v_rx & (local >= 0) & (local < vp)
    sigma = torch.zeros(vp, dtype=k_local.dtype, device=dev)
    sigma.index_add_(0, local[ok], pack["k"][ok])
    return sigma, ov


def dcsr_lookup(nzd: torch.Tensor, nzd_offsets: torch.Tensor, local_ids: torch.Tensor):
    """Hypersparse (DCSR) adjacency lookup (JAX mg_prims.py:351; ref the
    use_dcs() path, major_hypersparse_idx_from_major,
    edge_partition_device_view.cuh:44-79): (lo, deg) int64 for span-local
    src ids, by a binary search of the sorted sources ``nzd``. A source
    absent from ``nzd`` has deg 0, and lo the offset where it would sit."""
    ids = local_ids.to(nzd.dtype)
    pos = torch.searchsorted(nzd, ids)
    lo = nzd_offsets[pos].to(torch.int64)
    if nzd.numel() == 0:
        return lo, torch.zeros_like(lo)
    found = nzd[pos.clamp(max=nzd.numel() - 1)] == ids
    deg = torch.where(found, nzd_offsets[(pos + 1).clamp(max=nzd.numel())].to(torch.int64) - lo, 0)
    return lo, deg
