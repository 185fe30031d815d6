"""Distributed Louvain, Leiden and modularity over the 2D partition.

Counterpart of ``cugraph_tpu/dist/mg_community.py`` (ref: the MG
instantiation of cpp/src/community/louvain_impl.cuh and leiden_impl.cuh).

- The local-moving sweep runs on every rank's edges: each rank keys its
  edges by (src, label of dst), the edges of one mesh column (all its
  srcs' out-edges) meet on each of its ranks by a gather over
  ``row_group``, and the same scores, up/down rule and tie-break as the
  single-device sweep pick each src's move; a rank keeps its own slice.
- Cluster weights (Sigma) are either a dense (R*C*vp,) vector summed over
  the world ("dense") or held by each cluster id's owner and fetched by
  the keyed exchanges ``cluster_weight_sums`` and
  ``collect_values_for_unique_keys`` ("hypersparse", memory O(vp) a
  rank); "auto" takes the second past 2^22 vertex slots, as in JAX.
- Between levels each rank relabels its own edges to the compacted
  cluster ids (``mg_coarsen_edge_chunks``), and the coarse graph is
  ingested from those chunks, each broadcast from its rank in turn
  (``distribute_edgelist_chunks``). Only O(V) label vectors are gathered
  between levels; parallel coarse edges stay, as in JAX.

Differences by design: labels come back as a (V,) tensor on the mesh's
device, the same on every rank (the JAX package returns numpy), and
``mg_decompress_to_edgelist`` returns every rank's edges as device
tensors on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.dtypes import VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects
from . import mg_prims
from .mesh import Mesh2D, all_gather_rows
from .mg_algos import _local_ids
from .mg_graph import MGGraph, distribute_edgelist_chunks, shard_vertex_values, unshard_vertex_values

HYPERSPARSE_MIN_SLOTS = 1 << 22  # "auto" holds Sigma with the owners past this


def _all_gather_varlen(t: torch.Tensor, group) -> torch.Tensor:
    """Every group member's 1-D ``t``, of any length, concatenated in
    group-rank order."""
    n = torch.tensor([t.numel()], dtype=torch.int64, device=t.device)
    sizes = all_gather_rows(n, group).tolist()
    padded = torch.zeros(max(max(sizes), 1), dtype=t.dtype, device=t.device)
    padded[: t.numel()] = t
    everyone = all_gather_rows(padded, group).view(len(sizes), -1)
    return torch.cat([everyone[k, :s] for k, s in enumerate(sizes)])


def mg_decompress_to_edgelist(mesh: Mesh2D, mgg: MGGraph):
    """Every rank's edges with global ids, (src, dst, weight or None) int32
    / f32 tensors on the mesh's device, the same on every rank (rank
    order, each rank's edges in its ``in_block`` order)."""
    src, dst = mg_prims._global_edge_ids(mesh, mgg)
    out = [_all_gather_varlen(t.to(VERTEX_DTYPE), None) for t in (src, dst)]
    w = mgg.in_block.weights
    return out[0], out[1], None if w is None else _all_gather_varlen(w, None)


def _out_weights(mesh: Mesh2D, mgg: MGGraph) -> torch.Tensor:
    """Per-vertex out weight sums (vp,) by the generic push prim, as the
    JAX package's k_op."""
    return mg_prims.per_v_transform_reduce_outgoing_e(
        mesh, mgg, lambda s, d, sv, dv, w: torch.ones_like(s, dtype=WEIGHT_DTYPE) if w is None else w)


def _modularity(mesh: Mesh2D, mgg: MGGraph, k_local: torch.Tensor, labels_global: torch.Tensor,
                resolution: float) -> float:
    """Q of global labels (any integers): intra from each rank's edges,
    summed over the world; Sigma over the labels compacted to [0,
    clusters), from the gathered (V,) weights."""
    v = mgg.num_vertices
    _, compact = torch.unique(labels_global.to(torch.int64), return_inverse=True)
    lab_local = shard_vertex_values(mesh, mgg, compact)
    m2 = mg_prims.transform_reduce_v(mesh, k_local).clamp(min=1e-30)

    def intra_op(s, d, sv, dv, w):
        same = (sv == dv).to(WEIGHT_DTYPE)
        return same if w is None else same * w

    intra = mg_prims._edge_values(mesh, mgg, intra_op, lab_local, lab_local).sum()
    dist.all_reduce(intra)
    k_global = unshard_vertex_values(mgg, k_local)
    sigma = torch.zeros(int(compact.max()) + 1 if v else 0, dtype=WEIGHT_DTYPE,
                        device=k_local.device).index_add_(0, compact, k_global)
    return float(intra / m2 - resolution * ((sigma / m2) ** 2).sum())


def mg_modularity(mesh: Mesh2D, mgg: MGGraph, labels_local, resolution: float = 1.0) -> float:
    """Modularity of a labelling given as this rank's (vp,) slice (any
    integer labels, as the single-device ``modularity``). Every rank
    calls it and gets the same Q."""
    expects(mgg.is_symmetric, "modularity requires a symmetric graph")
    labels_local = torch.as_tensor(labels_local, device=resolve_device(mesh.device))
    return _modularity(mesh, mgg, _out_weights(mesh, mgg),
                       unshard_vertex_values(mgg, labels_local), resolution)


def _one_level(
    mesh: Mesh2D,
    mgg: MGGraph,
    resolution: float,
    max_sweeps: int,
    cluster_state: str = "auto",
    state_capacity: int = 0,
    labels0: Optional[torch.Tensor] = None,
    constraint: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int, int]:
    """The local-moving phase (JAX ``_mg_louvain_one_level``, :121-367).
    Returns (this rank's (vp,) int32 labels, global cluster ids; total
    moves; shuffle overflow).

    Score of vertex u joining cluster c (terms constant in u dropped):
    w_{u->c\\{u}} - resolution * k_u * Sigma_{c\\{u}} / m2; u moves to the
    best c, the smallest id among ties, if that beats staying by more
    than 1e-9. Even sweeps allow only moves to larger labels, odd ones
    only to smaller; sweeps run in pairs until a pair moves nothing or
    ``max_sweeps`` have run. labels0: this rank's starting labels
    (default: singletons). constraint: this rank's parent community per
    vertex, which moves must stay within (Leiden's refinement).
    state_capacity: the keyed exchanges' bucket capacity (0: the JAX
    default, max(vp, 8 R C, 256))."""
    r, c, vp = mgg.rows, mgg.cols, mgg.vp
    span, vtot = r * vp, r * c * vp
    if cluster_state == "auto":
        cluster_state = "hypersparse" if vtot > HYPERSPARSE_MIN_SLOTS else "dense"
    expects(cluster_state in ("dense", "hypersparse"), f"unknown cluster_state {cluster_state!r}")
    hyper = cluster_state == "hypersparse"
    cap = int(state_capacity) or max(vp, 8 * r * c, 256)
    gid, vmask = _local_ids(mesh, mgg)
    dev = gid.device
    blk = mgg.in_block
    majors, minors = blk.majors.to(torch.int64), blk.minors.to(torch.int64)
    ew = blk.weights if blk.weights is not None else torch.ones(
        blk.num_edges, dtype=WEIGHT_DTYPE, device=dev)

    k_local = _out_weights(mesh, mgg)
    m2 = mg_prims.transform_reduce_v(mesh, k_local).clamp(min=1e-30)
    k_span = mg_prims.gather_src_values(mesh, k_local)
    src_g, dst_g = mg_prims._global_edge_ids(mesh, mgg)
    selfw_span = torch.zeros(span, dtype=WEIGHT_DTYPE, device=dev).index_add_(
        0, minors, torch.where(src_g == dst_g, ew, 0.0))
    dist.all_reduce(selfw_span, group=mesh.row_group)
    con_full = con_span = None
    if constraint is not None:
        con_span = mg_prims.gather_src_values(mesh, constraint)
        con_full = all_gather_rows(con_span, mesh.col_group)  # (vtot,), global id order
    # the column's edges, (span-local src) and weight, gathered once
    s_col = _all_gather_varlen(minors, mesh.row_group)
    w_col = _all_gather_varlen(ew, mesh.row_group)
    neg_inf = torch.tensor(float("-inf"), dtype=WEIGHT_DTYPE, device=dev)

    def sweep(labels: torch.Tensor, it: int):
        overflow = 0
        key = mg_prims.gather_dst_values(mesh, labels).reshape(-1)[majors].to(torch.int64)
        if hyper:
            sigma_own, ov1 = mg_prims.cluster_weight_sums(mesh, labels, k_local, vmask, vp, cap)
            sig_mine, _, ov2 = mg_prims.collect_values_for_unique_keys(
                mesh, labels, vmask, sigma_own, vp, cap)
            overflow = ov1 + ov2
            sig_e = mg_prims.gather_dst_values(mesh, sig_mine).reshape(-1)[majors]
            sig_span = mg_prims.gather_src_values(mesh, sig_mine)
            sig_col = _all_gather_varlen(sig_e, mesh.row_group)
        else:
            sigma = torch.zeros(vtot, dtype=WEIGHT_DTYPE, device=dev).index_add_(
                0, labels.to(torch.int64), k_local)
            dist.all_reduce(sigma)
        key_col = _all_gather_varlen(key, mesh.row_group)
        # (src, key) runs of the column: their weight sums
        runs, run_of = torch.unique(s_col * vtot + key_col, return_inverse=True)
        w_run = torch.zeros(runs.numel(), dtype=WEIGHT_DTYPE, device=dev).index_add_(
            0, run_of, w_col)
        s4, k4 = runs // vtot, runs % vtot
        lab_span = mg_prims.gather_src_values(mesh, labels).to(torch.int64)
        lv, kv = lab_span[s4], k_span[s4]
        own = k4 == lv
        if hyper:
            sig_k4 = torch.empty(runs.numel(), dtype=WEIGHT_DTYPE, device=dev)
            sig_k4[run_of] = sig_col
            sig_lab_span = sig_span
        else:
            sig_k4, sig_lab_span = sigma[k4], sigma[lab_span]
        sig_c = sig_k4 - torch.where(own, kv, 0.0)
        w_adj = w_run - torch.where(own, selfw_span[s4], 0.0)
        score = w_adj - resolution * kv * sig_c / m2
        allowed = ~own & ((k4 > lv) if it % 2 == 0 else (k4 < lv))
        if con_full is not None:
            allowed &= con_full[k4] == con_span[s4]
        best = torch.full((span,), float("-inf"), dtype=WEIGHT_DTYPE, device=dev)
        best.scatter_reduce_(0, s4, torch.where(allowed, score, neg_inf), "amax")
        at_best = allowed & (score >= best[s4])
        best_key = torch.full((span,), vtot, dtype=torch.int64, device=dev)
        best_key.scatter_reduce_(0, s4, torch.where(at_best, k4, vtot), "amin")
        own_w = torch.zeros(span, dtype=WEIGHT_DTYPE, device=dev).index_add_(
            0, s4, torch.where(own, w_adj, 0.0))
        score_own = own_w - resolution * k_span * (sig_lab_span - k_span) / m2
        do_move = (best > score_own + 1e-9) & (best_key < vtot)
        new_span = torch.where(do_move, best_key, lab_span).to(VERTEX_DTYPE)
        new_local = new_span[mesh.i * vp:(mesh.i + 1) * vp]
        return new_local, (new_local != labels).to(torch.int32).sum(), overflow

    labels = gid.to(VERTEX_DTYPE) if labels0 is None else labels0.to(VERTEX_DTYPE)
    last_pair, total, overflow, it = 1, 0, 0, 0
    while last_pair > 0 and it < max_sweeps:
        labels, m1, ov1 = sweep(labels, it)
        labels, m2_, ov2 = sweep(labels, it + 1)
        moved = m1 + m2_
        dist.all_reduce(moved)
        last_pair = int(moved)
        total, overflow, it = total + last_pair, overflow + ov1 + ov2, it + 2
    return labels, total, overflow


def mg_coarsen_edge_chunks(mesh: Mesh2D, mgg: MGGraph, labels_local: torch.Tensor,
                           old_to_new: torch.Tensor):
    """Each rank's edges (u, v, w) relabelled to (c(u), c(v), w) with the
    compact cluster map ``old_to_new`` ((R*C*vp,) int32 on every rank)
    and this rank's (vp,) labels. Returns the ChunkSource of
    ``distribute_edgelist_chunks``: a zero-argument callable whose
    iterator yields one chunk a rank, in rank order, each broadcast from
    its rank; every rank must iterate it alike (ref coarsen_graph under
    MG comms, coarsen_graph_impl.cuh)."""
    blk = mgg.in_block
    lab_span = mg_prims.gather_src_values(mesh, labels_local).to(torch.int64)
    lab_blocks = mg_prims.gather_dst_values(mesh, labels_local).reshape(-1).to(torch.int64)
    o2n = old_to_new.to(torch.int64)
    cu = o2n[lab_span[blk.minors.to(torch.int64)]].to(VERTEX_DTYPE)
    cv = o2n[lab_blocks[blk.majors.to(torch.int64)]].to(VERTEX_DTYPE)
    ew = blk.weights if blk.weights is not None else torch.ones(
        blk.num_edges, dtype=WEIGHT_DTYPE, device=cu.device)
    dev = cu.device

    def chunks():
        for rank in range(dist.get_world_size()):
            mine = rank == dist.get_rank()
            n = torch.tensor([cu.numel() if mine else 0], dtype=torch.int64, device=dev)
            dist.broadcast(n, rank)
            out = []
            for t in (cu, cv, ew):
                buf = t if mine else torch.empty(int(n), dtype=t.dtype, device=dev)
                if int(n):
                    dist.broadcast(buf, rank)
                out.append(buf)
            yield tuple(out)

    return chunks


def _coarsen(mesh: Mesh2D, cur: MGGraph, labels_local: torch.Tensor, uniq: torch.Tensor) -> MGGraph:
    """The graph of ``cur`` contracted on its labels, whose distinct
    values (sorted) are ``uniq``."""
    old_to_new = torch.full((cur.rows * cur.cols * cur.vp,), -1, dtype=VERTEX_DTYPE,
                            device=uniq.device)
    old_to_new[uniq.to(torch.int64)] = torch.arange(uniq.numel(), dtype=VERTEX_DTYPE,
                                                    device=uniq.device)
    return distribute_edgelist_chunks(
        mesh, mg_coarsen_edge_chunks(mesh, cur, labels_local, old_to_new),
        num_vertices=int(uniq.numel()), is_symmetric=True)


def mg_louvain(
    mesh: Mesh2D,
    mgg: MGGraph,
    max_level: int = 100,
    resolution: float = 1.0,
    threshold: float = 1e-7,
    cluster_state: str = "auto",
    state_capacity: int = 0,
) -> Tuple[torch.Tensor, float]:
    """Distributed Louvain (JAX mg_algos louvain, mg_community.py:430):
    (labels (V,) int32 in [0, communities) on the mesh's device, the same
    on every rank; modularity). Each level is ``_one_level`` on the
    current graph then its contraction; a level is kept only if it
    raises Q by more than ``threshold``. Raises if a keyed exchange
    overflows (raise ``state_capacity``). ``mg_louvain.levels`` holds the
    last call's count of kept levels."""
    expects(mgg.is_symmetric, "louvain requires a symmetric graph")
    resolve_device(mesh.device)
    k0 = _out_weights(mesh, mgg)
    cur = mgg
    labels_global = torch.arange(mgg.num_vertices, dtype=torch.int64, device=k0.device)
    best_labels = labels_global
    best_q = _modularity(mesh, mgg, k0, labels_global, resolution)
    levels = 0
    for _level in range(max_level):
        labels_l, moves, ovf = _one_level(mesh, cur, resolution, 64, cluster_state, state_capacity)
        expects(ovf == 0, "mg_louvain hypersparse shuffle overflow: raise state_capacity")
        if moves == 0:
            break
        uniq, compact = torch.unique(unshard_vertex_values(cur, labels_l), return_inverse=True)
        cand = compact[labels_global]
        q = _modularity(mesh, mgg, k0, cand, resolution)
        if q <= best_q + threshold:
            break
        best_q, best_labels, labels_global, levels = q, cand, cand, levels + 1
        if uniq.numel() == cur.num_vertices:
            break  # no contraction progress
        cur = _coarsen(mesh, cur, labels_l, uniq)
    mg_louvain.levels = levels
    return best_labels.to(VERTEX_DTYPE), float(best_q)


def mg_leiden(
    mesh: Mesh2D,
    mgg: MGGraph,
    max_level: int = 100,
    resolution: float = 1.0,
    threshold: float = 1e-7,
    cluster_state: str = "auto",
    state_capacity: int = 0,
) -> Tuple[torch.Tensor, float]:
    """Distributed Leiden (JAX mg_community.py:493; ref leiden_impl.cuh):
    (labels (V,) int32 in [0, communities) on the mesh's device;
    modularity). Each level: local moving gives partition P (seeded by the
    previous level's communities); a refinement restarts from singletons
    and moves vertices only within their P community; the graph is
    contracted on the refined partition while P seeds the next level.
    ``mg_leiden.levels`` holds the last call's count of kept levels."""
    expects(mgg.is_symmetric, "leiden requires a symmetric graph")
    resolve_device(mesh.device)
    k0 = _out_weights(mesh, mgg)
    cur = mgg
    refc = torch.arange(mgg.num_vertices, dtype=torch.int64, device=k0.device)  # orig -> cur
    best_labels = refc
    best_q = _modularity(mesh, mgg, k0, refc, resolution)
    labels0, levels = None, 0
    for level in range(max_level):
        l0 = None if labels0 is None else shard_vertex_values(mesh, cur, labels0)
        p_l, moves, ovf = _one_level(mesh, cur, resolution, 64, cluster_state, state_capacity,
                                     labels0=l0)
        expects(ovf == 0, "mg_leiden hypersparse shuffle overflow: raise state_capacity")
        if moves == 0 and level > 0:
            break
        r_l, _, ovf2 = _one_level(mesh, cur, resolution, 32, cluster_state, state_capacity,
                                  constraint=p_l)
        expects(ovf2 == 0, "mg_leiden refinement shuffle overflow")
        p_g = unshard_vertex_values(cur, p_l).to(torch.int64)
        r_g = unshard_vertex_values(cur, r_l).to(torch.int64)
        cand = p_g[refc]  # the move phase's partition, flattened
        q = _modularity(mesh, mgg, k0, cand, resolution)
        if q <= best_q + threshold:
            break
        best_q, best_labels, levels = q, cand, levels + 1
        uniq, compact_r = torch.unique(r_g, return_inverse=True)
        new_cur = _coarsen(mesh, cur, r_l, uniq)
        refc = compact_r[refc]
        # seed the next level with P projected onto the refined clusters
        _, labels0 = torch.unique(p_g[uniq], return_inverse=True)
        cur = new_cur
        if cur.num_vertices <= 1:
            break
    mg_leiden.levels = levels
    _, out = torch.unique(best_labels, return_inverse=True)
    return out.to(VERTEX_DTYPE), float(best_q)


mg_louvain.levels = 0
mg_leiden.levels = 0
