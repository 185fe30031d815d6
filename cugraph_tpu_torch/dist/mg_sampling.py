"""Distributed uniform neighbor sampling and random walks.

Counterpart of ``cugraph_tpu/dist/mg_sampling.py`` (ref:
cpp/src/sampling/uniform_neighbor_sampling_impl.hpp, the per-level
shuffle and per_v_random_select, :69-115). A vertex's out-edges are spread
over the R ranks of the mesh column that holds it in its span, each rank
keeping its share in the DCSR src-side arrays (``mg_graph.src_dcsr``). Per hop:

1. each rank looks up its local out-degree of every frontier vertex of
   its column span (``mg_prims.dcsr_lookup``);
2. an all-gather over ``row_group`` gives the column's R local degrees:
   their sum is the global degree, their exclusive prefix over the rank
   rows says which rank holds which of the vertex's edge slots;
3. every rank draws the same slots from the same uniforms, Floyd's
   K-subset in f32 without replacement (JAX mg_sampling.py:94-115), or
   floor(u * d) with it; the rank whose prefix range holds a slot answers
   with that edge's global dst, weight and id, every other rank with 0,
   and a SUM all-reduce assembles the answers (one owner a slot, so the
   sum is exact).

Two frontier methods, as in the JAX package: "replicate" keeps the whole
frontier on every rank (O(n) masked work a rank, for the minibatch sizes
of up to ~1e6); "shuffle" keeps a shard of it on each rank and routes each
seed with its uniforms to its owner (``mg_prims.shuffle_to_vertex_owners``),
the owner's column draws, and the answers return by (rank, slot) address;
a capacity that overflows is doubled and the hop run again. "auto" takes
"shuffle" from 2^20 seeds on. Both draw the same edges from the same
uniforms, in the same order.

An edge id is (i * C + j) * d_pad + the edge's position in the rank's
DCSR arrays, d_pad the JAX package's edge-slot stride (``MGGraph.d_pad``),
int64 here. Differences by design: the draws come from a
``torch.Generator`` (``generator=``, one seeded 0 by default) where the
JAX package takes a PRNG key. The uniforms keep the JAX package's shapes,
(sizes[h], k) a hop over the seeds padded to a multiple of the rank count
and (n, 1) a walk step; the rows of the padding seeds are zeros, not
draws, so a generator seed gives the same draw on every mesh shape. The
results are tensors on the mesh's device, the same on every rank, where
the JAX package returns numpy arrays.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import as_tensor, resolve_device
from ..utils.dtypes import VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects, expects_vertex_ids
from .mesh import Mesh2D, all_gather_rows
from .mg_graph import MGGraph, src_dcsr
from .mg_prims import _global_sum, _shuffle_axis, dcsr_lookup, shuffle_to_vertex_owners

SHUFFLE_FROM_SEEDS = 1 << 20  # "auto" takes the shuffle method from this many seeds on


def _draw_slots(u: torch.Tensor, d_total: torch.Tensor, with_replacement: bool) -> torch.Tensor:
    """(n, k) edge slots in [0, d_total) from (n, k) f32 uniforms, the JAX
    package's arithmetic: floor(u * d) with replacement; else Floyd's
    K-subset (slot i: j = d - k + i, t = floor(u * (j + 1)) capped at j,
    j if an earlier slot took t), and slot i = i where d <= k."""
    n, k = u.shape
    dt = d_total[:, None]
    if with_replacement:
        slot = (u * dt.to(u.dtype)).to(torch.int64)
    else:
        slot = torch.full((n, k), -1, dtype=torch.int64, device=u.device)
        for fi in range(k):
            jpos = (d_total - k + fi).clamp(min=0)
            t = torch.minimum((u[:, fi] * (jpos + 1).to(u.dtype)).to(torch.int64), jpos)
            dup = (slot[:, :fi] == t[:, None]).any(1)
            slot[:, fi] = torch.where(dup, jpos, t)
        arange_k = torch.arange(k, dtype=torch.int64, device=u.device)[None, :]
        slot = torch.where(dt <= k, arange_k, slot)
    return torch.minimum(slot, (dt - 1).clamp(min=0))


def _local_degrees(mesh: Mesh2D, mgg: MGGraph, vertices: torch.Tensor, valid: torch.Tensor):
    """(lo, local degree, in this rank's column span) of global vertex ids;
    ids outside the span or not ``valid`` have degree 0."""
    span = mgg.rows * mgg.vp
    local = vertices - mesh.j * span
    mine = valid & (local >= 0) & (local < span)
    adj = src_dcsr(mesh, mgg)
    lo, deg = dcsr_lookup(adj.src_nzd, adj.src_nzd_offsets, local.clamp(0, max(span - 1, 0)))
    return lo, torch.where(mine, deg, 0), mine


def _owned_answers(mesh, mgg, lo, deg_local, mine, slot, my_prefix):
    """This rank's answers for the slots it owns: (dst, eid, weight bits
    or None) as int64, 0 where it owns none."""
    in_me = mine[:, None] & (slot >= my_prefix[:, None]) & (slot < (my_prefix + deg_local)[:, None])
    adj = src_dcsr(mesh, mgg)
    dsts = adj.src_csr_dsts
    # a rank without edges owns no slot: its gathers read a zero instead
    table = dsts if dsts.numel() else dsts.new_zeros(1)
    idx = (lo[:, None] + slot - my_prefix[:, None]).clamp(0, table.numel() - 1)
    zero = torch.zeros((), dtype=torch.int64, device=slot.device)
    dst = torch.where(in_me, table[idx].to(torch.int64), zero)
    rank = mesh.i * mesh.cols + mesh.j
    eid = torch.where(in_me, rank * mgg.d_pad + idx, zero)
    wbits = None
    if mgg.weighted:
        w = adj.src_csr_weights
        w = w if w.numel() else w.new_zeros(1)
        # f32 bits through the integer sum: one owner a slot, zeros elsewhere
        wbits = torch.where(in_me, w[idx].contiguous().view(torch.int32).to(torch.int64), zero)
    return dst, eid, wbits


def _unpack_weights(wbits: torch.Tensor) -> torch.Tensor:
    return wbits.to(torch.int32).view(WEIGHT_DTYPE)


def _level_draw(mesh: Mesh2D, mgg: MGGraph, frontier: torch.Tensor, u: torch.Tensor,
                with_replacement: bool):
    """One hop over a frontier that every rank holds whole (JAX
    mg_sampling.py:70): (n,) global ids, < 0 a dead slot, and (n, k)
    uniforms -> (dst, weights or None, eid, valid), each (n, k), the same
    on every rank. One all-gather over ``row_group`` and one SUM
    all-reduce over the world."""
    n, k = u.shape
    lo, deg_local, mine = _local_degrees(mesh, mgg, frontier, frontier >= 0)
    degs_all = all_gather_rows(deg_local[None], mesh.row_group)  # (R, n)
    my_prefix = (torch.cumsum(degs_all, 0) - degs_all)[mesh.i]
    d_total = degs_all.sum(0)
    slot = _draw_slots(u, d_total, with_replacement)
    dst, eid, wbits = _owned_answers(mesh, mgg, lo, deg_local, mine, slot, my_prefix)
    # the degree where this rank's column holds the vertex: the R ranks of
    # that column add R times the same d_total
    parts = [dst.reshape(-1), eid.reshape(-1), torch.where(mine, d_total, 0)]
    if wbits is not None:
        parts.append(wbits.reshape(-1))
    packed = torch.cat(parts)
    dist.all_reduce(packed)
    nk = n * k
    dst, eid = packed[:nk].view(n, k), packed[nk:2 * nk].view(n, k)
    d_rep = packed[2 * nk:2 * nk + n] // mgg.rows
    w = _unpack_weights(packed[2 * nk + n:].view(n, k)) if wbits is not None else None
    valid = (d_rep > 0)[:, None].expand(n, k)
    if not with_replacement:  # degree < fanout: only the first d slots are real
        valid = valid & (torch.arange(k, device=u.device)[None, :] < d_rep[:, None])
    return dst, w, eid, valid


def _col_draw(mesh: Mesh2D, mgg: MGGraph, seeds: torch.Tensor, valid: torch.Tensor,
              u: torch.Tensor, with_replacement: bool):
    """The draw for a batch of seeds that every rank of their owner column
    holds (JAX mg_sampling.py:149): the same slots as ``_level_draw``, the
    answers assembled by a SUM all-reduce over ``row_group`` alone.
    Returns (dst, weights or None, eid, valid), each (m, k)."""
    m, k = u.shape
    lo, deg_local, ok = _local_degrees(mesh, mgg, seeds, valid)
    degs_all = all_gather_rows(deg_local[None], mesh.row_group)
    my_prefix = (torch.cumsum(degs_all, 0) - degs_all)[mesh.i]
    d_total = degs_all.sum(0)
    slot = _draw_slots(u, d_total, with_replacement)
    dst, eid, wbits = _owned_answers(mesh, mgg, lo, deg_local, ok, slot, my_prefix)
    parts = [dst, eid] + ([wbits] if wbits is not None else [])
    packed = torch.stack(parts)
    dist.all_reduce(packed, group=mesh.row_group)
    w = _unpack_weights(packed[2]) if wbits is not None else None
    valid_out = (ok & (d_total > 0))[:, None].expand(m, k)
    if not with_replacement:
        valid_out = valid_out & (torch.arange(k, device=u.device)[None, :] < d_total[:, None])
    return packed[0], w, packed[1], valid_out


def _level_draw_shuffled(mesh: Mesh2D, mgg: MGGraph, frontier: torch.Tensor, u: torch.Tensor,
                         with_replacement: bool, capacity: int):
    """One hop over this rank's frontier shard (JAX mg_sampling.py:222):
    each seed goes with its uniforms and return address (rank, slot) to
    its owner, the owner's column draws for the column's requests
    (``_col_draw``), each rank answers the requests it received, and the
    answers travel back over ``col_group`` then ``row_group``. Returns
    ((dst, weights or None, eid, valid), each (n_loc, k); overflow summed
    over every rank)."""
    r = mesh.rows
    n_loc, k = u.shape
    dev = u.device
    me = mesh.j * r + mesh.i
    valid0 = frontier >= 0
    items = {"u": u, "addr": torch.full((n_loc,), me, dtype=torch.int32, device=dev),
             "slot": torch.arange(n_loc, dtype=torch.int32, device=dev)}
    keys, pack, v_rx, ov1 = shuffle_to_vertex_owners(
        mesh, frontier.clamp(min=0), items, valid0, mgg.vp, capacity)
    m_loc = keys.numel()
    seeds_col = all_gather_rows(keys, mesh.row_group)
    u_col = all_gather_rows(pack["u"], mesh.row_group)
    v_col = all_gather_rows(v_rx.to(torch.uint8), mesh.row_group).to(torch.bool)
    dst, w, eid, valid = _col_draw(mesh, mgg, seeds_col, v_col, u_col, with_replacement)
    mine = slice(mesh.i * m_loc, (mesh.i + 1) * m_loc)  # the requests this rank received
    back = {"dst": dst[mine], "eid": eid[mine], "val": valid[mine],
            "slot": pack["slot"], "addr": pack["addr"]}
    if w is not None:
        back["w"] = w[mine]
    b1, bv1, ov2 = _shuffle_axis(back, pack["addr"] // r, v_rx, mesh.col_group, capacity)
    b2, bv2, ov3 = _shuffle_axis(b1, b1["addr"] % r, bv1, mesh.row_group, capacity)
    slot = b2["slot"].to(torch.int64)[bv2]

    def put(a):
        out = torch.zeros((n_loc,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
        out[slot] = a[bv2]
        return out

    res = (put(b2["dst"]), put(b2["w"]) if w is not None else None, put(b2["eid"]),
           put(b2["val"]) & valid0[:, None])
    return res, ov1 + _global_sum(ov2 + ov3)


def _gather_shards(a: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Every rank's shard, in rank order i * C + j (bools travel as uint8)."""
    if a is None:
        return None
    if a.dtype == torch.bool:
        return all_gather_rows(a.to(torch.uint8)).to(torch.bool)
    return all_gather_rows(a)


def _pad_seeds(mesh: Mesh2D, seeds: torch.Tensor) -> torch.Tensor:
    """The seeds padded with -1 to a multiple of the rank count (at least
    one a rank), as the JAX package pads them."""
    n_dev = mesh.rows * mesh.cols
    n_pad = max(-(-seeds.numel() // n_dev) * n_dev, n_dev)
    out = torch.full((n_pad,), -1, dtype=torch.int64, device=seeds.device)
    out[: seeds.numel()] = seeds
    return out


def _hop_sizes(n_pad: int, fanouts: Sequence[int]) -> List[int]:
    sizes = [n_pad]
    for k in fanouts:
        sizes.append(sizes[-1] * k)
    return sizes


def _sample_with_uniforms(
    mesh: Mesh2D,
    mgg: MGGraph,
    seeds: torch.Tensor,
    us: Sequence[torch.Tensor],
    *,
    with_replacement: bool,
    method: str,
    shuffle_capacity: Optional[int] = None,
) -> dict:
    """``mg_uniform_neighbor_sample`` on given uniforms: ``seeds`` (n,)
    global ids, ``us[h]`` the (sizes[h], k_h) f32 uniforms of hop h over
    the seeds padded as ``_pad_seeds`` pads them (the JAX package's
    shapes). method "replicate" or "shuffle"."""
    dev = seeds.device
    seeds0 = _pad_seeds(mesh, seeds)
    n_dev = mesh.rows * mesh.cols
    rank = mesh.i * mesh.cols + mesh.j
    us = [u.to(device=dev, dtype=torch.float32) for u in us]
    weighted = mgg.weighted
    if method == "shuffle":
        sizes = [u.shape[0] for u in us]
        cap = shuffle_capacity or max(4 * (sizes[-1] // n_dev) // max(mesh.cols, 1), 64)
        while True:
            frontier = seeds0.view(n_dev, -1)[rank]
            hops, overflow = [], 0
            for u in us:
                u_loc = u.view(n_dev, -1, u.shape[1])[rank]
                (dst, w, eid, valid), ov = _level_draw_shuffled(
                    mesh, mgg, frontier, u_loc, with_replacement, int(cap))
                overflow += ov
                hops.append((frontier, dst, w, eid, valid))
                frontier = torch.where(valid, dst, -1).reshape(-1)
            if overflow == 0:
                break
            cap *= 2  # the reference's two passes: count, then exchange again
        # the shards, in rank order i * C + j: the replicated layout
        hops = [tuple(_gather_shards(a) for a in hop) for hop in hops]
    elif method == "replicate":
        frontier, hops = seeds0, []
        for u in us:
            dst, w, eid, valid = _level_draw(mesh, mgg, frontier, u, with_replacement)
            hops.append((frontier, dst, w, eid, valid))
            frontier = torch.where(valid, dst, -1).reshape(-1)
    else:
        raise ValueError(f"unknown method {method!r}")
    out = {"sources": [], "destinations": [], "weights": [], "edge_ids": [], "hop": []}
    for h, (src, dst, w, eid, valid) in enumerate(hops):
        m = valid.reshape(-1)
        k = valid.shape[1]
        out["sources"].append(src[:, None].expand(-1, k).reshape(-1)[m])
        out["destinations"].append(dst.reshape(-1)[m])
        if weighted:
            out["weights"].append(w.reshape(-1)[m])
        out["edge_ids"].append(eid.reshape(-1)[m])
        out["hop"].append(torch.full((int(m.sum()),), h, dtype=torch.int32, device=dev))

    def cat(parts, dtype):
        return torch.cat(parts).to(dtype) if parts else torch.zeros(0, dtype=dtype, device=dev)

    return {
        "sources": cat(out["sources"], VERTEX_DTYPE),
        "destinations": cat(out["destinations"], VERTEX_DTYPE),
        "weights": cat(out["weights"], WEIGHT_DTYPE) if weighted else None,
        "edge_ids": cat(out["edge_ids"], torch.int64),
        "hop": cat(out["hop"], torch.int32),
    }


def _generator(dev: torch.device, generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(0) if generator is None else generator


def mg_uniform_neighbor_sample(
    mesh: Mesh2D,
    mgg: MGGraph,
    start_vertices,
    fanout_vals: Sequence[int],
    *,
    generator: Optional[torch.Generator] = None,
    with_replacement: bool = False,
    method: str = "auto",
    shuffle_capacity: Optional[int] = None,
) -> dict:
    """Multi-hop distributed sampling (the reference contract,
    uniform_neighbor_sampling_impl.hpp): a dict of tensors on the mesh's
    device, the same on every rank, {'sources', 'destinations',
    'weights' (None on an unweighted graph), 'edge_ids', 'hop'}. Every
    rank must call it with the same arguments and a generator in the same
    state.

    fanout_vals: positive fanouts, one a hop. generator: a
    ``torch.Generator`` on the mesh's device (None: one seeded 0); each
    hop draws (n * fanouts before it, k) uniforms from it. method:
    "replicate", "shuffle" or "auto" (module docstring).
    shuffle_capacity: items a bucket of the shuffle's all-to-alls
    (default 4 x the even split + 64), doubled while it overflows."""
    dev = resolve_device(mesh.device)
    seeds = as_tensor(start_vertices, torch.int64, dev).reshape(-1)
    expects_vertex_ids(seeds, mgg.num_vertices, "start_vertices")
    fanouts = [int(k) for k in fanout_vals]
    expects(all(k > 0 for k in fanouts), "MG sampling needs fanouts > 0")
    if method == "auto":
        method = "shuffle" if seeds.numel() >= SHUFFLE_FROM_SEEDS else "replicate"
    gen = _generator(dev, generator)
    n = seeds.numel()
    sizes = _hop_sizes(_pad_seeds(mesh, seeds).numel(), fanouts)
    us = []
    for h, k in enumerate(fanouts):
        u = torch.zeros((sizes[h], k), dtype=torch.float32, device=dev)
        rows = n * (sizes[h] // sizes[0])  # the rows of the real seeds come first
        u[:rows] = torch.rand((rows, k), generator=gen, device=dev)
        us.append(u)
    return _sample_with_uniforms(mesh, mgg, seeds, us, with_replacement=with_replacement,
                                 method=method, shuffle_capacity=shuffle_capacity)


def _walk_with_uniforms(mesh: Mesh2D, mgg: MGGraph, starts: torch.Tensor,
                        us: Sequence[torch.Tensor]) -> torch.Tensor:
    """``mg_random_walks`` on given (n, 1) uniforms, one a step."""
    steps = [starts]
    for u in us:
        dst, _, _, valid = _level_draw(mesh, mgg, steps[-1], u.to(starts.device, torch.float32),
                                       True)
        steps.append(torch.where(valid[:, 0] & (steps[-1] >= 0), dst[:, 0], -1))
    return torch.stack(steps, 1).to(VERTEX_DTYPE)


def mg_random_walks(
    mesh: Mesh2D,
    mgg: MGGraph,
    start_vertices,
    max_depth: int,
    *,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Distributed uniform random walks (ref the random-walk path of
    sampling/random_walks.cuh): each step is a fanout-1 draw with
    replacement by ``_level_draw``. Returns (N, max_depth + 1) int32 on
    the mesh's device, the same on every rank, -1 after a sink."""
    dev = resolve_device(mesh.device)
    starts = as_tensor(start_vertices, torch.int64, dev).reshape(-1)
    expects_vertex_ids(starts, mgg.num_vertices, "start_vertices")
    gen = _generator(dev, generator)
    us = [torch.rand((starts.numel(), 1), generator=gen, device=dev) for _ in range(int(max_depth))]
    return _walk_with_uniforms(mesh, mgg, starts, us)
