"""Uniform neighbor sampling, the GNN minibatch path.

Counterpart of ``cugraph_tpu/sampling/uniform_neighbor_sample.py`` (ref:
cpp/src/sampling/uniform_neighbor_sampling_impl.hpp, the per-level loop
:69-115; fanout < 0 gathers all one-hop neighbors,
sampling_utils_impl.cuh:96). Each hop is a (frontier, fanout) draw from
``per_v_random_select_outgoing_e``; its sampled destinations, padded with
-1, are the next frontier. ``compress=True`` keeps the valid slots, on the
graph's device.

A fanout < 0 hop does not keep the JAX package's (frontier, max_degree)
tile: each frontier vertex expands its own row (``ragged_chunks``), so the
hop holds the frontier's edges and no padding. A hub behind a large
frontier would make that tile billions of slots. Its next frontier is the
gathered destinations, with no -1 between them, in both modes; only
``compress=False`` lays the hop out as a padded tile, since it returns one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.csr import Graph
from ..prims.intersection import PAIR_BUDGET, ragged_chunks
from ..prims.random_select import per_v_random_select_outgoing_e
from ..utils.device import as_tensor
from ..utils.dtypes import VERTEX_DTYPE


def _gather_one_hop(g: Graph, vertices: torch.Tensor, keep_slots: bool):
    """fanout < 0: all outgoing edges of the frontier (ref :96), row after
    row in CSR order, ``PAIR_BUDGET`` edges expanded at a time. Returns
    (sources, destinations, weights or None) and, with ``keep_slots``,
    each edge's frontier row and index within it (else None, None).
    Padding vertices (< 0) have no edges."""
    adj = g.csr()
    offsets = adj.offsets.to(torch.int64)
    v_safe = vertices.to(torch.int64).clamp(min=0)
    degs = torch.where(vertices >= 0, offsets[v_safe + 1] - offsets[v_safe], 0)
    parts = {"srcs": [], "dsts": [], "w": [], "row": [], "slot": []}
    for _, _, owner, rank in ragged_chunks(degs, PAIR_BUDGET):
        eidx = offsets[v_safe[owner]] + rank
        parts["srcs"].append(vertices[owner])
        parts["dsts"].append(adj.minors[eidx])
        if adj.weights is not None:
            parts["w"].append(adj.weights[eidx])
        if keep_slots:
            parts["row"].append(owner)
            parts["slot"].append(rank)

    def cat(key, like):
        return torch.cat(parts[key]) if parts[key] else like.new_zeros(0)

    srcs, dsts = cat("srcs", vertices), cat("dsts", adj.minors)
    w = None if adj.weights is None else cat("w", adj.weights)
    if not keep_slots:
        return srcs, dsts, w, None, None
    return srcs, dsts, w, cat("row", offsets), cat("slot", offsets)


def _padded(frontier: torch.Tensor, row, slot, dsts, w):
    """The gathered hop as compress=False returns it: (frontier, width)
    tiles, width the largest row (at least 1); padding slots hold the
    row's vertex as source, -1 as destination and weight 0."""
    n = frontier.numel()
    width = max(int(slot.max()) + 1 if slot.numel() else 0, 1)
    srcs = frontier.clamp(min=0)[:, None].expand(n, width).contiguous()
    tile = torch.full((n, width), -1, dtype=dsts.dtype, device=frontier.device)
    tile[row, slot] = dsts
    valid = torch.zeros((n, width), dtype=torch.bool, device=frontier.device)
    valid[row, slot] = True
    wt = None
    if w is not None:
        wt = torch.zeros((n, width), dtype=w.dtype, device=frontier.device)
        wt[row, slot] = w
    return srcs, tile, wt, valid


def uniform_neighbor_sample(
    g: Graph,
    start_vertices,
    fanout_vals: Sequence[int],
    *,
    with_replacement: bool = False,
    generator: Optional[torch.Generator] = None,
    compress: bool = True,
):
    """Multi-hop uniform neighbor sampling on the graph's device.

    generator: a ``torch.Generator`` on the graph's device (None: one
    seeded 0). compress=True returns a dict of tensors over the sampled
    edges, hop by hop in row-major slot order: "sources",
    "destinations", "weights" (None on an unweighted graph) and "hop"
    (int32). compress=False returns a list, one (srcs, dsts, weights,
    valid) of padded (frontier, fanout) tensors per hop; a fanout < 0
    hop's width is its frontier's largest out-degree. The same generator
    seed gives the same edges in both modes.
    """
    dev = g.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    frontier = as_tensor(start_vertices, VERTEX_DTYPE, dev).reshape(-1)
    per_hop = []  # (srcs, dsts, weights or None, valid or None: all valid)
    for k in fanout_vals:
        if k < 0:
            srcs, dsts, w, row, slot = _gather_one_hop(g, frontier, keep_slots=not compress)
            hop = (srcs, dsts, w, None) if compress else _padded(frontier, row, slot, dsts, w)
            frontier = dsts
        else:
            hop = per_v_random_select_outgoing_e(
                g, generator, frontier, int(k), with_replacement=with_replacement)
            frontier = torch.where(hop[3], hop[1], -1).reshape(-1)
        per_hop.append(hop)
    if not compress:
        return per_hop
    out = {"sources": [], "destinations": [], "weights": [], "hop": []}
    for hop, (srcs, dsts, w, valid) in enumerate(per_hop):
        if valid is not None:
            m = valid.reshape(-1)
            srcs, dsts = srcs.reshape(-1)[m], dsts.reshape(-1)[m]
            w = None if w is None else w.reshape(-1)[m]
        out["sources"].append(srcs)
        out["destinations"].append(dsts)
        if w is not None:
            out["weights"].append(w)
        out["hop"].append(torch.full((dsts.numel(),), hop, dtype=torch.int32, device=dev))
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    return {
        "sources": torch.cat(out["sources"]) if per_hop else empty,
        "destinations": torch.cat(out["destinations"]) if per_hop else empty,
        "weights": torch.cat(out["weights"]) if out["weights"] else None,
        "hop": torch.cat(out["hop"]) if per_hop else empty,
    }
