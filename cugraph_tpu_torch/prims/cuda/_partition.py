"""Merge-path tile plans for the sum kernels (spmv_sum, spmm_rows).

Merrill & Garland's merge path (SC'16) lays a compressed adjacency out as
one sequence of V + E items: each row's edges, then a marker for the end
of the row. Row r's end marker sits at position offsets[r + 1] + r. Cutting
that sequence into tiles of ``items_per_tile`` items gives every tile the
same work however the edges fall on the rows: a hub row spans many tiles,
a run of empty rows is one item each. Tile t starts at diagonal
d = t * items_per_tile (the last tile is cut short at V + E), where it has
consumed

    rows(d)  = #{r : offsets[r + 1] + r < d}     (rows whose end came before)
    edges(d) = d - rows(d)

A tile thus covers rows [rows(d_t), rows(d_t+1)] and edges
[edges(d_t), edges(d_t+1)); the first row may have begun in an earlier tile
and the last may go on into a later one, and those two partial rows are
what the kernels carry from tile to tile.

Column segments (Zhang et al., "Making Caches Work for Graph Analytics",
IEEE BigData 2017): the SpMVs gather x at each edge's minor. Where x
outgrows the card's L2, an adjacency is also kept cut by its minors into
ranges [lo, lo + width), each range's edges a compressed adjacency of its
own over all the majors, in the adjacency's (major, minor) order; a sweep
of one range gathers only from that range's slice of x.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ...core.csr import CompressedAdj
from ...utils.dtypes import EDGE_DTYPE
from ...utils.timer import span


def merge_path_tiles(
    offsets: torch.Tensor, num_edges: int, items_per_tile: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tile_row, tile_edge), int32 of n_tiles + 1 entries each, on
    offsets' device: the rows and edges consumed at each tile's start
    diagonal, and at V + E for the last entry. Diagonals are int64, since
    V + E may pass 2^31; nothing is read on the host."""
    if items_per_tile < 1:
        raise ValueError(f"items_per_tile must be positive, got {items_per_tile}")
    v = offsets.numel() - 1
    total = v + int(num_edges)
    n_tiles = -(-total // items_per_tile)
    dev = offsets.device
    diag = torch.arange(n_tiles + 1, dtype=torch.int64, device=dev) * items_per_tile
    diag.clamp_(max=total)
    row_ends = offsets[1:].to(torch.int64) + torch.arange(v, dtype=torch.int64, device=dev)
    rows = torch.searchsorted(row_ends, diag)  # the first end marker at or after d
    return rows.to(torch.int32), (diag - rows).to(torch.int32)


def tiles_for(adj, items_per_tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plan of a ``CompressedAdj`` or ``ColumnSegment`` for
    ``items_per_tile``, computed once and kept on it (``tile_plans``)."""
    plan = adj.tile_plans.get(items_per_tile)
    if plan is None:
        plan = merge_path_tiles(adj.offsets, adj.num_edges, items_per_tile)
        adj.tile_plans[items_per_tile] = plan
    return plan


@dataclasses.dataclass(frozen=True)
class ColumnSegment:
    """The edges of an adjacency whose minors lie in [lo, hi), in the
    adjacency's order, compressed over all its majors. Minors keep their
    ids, so a kernel gathers from the whole x."""

    lo: int
    hi: int
    offsets: torch.Tensor  # (num_majors + 1,) int32
    minors: torch.Tensor  # (num_edges,) int32
    weights: Optional[torch.Tensor]  # (num_edges,) float32 or None
    num_edges: int
    tile_plans: dict = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False
    )


def column_segments(adj: CompressedAdj, width: int) -> List[ColumnSegment]:
    """Cut ``adj`` by its minors into ranges of ``width`` (the last may be
    shorter), one pass over the edges a range: the range's mask, its
    edges compacted in order, its offsets from a count of their majors.
    The adjacency is sorted by (major, minor), so no range needs a sort."""
    if width < 1:
        raise ValueError(f"width must be positive, got {width}")
    v = adj.num_majors
    out = []
    for lo in range(0, adj.num_minors, width):
        hi = min(lo + width, adj.num_minors)
        keep = (adj.minors >= lo) & (adj.minors < hi)
        counts = torch.bincount(adj.majors[keep].to(torch.int64), minlength=v)
        offsets = torch.zeros(v + 1, dtype=EDGE_DTYPE, device=adj.offsets.device)
        offsets[1:] = torch.cumsum(counts, 0)
        minors = adj.minors[keep]
        weights = None if adj.weights is None else adj.weights[keep]
        out.append(ColumnSegment(lo, hi, offsets, minors, weights, minors.numel()))
    return out


def segments_for(adj: CompressedAdj, width: int) -> List[ColumnSegment]:
    """The adjacency's column segments of ``width``, built once (a
    ``cgt/setup.spmv_segments`` set-up span) and kept on the adjacency
    (``CompressedAdj.segments``)."""
    segments = adj.segments.get(width)
    if segments is None:
        with span("cgt/setup.spmv_segments", setup=True, device=adj.offsets.device):
            segments = column_segments(adj, width)
        adj.segments[width] = segments
    return segments
