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
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...core.csr import CompressedAdj


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


def tiles_for(adj: CompressedAdj, items_per_tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adjacency's plan for ``items_per_tile``, computed once and kept
    on the adjacency (``CompressedAdj.tile_plans``)."""
    plan = adj.tile_plans.get(items_per_tile)
    if plan is None:
        plan = merge_path_tiles(adj.offsets, adj.num_edges, items_per_tile)
        adj.tile_plans[items_per_tile] = plan
    return plan
