"""Sweep plans for the sum kernels (spmv_sum, spmv_minplus, spmm_rows).

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
outgrows the card's L2, the SpMVs sweep an adjacency cut by its minors
into ranges [lo, lo + width), each range's edges a compressed adjacency of
its own, in the adjacency's (major, minor) order; a sweep of one range
gathers only from that range's slice of x. A range is compressed over all
the majors (dense), or, where few of them have an edge in it, over only
those (hypersparse, as cuGraph's DCSR segments): its merge path then has
one item a major with an edge there, not one a major. The first range
stays dense, so that its sweep writes every row of y.

An SpMV sweep follows one ``SweepPlan``: its ranges in order, each with
its merge-path tiles. ``sweep_plan`` builds one from its arguments alone;
``plan_for`` applies the rule (``segment_count`` and the ``SEGMENT_*``
constants) on the adjacency's card, at its first sweep, and keeps the plan
on the adjacency.

BFS's pull level (``bfs_pull_level``, csrc/bfs.cu) scans each unvisited
row of a CSC until its first in-neighbour on the frontier: a group of a
few lanes a light row, a block a heavy one, the rows above
``heavy_degree`` in-edges. ``pull_plan`` lists those rows; ``pull_plan_for``
applies ``PULL_HEAVY_DEGREE`` at the adjacency's first dense level and
keeps the plan beside the sweep's.

Every plan of an adjacency (the sweep's, the pull level's, and the tiles
of ``spmm_rows`` by ``tiles_for``) lives in its private cache, which only
this module reads and writes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ...core.csr import CompressedAdj
from ...utils.dtypes import EDGE_DTYPE
from ...utils.timer import span

SUM_THREADS = 256  # threads a block of the spmv kernels (csrc/spmv.cu)
# odd, so the threads' shared-memory runs fall in distinct banks; the
# fastest of 3-15 at RMAT scale 21 on an H100 (PERF.md §6)
SUM_ITEMS_PER_THREAD = 7
# The share of the L2 one range's slice of x may fill: 21.5 MiB of an
# H100's 50, the largest slice measured to stay there. At 2^24 minors that
# gives K = 3, the fastest of K = 1-16 on both of the benchmark's scale-24
# graphs (Urand 4.65 ms a sweep against 11.19 at K = 1, 6.10 at K = 2 (32
# MiB slices), 4.96 at K = 4; PERF.md §6)
SEGMENT_L2_SHARE = 0.43
# Segments only where the edges outnumber the majors this many times: each
# range sweeps every major's row again. At 2^24 minors K = 3 beats K = 1
# at degree 3 (0.913 against 1.166 ms); at degree 2 K = 2 and K = 4 bracket
# K = 1 (0.737 and 0.890 against 0.803)
SEGMENT_MIN_DEGREE = 3
# A column segment after the first sweeps only its rows with an edge
# (hypersparse) where fewer than this share of the rows have one. Against
# the dense range at K = 3 on 2^24 Urand rows, a range's sweep is 14.7%
# faster at a share of 0.28, 2.3% at 0.74, and 0.6% slower at 0.86 (0.3%
# at 0.93, 1.0% at GAP's Urand): the crossover is near 0.83 (PERF.md §6)
SEGMENT_HYPERSPARSE_SHARE = 0.8
# BFS's pull level: a row above this many in-edges is heavy, scanned by a
# whole block (a launch of its own) where a light row takes a group of 4
# lanes (csrc/bfs.cu kLanes). A query's dense levels from one seeded root on
# the benchmark's s24 graphs (H100, time_spmv.py --bfs; PERF.md §6): Kron
# 4.32, 4.15, 4.33, 4.35 ms at 128, 256, 1024 and none heavy; Urand has no
# row above 128. End to end (kron24.bfs, 3 pairs of 50 s runs, H100 at
# 700 W): gteps.bfs 28.97, 28.23, 28.22 at 256 against 28.12, 27.65, 29.10
# with none heavy, but query_p95_ms.bfs 11.37, 11.88, 11.85 against 13.25,
# 13.29, 12.66: a hub left to a few lanes holds up its query
PULL_HEAVY_DEGREE = 256


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
    """``spmm_rows``' plan of ``adj`` for ``items_per_tile``, computed once
    and kept in the adjacency's cache."""
    key = ("tiles", items_per_tile)
    plan = adj._plans.get(key)
    if plan is None:
        plan = adj._plans[key] = merge_path_tiles(adj.offsets, adj.num_edges, items_per_tile)
    return plan


@dataclasses.dataclass(frozen=True)
class SweepRange:
    """The edges of an adjacency whose minors lie in [lo, hi), in the
    adjacency's order, and their merge-path tiles. Dense (``row_ids``
    None), compressed over all its majors; hypersparse, over only the
    majors with an edge in the range, whose ids ``row_ids`` lists in
    ascending order. Minors keep their ids, so a kernel gathers from the
    whole x."""

    lo: int
    hi: int
    offsets: torch.Tensor  # (num_rows + 1,) int32
    row_ids: Optional[torch.Tensor]  # (num_rows,) int32, or None: every major
    minors: torch.Tensor  # (num_edges,) int32
    weights: Optional[torch.Tensor]  # (num_edges,) float32 or None
    num_edges: int
    tile_row: torch.Tensor  # (n_tiles + 1,) int32, from merge_path_tiles
    tile_edge: torch.Tensor

    @property
    def num_rows(self) -> int:
        """The rows a sweep of the range walks."""
        return self.offsets.numel() - 1


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """An SpMV sweep: its ranges in order (the first dense, so that it
    writes every row of y), tiles of ``SUM_THREADS * items_per_thread``
    items, and ``n_tiles``, the most tiles of any range: the rows of the
    carries the ranges share."""

    ranges: Tuple[SweepRange, ...]
    items_per_thread: int
    n_tiles: int


def segment_count(num_minors: int, num_edges: int, num_majors: int, l2_bytes: int) -> int:
    """K, the column segments of an SpMV sweep: 1 while x (4 bytes a
    minor) fits ``SEGMENT_L2_SHARE`` of an L2 of ``l2_bytes`` or the
    adjacency is too sparse to pay for K passes over its rows, else
    ceil(x bytes / that budget)."""
    budget = int(l2_bytes * SEGMENT_L2_SHARE)
    x_bytes = 4 * num_minors
    if x_bytes <= budget or num_edges < SEGMENT_MIN_DEGREE * num_majors:
        return 1
    return -(-x_bytes // budget)


def _cut(adj: CompressedAdj, lo: int, hi: int, hypersparse_share: float):
    """(lo, hi, offsets, row_ids, minors, weights) of the edges of ``adj``
    whose minors lie in [lo, hi), in one pass over the edges: the range's
    mask, its edges compacted in order, its offsets from a count of their
    majors. Hypersparse where fewer than ``hypersparse_share`` of the
    majors have an edge in the range (one host read of that count, at
    set-up), else dense. The adjacency is sorted by (major, minor), so no
    range needs a sort."""
    keep = (adj.minors >= lo) & (adj.minors < hi)
    counts = torch.bincount(adj.majors[keep].to(torch.int64), minlength=adj.num_majors)
    row_ids = None
    if int(torch.count_nonzero(counts)) < hypersparse_share * adj.num_majors:
        row_ids = torch.nonzero(counts).flatten()
        counts = counts[row_ids]
        row_ids = row_ids.to(torch.int32)
    offsets = torch.zeros(counts.numel() + 1, dtype=EDGE_DTYPE, device=adj.offsets.device)
    offsets[1:] = torch.cumsum(counts, 0)
    minors = adj.minors[keep]
    weights = None if adj.weights is None else adj.weights[keep]
    return lo, hi, offsets, row_ids, minors, weights


def sweep_plan(
    adj: CompressedAdj, width: int, hypersparse_share: float, items_per_thread: int
) -> SweepPlan:
    """The plan of a sweep over ``adj`` by ranges of ``width`` minors (the
    last may be shorter), each after the first hypersparse where fewer
    than ``hypersparse_share`` of the majors have an edge in it, with
    tiles of ``SUM_THREADS * items_per_thread`` items. Where one range
    covers every minor (K = 1) it is the adjacency itself, no copy. Else
    the ranges are cut under a ``cgt/setup.spmv_segments`` set-up span
    with the counters ``rows_swept``, the rows the ranges' sweeps walk,
    ``rows_dense``, K x the majors, and ``hypersparse_segments``."""
    if width < 1:
        raise ValueError(f"width must be positive, got {width}")
    n = adj.num_minors
    if width >= n:
        cuts = [(0, n, adj.offsets, None, adj.minors, adj.weights)]
    else:
        with span("cgt/setup.spmv_segments", setup=True, device=adj.offsets.device) as kept:
            cuts = [_cut(adj, lo, min(lo + width, n), hypersparse_share if lo > 0 else 0.0)
                    for lo in range(0, n, width)]
            kept.count("rows_swept", sum(offsets.numel() - 1 for _, _, offsets, *_ in cuts))
            kept.count("rows_dense", len(cuts) * adj.num_majors)
            kept.count("hypersparse_segments", sum(rows is not None for *_, rows, _, _ in cuts))
    items = SUM_THREADS * items_per_thread
    ranges = tuple(
        SweepRange(lo, hi, offsets, row_ids, minors, weights, minors.numel(),
                   *merge_path_tiles(offsets, minors.numel(), items))
        for lo, hi, offsets, row_ids, minors, weights in cuts
    )
    n_tiles = max(r.tile_row.numel() for r in ranges) - 1
    return SweepPlan(ranges, items_per_thread, n_tiles)


@functools.lru_cache(maxsize=None)
def _l2_bytes(index: int) -> int:
    return torch.cuda.get_device_properties(index).L2_cache_size


def plan_for(adj: CompressedAdj) -> SweepPlan:
    """The SpMVs' plan of ``adj``: K = ``segment_count`` ranges for the L2
    of the adjacency's card, the later ones hypersparse below
    ``SEGMENT_HYPERSPARSE_SHARE``, ``SUM_ITEMS_PER_THREAD`` items a thread.
    Built at the adjacency's first sweep and kept in its cache."""
    plan = adj._plans.get("sweep")
    if plan is None:
        n = adj.num_minors
        k = segment_count(n, adj.num_edges, adj.num_majors, _l2_bytes(adj.offsets.device.index))
        plan = adj._plans["sweep"] = sweep_plan(
            adj, max(-(-n // k), 1), SEGMENT_HYPERSPARSE_SHARE, SUM_ITEMS_PER_THREAD)
    return plan


@dataclasses.dataclass(frozen=True)
class PullPlan:
    """BFS's pull level over a CSC: ``heavy_rows``, the ids of the rows of
    more than ``heavy_degree`` in-edges (int32, ascending), each scanned
    by a block; every other row by a group of lanes."""

    heavy_rows: torch.Tensor
    heavy_degree: int


def pull_plan(adj: CompressedAdj, heavy_degree: int) -> PullPlan:
    """The pull level's plan of ``adj``: its rows above ``heavy_degree``
    in-edges, listed by one ``nonzero`` over the degrees (a host read) under
    a ``cgt/setup.bfs_pull_plan`` set-up span, with the counter
    ``heavy_rows``."""
    if heavy_degree < 0:
        raise ValueError(f"heavy_degree must not be negative, got {heavy_degree}")
    with span("cgt/setup.bfs_pull_plan", setup=True, device=adj.offsets.device) as kept:
        heavy = torch.nonzero(adj.degrees() > heavy_degree).flatten().to(torch.int32)
        kept.count("heavy_rows", heavy.numel())
    return PullPlan(heavy, int(heavy_degree))


def pull_plan_for(adj: CompressedAdj) -> PullPlan:
    """BFS's pull plan of ``adj`` at ``PULL_HEAVY_DEGREE``, built at its
    first dense level and kept in its cache."""
    plan = adj._plans.get("pull")
    if plan is None:
        plan = adj._plans["pull"] = pull_plan(adj, PULL_HEAVY_DEGREE)
    return plan
