"""Breadth-first search.

Counterpart of ``cugraph_tpu/algos/traversal.py`` (``bfs``,
``_bfs_pallas_jit``, ``_sparse_bfs_level``; ref:
cpp/src/traversal/bfs_impl.cuh depth loop :205-283).

A dense level is one min-plus sweep over the unweighted CSC,
``spmv_minplus`` on the card: with x[u] = u for u in the frontier and +inf
elsewhere, y[v] = min over in-edges of x[u] is finite exactly where v has a
frontier in-neighbour, and is then the smallest such id, the predecessor.
Ids ride f32 exactly, so V <= 2^24. From V >= 2^22 on, levels whose
frontier is small (out-degree sum <= cap_e and size <= cap_v) take a
compacted push instead (``_sparse_bfs_level``), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.csr import Graph
from ..prims.cuda import spmv_minplus
from ..utils.device import as_tensor
from ..utils.dtypes import INT32_MAX, VERTEX_DTYPE
from ..utils.error import expects

INVALID_DISTANCE = INT32_MAX  # ref: unreachable = INT_MAX
INVALID_VERTEX = -1  # ref: no predecessor = invalid vertex id
MAX_VERTICES = 1 << 24  # vertex ids ride f32 exactly up to here
SPARSE_MIN_VERTICES = 1 << 22  # below this every level is a dense sweep
DEFAULT_SPARSE_CAPS = (1 << 19, 1 << 17)  # (cap_e, cap_v)


def _sparse_bfs_level(
    offsets: torch.Tensor,
    minors: torch.Tensor,
    frontier: torch.Tensor,
    visited: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level over the compacted frontier: gather the frontier's
    out-edge ranges of the CSR and scatter the unvisited neighbours.
    Returns (touched (V,) bool, pred_candidate (V,) int32): the smallest
    frontier in-neighbour where touched, INT32_MAX elsewhere."""
    v = visited.numel()
    fids = frontier.nonzero().squeeze(1)
    starts = offsets[fids].to(torch.int64)
    degs = offsets[fids + 1].to(torch.int64) - starts
    total = int(degs.sum())
    src = torch.repeat_interleave(fids, degs, output_size=total)
    # slot j of the compacted list reads edge j + (start - first slot) of
    # its frontier vertex's range
    shift = starts - (torch.cumsum(degs, 0) - degs)
    epos = torch.arange(total, device=fids.device) + torch.repeat_interleave(
        shift, degs, output_size=total
    )
    nbr = minors[epos].to(torch.int64)
    keep = ~visited[nbr]
    nbr, src = nbr[keep], src[keep]
    touched = torch.zeros(v, dtype=torch.bool, device=fids.device)
    touched[nbr] = True
    pred_cand = torch.full((v,), INT32_MAX, dtype=VERTEX_DTYPE, device=fids.device)
    pred_cand.scatter_reduce_(0, nbr, src.to(VERTEX_DTYPE), "amin")
    return touched, pred_cand


def bfs(
    g: Graph,
    sources,
    depth_limit: Optional[int] = None,
    sparse_caps: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-source BFS on the graph's device. Returns (distances int32,
    predecessors int32); unreachable vertices get INVALID_DISTANCE and
    predecessor -1. sparse_caps: (cap_e, cap_v) for the compacted levels,
    default (2^19, 2^17)."""
    v = g.num_vertices
    expects(v <= MAX_VERTICES, f"bfs takes at most 2^24 vertices, got {v}")
    dev = g.device
    sources = as_tensor(sources, torch.int64, dev).reshape(-1)
    expects(
        sources.numel() == 0 or bool(((sources >= 0) & (sources < v)).all()),
        "source vertex out of range",
    )
    limit = int(depth_limit) if depth_limit is not None else v
    cap_e, cap_v = DEFAULT_SPARSE_CAPS if sparse_caps is None else sparse_caps
    cap_v = min(v, int(cap_v))
    use_sparse = v >= SPARSE_MIN_VERTICES
    csc = g.csc()
    csr = g.csr() if use_sparse else None
    ids = torch.arange(v, dtype=torch.float32, device=dev)

    frontier = torch.zeros(v, dtype=torch.bool, device=dev)
    frontier[sources] = True
    visited = frontier.clone()
    dist = torch.where(frontier, 0, INVALID_DISTANCE).to(VERTEX_DTYPE)
    pred = torch.full((v,), INVALID_VERTEX, dtype=VERTEX_DTYPE, device=dev)
    depth = 0
    while depth < limit and bool(frontier.any()):
        sparse = False
        if use_sparse:
            f_edges = int(torch.where(frontier, csr.degrees(), 0).sum())
            sparse = f_edges <= cap_e and int(frontier.sum()) <= cap_v
        if sparse:
            touched, pred_cand = _sparse_bfs_level(csr.offsets, csr.minors, frontier, visited)
            new = touched & ~visited
        else:
            x = torch.where(frontier, ids, float("inf"))
            y = spmv_minplus(csc, x, use_weights=False)
            new = torch.isfinite(y) & ~visited
            pred_cand = torch.where(new, y, 0.0).to(VERTEX_DTYPE)
        dist = torch.where(new, depth + 1, dist)
        pred = torch.where(new, pred_cand, pred)
        visited |= new
        frontier = new
        depth += 1
    return dist, pred
