"""bfs_pull_level: one dense BFS level as a bottom-up pull over the CSC
(csrc/bfs.cu), and its plain version.

    new = bfs_pull_level(csc, frontier, visited, dist, pred, depth)

Every row v not yet visited that has an in-neighbour on the frontier is
found: pred[v] = its smallest such in-neighbour, dist[v] = depth + 1,
visited[v] = True, and new[v] = True; every other row keeps its values and
gets new[v] = False. ``dist``, ``pred`` and ``visited`` are updated in
place; ``new`` is returned. This is the min-plus level (``spmv_minplus``
over the CSC with x = the ids on the frontier, +inf elsewhere, then
``isfinite(y) & ~visited``), which the plain version runs as it is; the
kernel computes it from what that level keeps: a visited row reads
nothing, and a row stops at its first in-neighbour on the frontier, the
smallest one, since each CSC row holds its in-neighbours in ascending
order.

A CUDA tensor launches the kernels by the adjacency's pull plan
(``_partition.pull_plan_for``: its heavy rows) and counts the call in
``launches``; a CPU tensor takes the plain version. There is no fallback
from one to the other. Either way the call is a ``cgt/kernel.bfs_pull_level`` span
(``utils/timer.py``). On a card the kernels also add to a device-side
int64 pair, ``bfs_pull_level.edges[device]``: the minors the levels
scanned, and the stored edges a full sweep of each level reads. The query
path never reads it; ``edges_scanned`` does, for the tools.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...core.csr import CompressedAdj
from ...utils.dtypes import VERTEX_DTYPE
from ...utils.timer import spanned
from . import build, spmv
from ._launch import on_device, ptr, raise_on_error, stream_of
from ._partition import PullPlan, pull_plan_for


def bfs_pull_level_reference(
    csc: CompressedAdj,
    frontier: torch.Tensor,
    visited: torch.Tensor,
    dist: torch.Tensor,
    pred: torch.Tensor,
    depth: int,
) -> torch.Tensor:
    """Plain version of bfs_pull_level, on any device: the min-plus level,
    spmv_minplus's plain version over the CSC with x the f32 ids on the
    frontier and +inf elsewhere, then the rows not yet visited (exact while
    ids ride f32, up to the 2^24 vertices of bfs's dense levels)."""
    ids = torch.arange(csc.num_majors, dtype=torch.float32, device=frontier.device)
    y = spmv.spmv_minplus_reference(csc, torch.where(frontier, ids, float("inf")),
                                    use_weights=False)
    new = torch.isfinite(y) & ~visited
    dist.masked_fill_(new, depth + 1)
    pred.copy_(torch.where(new, torch.where(new, y, 0.0).to(pred.dtype), pred))
    visited |= new
    return new


def _check(csc: CompressedAdj, frontier, visited, dist, pred, depth: int) -> None:
    """Raise on anything the kernels do not take."""
    name = "bfs_pull_level"
    dev = frontier.device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: frontier must be a CUDA or CPU tensor, got {dev}")
    v = csc.num_majors
    if csc.num_minors != v:
        raise ValueError(f"{name}: the CSC must be square, got {v} x {csc.num_minors}")
    if csc.num_edges >= 2**31 or v >= 2**31 or depth + 1 >= 2**31:
        raise ValueError(f"{name}: graph or depth too large for int32")
    for t, dtype, what in ((csc.offsets, torch.int32, "offsets"), (csc.minors, torch.int32, "minors"),
                           (frontier, torch.bool, "frontier"), (visited, torch.bool, "visited"),
                           (dist, VERTEX_DTYPE, "dist"), (pred, VERTEX_DTYPE, "pred")):
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, frontier on {dev}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous {dtype}, got {t.dtype}")
    for t, what in ((frontier, "frontier"), (visited, "visited"), (dist, "dist"), (pred, "pred")):
        if t.shape != (v,):
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, graph has {v} rows")


def _edges(device: torch.device) -> torch.Tensor:
    edges = bfs_pull_level.edges.get(device)
    if edges is None:
        edges = bfs_pull_level.edges[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return edges


def pull_level(
    plan: PullPlan,
    csc: CompressedAdj,
    frontier: torch.Tensor,
    visited: torch.Tensor,
    dist: torch.Tensor,
    pred: torch.Tensor,
    depth: int,
) -> torch.Tensor:
    """Launch the level on the card by ``plan`` (one C call: pack, light
    rows, heavy rows) and return new. The caller has checked the
    operands."""
    v = csc.num_majors
    dev = frontier.device
    new = torch.empty(v, dtype=torch.bool, device=dev)
    pairs = -(-v // 64)  # the bitmap's words in pairs, then a summary bit a pair
    bits = torch.empty(2 * pairs + -(-pairs // 32), dtype=torch.int32, device=dev)
    with on_device(dev):
        rc = build.load("bfs").cgt_bfs_pull_level(
            ptr(csc.offsets), ptr(csc.minors), ptr(frontier), ptr(bits), ptr(visited), ptr(dist),
            ptr(pred), ptr(new), ptr(plan.heavy_rows), plan.heavy_rows.numel(),
            ptr(_edges(dev)), v, plan.heavy_degree, depth, stream_of(dev),
        )
    raise_on_error("bfs_pull_level", rc)
    return new


@spanned("cgt/kernel.bfs_pull_level")
def bfs_pull_level(
    csc: CompressedAdj,
    frontier: torch.Tensor,
    visited: torch.Tensor,
    dist: torch.Tensor,
    pred: torch.Tensor,
    depth: int,
) -> torch.Tensor:
    """One dense BFS level over the square CSC ``csc`` from the bool
    ``frontier``: updates ``visited``, ``dist`` and ``pred`` (int32) in
    place for the rows found and returns them as a bool mask, the next
    frontier. Predecessors are the smallest frontier in-neighbours, equal
    to the min-plus level's bit for bit."""
    if frontier.device.type == "cpu":
        return bfs_pull_level_reference(csc, frontier, visited, dist, pred, depth)
    _check(csc, frontier, visited, dist, pred, depth)
    new = pull_level(pull_plan_for(csc), csc, frontier, visited, dist, pred, depth)
    bfs_pull_level.launches += 1
    return new


bfs_pull_level.launches = 0
bfs_pull_level.edges = {}  # device -> int64 (scanned, full), added to by the kernels


def edges_scanned(device) -> Tuple[int, int]:
    """(minors scanned, stored edges of the levels' full sweeps) by the pull
    levels on ``device`` since its counter was made or cleared
    (``bfs_pull_level.edges.clear()``); one host read."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    scanned, full = _edges(device).tolist()
    return scanned, full
