"""Traversal: BFS, SSSP, BFS path extraction, two-hop neighbors.

Counterpart of ``cugraph_tpu/algos/traversal.py`` (``bfs``,
``_bfs_pallas_jit``, ``_sparse_bfs_level``, ``sssp``, ``_sssp_jit``,
``_sssp_pallas_jit``, ``extract_bfs_paths``, ``two_hop_neighbors``; ref:
cpp/src/traversal/bfs_impl.cuh depth loop :205-283, sssp_impl.cuh,
extract_bfs_paths_impl.cuh).

A dense BFS level is one min-plus sweep over the unweighted CSC,
``spmv_minplus`` on the card: with x[u] = u for u in the frontier and +inf
elsewhere, y[v] = min over in-edges of x[u] is finite exactly where v has a
frontier in-neighbour, and is then the smallest such id, the predecessor.
Ids ride f32 exactly up to V = 2^24. From V >= 2^22 on, levels whose
frontier is small (out-degree sum <= cap_e and size <= cap_v) take a
compacted push instead (``_sparse_bfs_level``), as in the JAX package;
above 2^24 every level does. ``bfs`` marks its call, each level (sparse or
dense) and each blocking read with spans (``utils/timer.py``).

SSSP is Bellman-Ford. A weighted graph with E >= 2^18 and V <= 2^24 (the
JAX package's gate for its min-plus layout) takes full sweeps of the
weighted ``spmv_minplus`` until no distance changes, then one predecessor
pass over the CSC; any other graph relaxes the frontier's out-edges each
round (``prims/frontier.py``), as the JAX package's ``_sssp_jit`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.csr import Graph
from ..prims.cuda import spmv_minplus
from ..prims.frontier import transform_reduce_v_frontier_outgoing_e_by_dst
from ..prims.reduce_ops import ANY, MINIMUM
from ..utils.device import as_tensor
from ..utils.dtypes import INT32_MAX, VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects, expects_vertex_ids
from ..utils.timer import span, spanned

INVALID_DISTANCE = INT32_MAX  # ref: unreachable = INT_MAX
INVALID_VERTEX = -1  # ref: no predecessor = invalid vertex id
MAX_VERTICES = 1 << 24  # vertex ids ride f32 exactly up to here
SPARSE_MIN_VERTICES = 1 << 22  # below this every level is a dense sweep
DEFAULT_SPARSE_CAPS = (1 << 19, 1 << 17)  # (cap_e, cap_v)
# SSSP takes min-plus sweeps on weighted graphs within these bounds
SSSP_SWEEP_MIN_EDGES = 1 << 18
SSSP_SWEEP_MAX_VERTICES = 1 << 24


def _source_mask(g: Graph, sources) -> torch.Tensor:
    v = g.num_vertices
    # the ids and the mask's True are copied from the host, each copy a wait
    with span("cgt/sync.bfs.source_range"):
        sources = as_tensor(sources, torch.int64, g.device).reshape(-1)
        expects(
            sources.numel() == 0 or bool(((sources >= 0) & (sources < v)).all()),
            "source vertex out of range",
        )
        mask = torch.zeros(v, dtype=torch.bool, device=g.device)
        mask[sources] = True
    return mask


def _out_edges(offsets: torch.Tensor, vertices: torch.Tensor):
    """The out-edges of ``vertices`` (int64) in a CSR: (owner, epos), for
    each edge the index in ``vertices`` of its source and its position in
    the CSR's edge arrays."""
    starts = offsets[vertices].to(torch.int64)
    degs = offsets[vertices + 1].to(torch.int64) - starts
    with span("cgt/sync.bfs.out_edge_total"):
        total = int(degs.sum())
    owner = torch.repeat_interleave(
        torch.arange(vertices.numel(), device=vertices.device), degs, output_size=total
    )
    # slot j reads edge j + (start - first slot) of its owner's range
    shift = starts - (torch.cumsum(degs, 0) - degs)
    return owner, torch.arange(total, device=vertices.device) + shift[owner]


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
    with span("cgt/sync.bfs.frontier_ids"):
        fids = frontier.nonzero().squeeze(1)
    owner, epos = _out_edges(offsets, fids)
    src = fids[owner]
    nbr = minors[epos].to(torch.int64)
    keep = ~visited[nbr]
    with span("cgt/sync.bfs.unvisited"):
        nbr, src = nbr[keep], src[keep]
    touched = torch.zeros(v, dtype=torch.bool, device=fids.device)
    with span("cgt/sync.bfs.touched"):  # the True is copied from the host: a wait
        touched[nbr] = True
    pred_cand = torch.full((v,), INT32_MAX, dtype=VERTEX_DTYPE, device=fids.device)
    pred_cand.scatter_reduce_(0, nbr, src.to(VERTEX_DTYPE), "amin")
    return touched, pred_cand


def _any(frontier: torch.Tensor) -> bool:
    with span("cgt/sync.bfs.frontier_any"):
        return bool(frontier.any())


@spanned("cgt/algorithms.bfs")
def bfs(
    g: Graph,
    sources,
    depth_limit: Optional[int] = None,
    direction_optimizing: bool = False,
    sparse_caps: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-source BFS on the graph's device. Returns (distances int32,
    predecessors int32); unreachable vertices get INVALID_DISTANCE and
    predecessor -1. direction_optimizing is accepted and ignored, as in the
    JAX package (each level is edge-complete already). sparse_caps:
    (cap_e, cap_v) for the compacted levels, default (2^19, 2^17). Above
    MAX_VERTICES, where ids no longer ride f32 exactly, every level is the
    compacted push, as the JAX package's ``_bfs_jit`` is there."""
    del direction_optimizing
    v = g.num_vertices
    dev = g.device
    frontier = _source_mask(g, sources)
    limit = int(depth_limit) if depth_limit is not None else v
    cap_e, cap_v = DEFAULT_SPARSE_CAPS if sparse_caps is None else sparse_caps
    cap_v = min(v, int(cap_v))
    dense_ok = v <= MAX_VERTICES
    use_sparse = v >= SPARSE_MIN_VERTICES or not dense_ok
    csc = g.csc() if dense_ok else None
    csr = g.csr() if use_sparse else None
    ids = torch.arange(v, dtype=torch.float32, device=dev) if dense_ok else None

    visited = frontier.clone()
    dist = torch.where(frontier, 0, INVALID_DISTANCE).to(VERTEX_DTYPE)
    pred = torch.full((v,), INVALID_VERTEX, dtype=VERTEX_DTYPE, device=dev)
    depth = 0
    while depth < limit and _any(frontier):
        sparse = not dense_ok
        if use_sparse and dense_ok:
            f_edges = torch.where(frontier, csr.degrees(), 0).sum()
            with span("cgt/sync.bfs.frontier_edges"):
                sparse = int(f_edges) <= cap_e
            if sparse:
                f_size = frontier.sum()
                with span("cgt/sync.bfs.frontier_size"):
                    sparse = int(f_size) <= cap_v
        with span("cgt/step.bfs.sparse" if sparse else "cgt/step.bfs.dense"):
            if sparse:
                touched, pred_cand = _sparse_bfs_level(
                    csr.offsets, csr.minors, frontier, visited
                )
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


def _sssp_sweeps(g: Graph, src_mask: torch.Tensor, cutoff: torch.Tensor):
    """Bellman-Ford over full min-plus sweeps of the weighted CSC (it
    converges in hop-diameter rounds; ``changed`` is read on the host once
    a round), then one pass for predecessors: the smallest src among the
    tree edges, dist[s] + w == dist[d], sources excluded. The sweep and the
    pass round x + w alike in f32, so the tree test is exact."""
    v = g.num_vertices
    csc = g.csc()
    inf = float("inf")
    dist = torch.where(src_mask, 0.0, inf).to(WEIGHT_DTYPE)
    changed, it = True, 0
    while changed and it < v:
        relax = spmv_minplus(csc, dist)
        relax = torch.where(relax <= cutoff, relax, inf)
        new = torch.minimum(dist, relax)
        changed = bool((new < dist).any())
        dist, it = new, it + 1
    srcs, dsts = csc.minors, csc.majors
    dd = dist.index_select(0, dsts)
    on_tree = (
        torch.isfinite(dd)
        & (dist.index_select(0, srcs) + csc.weights == dd)
        & ~src_mask.index_select(0, dsts)
    )
    pred = torch.full((v,), v, dtype=VERTEX_DTYPE, device=dist.device)
    pred.scatter_reduce_(0, dsts[on_tree].to(torch.int64), srcs[on_tree], "amin")
    return dist, torch.where(pred < v, pred, INVALID_VERTEX)


def _sssp_frontier(g: Graph, src_mask: torch.Tensor, cutoff: torch.Tensor):
    """Bellman-Ford over the frontier's out-edges: each round relaxes the
    edges of the vertices improved in the last one, then a second push
    takes as predecessor the smallest frontier src that achieves the new
    distance."""
    v = g.num_vertices
    dist = torch.where(src_mask, 0.0, float("inf")).to(WEIGHT_DTYPE)
    pred = torch.full((v,), INVALID_VERTEX, dtype=VERTEX_DTYPE, device=dist.device)

    def relax_op(s, d, sv, dv, w):
        cand = sv + (1.0 if w is None else w)
        return (cand < dv) & (cand <= cutoff), cand

    frontier, it = src_mask, 0
    while it < v and bool(frontier.any()):
        touched, cand = transform_reduce_v_frontier_outgoing_e_by_dst(
            g, frontier, relax_op, reduce_op=MINIMUM, src_values=dist, dst_values=dist
        )
        improved = touched & (cand < dist)
        new_dist = torch.where(improved, cand, dist)

        def pred_op(s, d, sv, dv, w):
            on_path = sv + (1.0 if w is None else w) == dv
            return improved.index_select(0, d) & on_path, s

        _, pred_cand = transform_reduce_v_frontier_outgoing_e_by_dst(
            g, frontier, pred_op, reduce_op=ANY, src_values=dist, dst_values=new_dist
        )
        pred = torch.where(improved, pred_cand, pred)
        dist, frontier, it = new_dist, improved, it + 1
    return dist, pred


def sssp(g: Graph, source, cutoff: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-source shortest paths (non-negative weights; 1 on an
    unweighted graph) on the graph's device. Returns (distances float32,
    predecessors int32); unreachable vertices, and those beyond
    ``cutoff``, get +inf and -1."""
    src_mask = _source_mask(g, source)
    c = torch.tensor(float("inf") if cutoff is None else cutoff, dtype=WEIGHT_DTYPE,
                     device=g.device)
    if (
        g.weighted
        and g.num_edges >= SSSP_SWEEP_MIN_EDGES
        and g.num_vertices <= SSSP_SWEEP_MAX_VERTICES
    ):
        return _sssp_sweeps(g, src_mask, c)
    return _sssp_frontier(g, src_mask, c)


def extract_bfs_paths(
    g: Graph, distances: torch.Tensor, predecessors: torch.Tensor, destinations
) -> Tuple[torch.Tensor, int]:
    """Paths from a BFS or SSSP result: (paths (n, max_path_length) int32,
    source first, padded with -1 at the front, max_path_length). As in the
    JAX package, max_path_length is 1 + the largest distance of a reached
    destination, truncated to an int."""
    dest = as_tensor(destinations, torch.int64, predecessors.device).reshape(-1)
    expects_vertex_ids(dest, g.num_vertices, "destinations")
    d = distances[dest]
    finite = (d != INVALID_DISTANCE) & torch.isfinite(d.to(torch.float32))
    max_len = int(torch.where(finite, d, 0).max()) + 1
    cur = dest.to(VERTEX_DTYPE)
    steps = []
    for _ in range(max_len):
        steps.append(cur)
        cur = torch.where(cur >= 0, predecessors[cur.clamp(min=0)], INVALID_VERTEX)
    return torch.stack(steps, 1).flip(1), max_len


def two_hop_neighbors(g: Graph) -> Tuple[torch.Tensor, torch.Tensor]:
    """All (v, w) pairs, v != w, joined by a path of exactly two hops,
    sorted and unique, as int32 tensors on the graph's device."""
    csr = g.csr()
    owner, epos = _out_edges(csr.offsets, csr.minors.to(torch.int64))
    first, second = csr.majors[owner].to(torch.int64), csr.minors[epos].to(torch.int64)
    keep = first != second
    pairs = torch.unique(first[keep] * g.num_vertices + second[keep])
    return (
        (pairs // g.num_vertices).to(VERTEX_DTYPE),
        (pairs % g.num_vertices).to(VERTEX_DTYPE),
    )
