"""Centrality: Katz, eigenvector, degree, betweenness and edge betweenness.

Counterpart of ``cugraph_tpu/algos/centrality.py`` (ref:
cpp/src/centrality/katz_centrality_impl.cuh, eigenvector_centrality_impl.cuh,
betweenness_centrality*.cu). Katz and eigenvector iterate
``pull_aggregate``, the ``spmv_sum`` kernel on the card, and read the L1
change on the host once per iteration.

Betweenness is Brandes' algorithm over a block of S sources at once, one
column of (V, S) state each: the path counts of a BFS level are one
``spmm_rows`` launch over the CSC for the whole block, and the
back-propagated dependencies of a level one over the CSR, where the JAX
package runs masked edge-centric segment sums (XLA, no Pallas kernel) for
every source at once (``vmap``). A block holds at most
``BRANDES_BLOCK`` sources (one warp pass of the kernel's wide layout) and
``BRANDES_BATCH_SLOTS`` entries of (V, S) state; edge betweenness reads
its per-edge values in one edge-centric pass a block, after the sweeps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.csr import Graph, _build_adj
from ..prims.cuda import pull_aggregate, spmm_rows
from ..utils.device import as_tensor
from ..utils.dtypes import INT32_MAX, VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects

# sources a Brandes block at most: the columns of one spmm_rows launch.
# 128 fills a warp of the kernel's wide layout (csrc/spmm_row.cu); a block
# of at most spmm_row.NARROW_MAX_F sources (sampled betweenness, a last
# block) takes its narrow layout, a few lanes to each edge's row
BRANDES_BLOCK = 128
# entries of a block's (V, S) state, and of the (edges, S) temporaries of
# its per-edge pass: 2^27 (512 MB in f32)
BRANDES_BATCH_SLOTS = 1 << 27


def katz_centrality(
    g: Graph,
    alpha: Optional[float] = None,
    beta: float = 1.0,
    max_iterations: int = 1000,
    tol: float = 1.0e-6,
    nstart=None,
    normalized: bool = True,
) -> Tuple[torch.Tensor, int]:
    """Katz centrality x = alpha * A^T x + beta. Returns (x, iterations).

    alpha defaults to 1 / (1 + max out-degree), read on the host, as in the
    reference's Python wrapper. normalized: x is divided by its L2 norm."""
    v = g.num_vertices
    dev = g.device
    if alpha is None:
        alpha = 1.0 / (int(g.out_degrees().max()) + 1)
    if nstart is not None:
        x = as_tensor(nstart, WEIGHT_DTYPE, dev)
    else:
        x = torch.zeros(v, dtype=WEIGHT_DTYPE, device=dev)
    diff, it = float("inf"), 0
    while diff > v * tol and it < max_iterations:
        new = alpha * pull_aggregate(g, x) + beta
        diff = float((new - x).abs().sum())
        x, it = new, it + 1
    if normalized:
        x = x / torch.linalg.vector_norm(x).clamp(min=1e-30)
    return x, it


def eigenvector_centrality(
    g: Graph,
    max_iterations: int = 1000,
    tol: float = 1.0e-6,
    nstart=None,
) -> Tuple[torch.Tensor, int]:
    """Eigenvector centrality by power iteration on A^T + I (the +x shift
    of NetworkX), L2-normalized each step. Returns (x, iterations)."""
    v = g.num_vertices
    dev = g.device
    if nstart is not None:
        x = as_tensor(nstart, WEIGHT_DTYPE, dev)
    else:
        x = torch.full((v,), 1.0 / v, dtype=WEIGHT_DTYPE, device=dev)
    diff, it = float("inf"), 0
    while diff > v * tol and it < max_iterations:
        new = pull_aggregate(g, x) + x
        new = new / torch.linalg.vector_norm(new).clamp(min=1e-30)
        diff = float((new - x).abs().sum())
        x, it = new, it + 1
    return x, it


def degree_centrality(g: Graph, normalized: bool = True) -> torch.Tensor:
    """In- plus out-degree, halved on a symmetric graph; divided by V - 1
    when normalized."""
    deg = g.out_degrees() + g.in_degrees()
    if g.is_symmetric:
        deg = deg // 2
    deg = deg.to(WEIGHT_DTYPE)
    if normalized:
        deg = deg / max(g.num_vertices - 1, 1)
    return deg


# ---------------------------------------------------------------------------
# Betweenness (Brandes), in blocks of sources.
# ---------------------------------------------------------------------------


def sample_sources(num_vertices: int, k: Optional[int], seed: int, device) -> torch.Tensor:
    """All vertices (k None) or k distinct vertices drawn from a CPU
    torch.Generator seeded with ``seed``; int32 on ``device``. The JAX
    package draws with jax.random, so the two pick different samples."""
    if k is None:
        return torch.arange(num_vertices, dtype=VERTEX_DTYPE, device=device)
    expects(0 <= int(k) <= num_vertices, f"k={k} out of range [0, {num_vertices}]")
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randperm(num_vertices, generator=gen)[: int(k)].to(VERTEX_DTYPE).to(device)


def _pull_adj(g: Graph):
    """The in-adjacency that the forward sweep pulls over: the CSC, or,
    for a graph stored without one, a CSC built from the CSR once."""
    if g.in_adj is not None or g.is_symmetric:
        return g.csc()
    adj = g.csr()
    return _build_adj(adj.minors, adj.majors, None, g.num_vertices, g.num_vertices)


def _brandes_block(g: Graph, pull, sources: torch.Tensor, edges: Optional[str]):
    """Brandes' sweeps (unweighted shortest paths) from S distinct sources
    at once, column s for sources[s]. Forward, level by level: sigma_next
    [w] = sum over in-edges (u, w) of sigma[u] on the frontier, one
    ``spmm_rows`` over ``pull`` (the CSC) a level. Backward, from the
    deepest level up: delta[u] = sigma[u] * sum over out-edges (u, w) one
    level down of (1 + delta[w]) / sigma[w], one ``spmm_rows`` over the CSR
    a level. Returns (delta (V, S), zero at the sources; the edge
    dependencies in the CSR's edge order, summed over the block (E,) with
    ``edges="sum"``, per source (S, E) with ``"each"``, else None; reach
    (V, S) bool, False at the source)."""
    v, dev = g.num_vertices, g.device
    adj = g.csr()
    s = sources.numel()
    at = (sources.to(torch.int64), torch.arange(s, device=dev))
    dist = torch.full((v, s), INT32_MAX, dtype=VERTEX_DTYPE, device=dev)
    dist[at] = 0
    sigma = torch.zeros((v, s), dtype=WEIGHT_DTYPE, device=dev)
    sigma[at] = 1.0
    frontier = dist == 0
    depth = 0
    while bool(frontier.any()):
        paths = spmm_rows(pull, torch.where(frontier, sigma, 0.0), use_weights=False)
        # every frontier vertex has sigma >= 1, so an unvisited vertex is
        # reached exactly where it receives a positive count
        frontier = (paths > 0) & (dist == INT32_MAX)
        depth += 1
        dist = torch.where(frontier, depth, dist)
        sigma = torch.where(frontier, paths, sigma)
    delta = torch.zeros_like(sigma)
    for d in range(depth - 2, -1, -1):
        x = torch.where(dist == d + 1, (1.0 + delta) / sigma.clamp(min=1e-30), 0.0)
        delta = torch.where(dist == d, delta + sigma * spmm_rows(adj, x, use_weights=False), delta)
    delta[at] = 0.0
    reach = dist != INT32_MAX
    reach[at] = False
    if edges is None:
        return delta, None, reach
    # edge (u, w) is on a shortest path from column s's source where
    # dist[w] = dist[u] + 1, and carries sigma[u] * (1 + delta[w]) / sigma[w];
    # a source is never such a w, so its zeroed delta is not read. The pass
    # gathers from (S, V) copies, so that a run of gathers reads one
    # source's (V,) values, not rows spread over the whole (V, S) state
    ratio_t = ((1.0 + delta) / sigma.clamp(min=1e-30)).t().contiguous()
    dist_t, sigma_t = dist.t().contiguous(), sigma.t().contiguous()
    out = torch.zeros((s, adj.num_edges) if edges == "each" else adj.num_edges,
                      dtype=WEIGHT_DTYPE, device=dev)
    step = max(1, BRANDES_BATCH_SLOTS // s)
    for lo in range(0, adj.num_edges, step):
        u, w = adj.majors[lo:lo + step], adj.minors[lo:lo + step]
        on = dist_t.index_select(1, w) - 1 == dist_t.index_select(1, u)
        val = torch.where(on, sigma_t.index_select(1, u) * ratio_t.index_select(1, w), 0.0)
        if edges == "each":
            out[:, lo:lo + step] = val
        else:
            out[lo:lo + step] = val.sum(0)
    return delta, out, reach


def _brandes_batch(
    g: Graph, sources: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dependencies of one block of distinct sources, per source: (delta
    (S, V), edge_delta (S, E) in the CSR's edge order, reach (S, V) bool,
    False at the source)."""
    delta, edge_delta, reach = _brandes_block(g, _pull_adj(g), sources, "each")
    return delta.t(), edge_delta, reach.t()


def _brandes_sums(g: Graph, sources: torch.Tensor, with_edges: bool = True):
    """Sums over the sources of Brandes' dependencies, a block of
    ``min(BRANDES_BLOCK, BRANDES_BATCH_SLOTS // V)`` sources at a time:
    (delta (V,), edge_delta (E,) or None, sources reaching each vertex
    (V,), vertices each source reaches (S,))."""
    v, e = g.num_vertices, g.num_edges
    dev = g.device
    block = max(1, min(BRANDES_BLOCK, BRANDES_BATCH_SLOTS // max(v, 1)))
    pull = _pull_adj(g)
    delta = torch.zeros(v, dtype=WEIGHT_DTYPE, device=dev)
    edge_delta = torch.zeros(e, dtype=WEIGHT_DTYPE, device=dev) if with_edges else None
    reached_by = torch.zeros(v, dtype=torch.int64, device=dev)
    reaches = torch.zeros(sources.numel(), dtype=torch.int64, device=dev)
    for i in range(0, sources.numel(), block):
        d, ed, r = _brandes_block(g, pull, sources[i : i + block], "sum" if with_edges else None)
        delta += d.sum(1)
        if with_edges:
            edge_delta += ed
        reached_by += r.sum(1)
        reaches[i : i + block] = r.sum(0)
    return delta, edge_delta, reached_by, reaches


def betweenness_centrality(
    g: Graph,
    k: Optional[int] = None,
    normalized: bool = True,
    endpoints: bool = False,
    seed: int = 0,
) -> torch.Tensor:
    """Vertex betweenness (Brandes, unweighted shortest paths). k: sample
    k sources (``sample_sources``); None takes every vertex."""
    v = g.num_vertices
    sources = sample_sources(v, k, seed, g.device)
    bc, _, reached_by, reaches = _brandes_sums(g, sources, with_edges=False)
    if endpoints:
        # each reachable (s, t) pair adds 1 to both endpoints
        bc = bc + reached_by
        bc = bc.index_add(0, sources, reaches.to(WEIGHT_DTYPE))
    if k is not None:
        bc = bc * (v / max(int(k), 1))
    if g.is_symmetric:
        bc = bc / 2.0
    if normalized and v > 2:
        denom = v * (v - 1) if endpoints else (v - 1) * (v - 2)
        if g.is_symmetric:
            denom = denom / 2.0  # undirected pairs
        bc = bc / denom
    return bc


def edge_betweenness_centrality(
    g: Graph, k: Optional[int] = None, normalized: bool = True, seed: int = 0
) -> torch.Tensor:
    """Edge betweenness over the edges of g.csr(), in its order (E,)."""
    v = g.num_vertices
    sources = sample_sources(v, k, seed, g.device)
    _, ebc, _, _ = _brandes_sums(g, sources)
    if k is not None:
        ebc = ebc * (v / max(int(k), 1))
    if g.is_symmetric:
        ebc = ebc / 2.0
    if normalized:
        denom = v * (v - 1)
        if g.is_symmetric:
            denom = denom / 2.0
        ebc = ebc / max(denom, 1)
    return ebc
