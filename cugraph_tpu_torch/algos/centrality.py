"""Centrality: Katz, eigenvector, degree, betweenness and edge betweenness.

Counterpart of ``cugraph_tpu/algos/centrality.py`` (ref:
cpp/src/centrality/katz_centrality_impl.cuh, eigenvector_centrality_impl.cuh,
betweenness_centrality*.cu). Katz and eigenvector iterate
``pull_aggregate``, the ``spmv_sum`` kernel on the card, and read the L1
change on the host once per iteration.

Betweenness is Brandes' algorithm batched over sources, in plain torch as
the JAX package computes it outside any Pallas kernel: the forward BFS and
the backward dependency sweep are masked edge-centric passes over (S, V)
state. The JAX package takes every source at once (``vmap``); the port
takes ``BRANDES_BATCH_SLOTS // E`` sources at a time, which bounds its
(S, E) temporaries, and sums the batches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.csr import Graph
from ..prims.cuda import pull_aggregate
from ..utils.device import as_tensor
from ..utils.dtypes import INT32_MAX, VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects

# sources x edges per Brandes batch: each (S, E) temporary is at most
# 2^27 entries (512 MB in f32)
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
# Betweenness (Brandes), batched over sources.
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


def _brandes_batch(
    g: Graph, sources: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dependencies of one batch of distinct sources: (delta (S, V),
    edge_delta (S, E) in the CSR's edge order, reach (S, V) bool, False at
    the source). Unweighted shortest paths, as the reference's legacy SG
    betweenness."""
    v = g.num_vertices
    dev = g.device
    adj = g.csr()
    src_ids, dst_ids = adj.majors, adj.minors
    s = sources.numel()
    rows = torch.arange(s, device=dev)
    cols = sources.to(torch.int64)

    dist = torch.full((s, v), INT32_MAX, dtype=VERTEX_DTYPE, device=dev)
    dist[rows, cols] = 0
    sigma = torch.zeros(s, v, dtype=WEIGHT_DTYPE, device=dev)
    sigma[rows, cols] = 1.0
    frontier = dist == 0
    depth = 0
    while bool(frontier.any()):
        con = frontier.index_select(1, src_ids) & (dist.index_select(1, dst_ids) == INT32_MAX)
        paths = torch.where(con, sigma.index_select(1, src_ids), 0.0)
        sig_add = torch.zeros_like(sigma).index_add_(1, dst_ids, paths)
        del con, paths
        # every frontier vertex has sigma >= 1, so a vertex is reached
        # exactly where it receives a positive count
        frontier = sig_add > 0
        depth += 1
        dist = torch.where(frontier, depth, dist)
        sigma += sig_add

    # backward sweep: from the deepest level up, delta[u] += sigma[u] /
    # sigma[w] * (1 + delta[w]) over edges u -> w with dist[w] = dist[u] + 1
    delta = torch.zeros_like(sigma)
    edge_delta = torch.zeros(s, adj.num_edges, dtype=WEIGHT_DTYPE, device=dev)
    for d in range(depth - 2, -1, -1):
        on_path = (dist.index_select(1, src_ids) == d) & (dist.index_select(1, dst_ids) == d + 1)
        ratio = sigma.index_select(1, src_ids) / sigma.index_select(1, dst_ids).clamp(min=1e-30)
        contrib = torch.where(on_path, ratio * (1.0 + delta.index_select(1, dst_ids)), 0.0)
        del on_path, ratio
        edge_delta += contrib  # each edge is on a path at one level only
        delta.index_add_(1, src_ids, contrib)
    delta[rows, cols] = 0.0
    reach = dist != INT32_MAX
    reach[rows, cols] = False
    return delta, edge_delta, reach


def _brandes_sums(g: Graph, sources: torch.Tensor):
    """Sums over the sources of _brandes_batch, a batch at a time:
    (delta (V,), edge_delta (E,), sources reaching each vertex (V,),
    vertices each source reaches (S,))."""
    v, e = g.num_vertices, g.num_edges
    dev = g.device
    batch = max(1, BRANDES_BATCH_SLOTS // max(e, 1))
    delta = torch.zeros(v, dtype=WEIGHT_DTYPE, device=dev)
    edge_delta = torch.zeros(e, dtype=WEIGHT_DTYPE, device=dev)
    reached_by = torch.zeros(v, dtype=torch.int64, device=dev)
    reaches = torch.zeros(sources.numel(), dtype=torch.int64, device=dev)
    for i in range(0, sources.numel(), batch):
        d, ed, r = _brandes_batch(g, sources[i : i + batch])
        delta += d.sum(0)
        edge_delta += ed.sum(0)
        reached_by += r.sum(0)
        reaches[i : i + batch] = r.sum(1)
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
    bc, _, reached_by, reaches = _brandes_sums(g, sources)
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
