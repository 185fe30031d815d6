"""Community detection: modularity, Louvain, Leiden, triangle count, k-truss,
ECG, ego graph, spectral clustering and the clustering metrics.

Counterpart of ``cugraph_tpu/algos/community.py`` (ref:
cpp/src/community/louvain_impl.cuh, detail/common_methods.cuh,
leiden_impl.cuh, triangle_count_impl.cuh, legacy/{ecg.cu, ktruss.cu,
egonet.cu, spectral_clustering.cu}). None of them reaches a TPU kernel in
the JAX package: they are segment reductions, sorts and host loops, and
here they are plain torch on the graph's device.

Louvain's sweep is the JAX package's, term for term: per-(vertex,
neighbor-cluster) weights from the keyed prim, the best move by a
segment max with the smallest key among ties, a move only where it beats
staying by more than 1e-9, and alternating up/down sweeps. The
expressions keep the JAX order of operations, so on an unweighted graph
(where every weight sum is a small integer) the labels are the same.
The level loops and the contraction between levels run on the host, as
in the JAX package and the reference (graph sizes change per level).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.coarsen import coarsen_graph
from ..core.convert import decompress_to_edgelist, induced_subgraph
from ..core.csr import Graph, from_edgelist
from ..prims.intersection import (
    degree_oriented_adj,
    edge_triangle_support,
    triangle_counts_per_vertex,
)
from ..prims.keyed import aggregate_outgoing_e_by_dst_key
from ..prims.transform_e import transform_reduce_e
from ..utils.device import as_tensor
from ..utils.dtypes import VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects

# ---------------------------------------------------------------- modularity


def modularity(g: Graph, labels, resolution: float = 1.0) -> float:
    """Modularity of a clustering (ref: common_methods.cuh
    compute_modularity), f32 on the graph's device. The graph must be
    symmetric (each undirected edge stored in both directions). A label
    names a cluster and may be any integer, negative or >= V: the labels
    are compacted to [0, clusters) before they index Sigma, so Q is
    networkx's for any labels. The JAX package's segment sum drops the
    Sigma of a label outside [0, V) and returns another Q there."""
    expects(g.is_symmetric, "modularity requires a symmetric graph")
    labels = as_tensor(labels, torch.int64, g.device).reshape(-1)
    expects(labels.numel() == g.num_vertices, "modularity: one label per vertex")
    _, labels = torch.unique(labels, return_inverse=True)
    # Q = intra / m2 - r * sum_c (Sigma_c / m2)^2, m2 = total directed weight
    k = g.out_weight_sums()
    m2 = k.sum().clamp(min=1e-30)

    def intra_op(s, d, sv, dv, w):
        same = (sv == dv).to(WEIGHT_DTYPE)
        return same if w is None else same * w

    intra = transform_reduce_e(g, intra_op, src_values=labels, dst_values=labels)
    sigma = torch.zeros(g.num_vertices, dtype=WEIGHT_DTYPE, device=g.device)
    sigma.index_add_(0, labels, k)
    return float(intra / m2 - resolution * ((sigma / m2) ** 2).sum())


# ------------------------------------------------------------------ Louvain


def _louvain_one_level(
    g: Graph,
    resolution: float,
    max_sweeps: int,
    labels0: Optional[torch.Tensor] = None,
    constraint: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int]:
    """Local moving: returns (labels int32, number of moves).

    Score of vertex v joining cluster c (terms constant in v dropped):
        f(v, c) = w_{v->c\\{v}} - resolution * k_v * Sigma_{c\\{v}} / m2
    v moves to the best c if that beats staying by more than 1e-9. Even
    sweeps allow only moves to larger labels, odd sweeps only to smaller
    (the reference's up/down flag), which keeps the synchronous update from
    oscillating. Sweeps run in up+down pairs until a pair moves nothing or
    ``max_sweeps`` sweeps have run. ``constraint``: a (V,) community per
    vertex that moves must stay within (Leiden's refinement)."""
    v = g.num_vertices
    dev = g.device
    k = g.out_weight_sums()
    m2 = k.sum().clamp(min=1e-30)
    adj = g.csr()
    w_all = adj.weights if adj.weights is not None else torch.ones(
        adj.num_edges, dtype=WEIGHT_DTYPE, device=dev)
    self_w = torch.zeros(v, dtype=WEIGHT_DTYPE, device=dev)
    self_w.index_add_(0, adj.majors, torch.where(adj.majors == adj.minors, w_all, 0.0))
    neg_inf = torch.tensor(float("-inf"), dtype=WEIGHT_DTYPE, device=dev)

    def sweep(labels: torch.Tensor, it: int) -> Tuple[torch.Tensor, torch.Tensor]:
        lab64 = labels.to(torch.int64)
        sigma = torch.zeros(v, dtype=WEIGHT_DTYPE, device=dev).index_add_(0, lab64, k)
        srcs, keys, w_vc, run_valid = aggregate_outgoing_e_by_dst_key(g, labels)
        s64, k64 = srcs.to(torch.int64), keys.to(torch.int64)
        lv = labels[s64]
        kv = k[s64]
        own = keys == lv
        sig_c = sigma[k64] - torch.where(own, kv, 0.0)
        w_adj = w_vc - torch.where(own, self_w[s64], 0.0)
        score = w_adj - resolution * kv * sig_c / m2
        allowed = run_valid & ~own & ((keys > lv) if it % 2 == 0 else (keys < lv))
        if constraint is not None:
            allowed &= constraint[k64] == constraint[s64]
        best = torch.full((v,), float("-inf"), dtype=WEIGHT_DTYPE, device=dev)
        best.scatter_reduce_(0, s64, torch.where(allowed, score, neg_inf), "amax")
        # tie-break: the smallest key among the runs that reach the max
        at_best = allowed & (score >= best[s64] - 0.0)
        best_key = torch.full((v,), v, dtype=torch.int32, device=dev)
        best_key.scatter_reduce_(0, s64, torch.where(at_best, keys, v), "amin")
        own_w = torch.zeros(v, dtype=WEIGHT_DTYPE, device=dev)
        own_w.index_add_(0, s64, torch.where(run_valid & own, w_adj, 0.0))
        score_own = own_w - resolution * k * (sigma[lab64] - k) / m2
        do_move = (best > score_own + 1e-9) & (best_key < v)
        return torch.where(do_move, best_key, labels), do_move.sum()

    labels = (
        torch.arange(v, dtype=VERTEX_DTYPE, device=dev)
        if labels0 is None
        else as_tensor(labels0, VERTEX_DTYPE, dev)
    )
    total, it, moved = 0, 0, 1
    while moved > 0 and it < max_sweeps:
        labels, m_up = sweep(labels, it)
        labels, m_down = sweep(labels, it + 1)
        it += 2
        moved = int(m_up + m_down)
        total += moved
    return labels, total


def louvain(
    g: Graph, max_level: int = 100, resolution: float = 1.0, threshold: float = 1e-7
) -> Tuple[torch.Tensor, float]:
    """Louvain clustering: (labels (V,) int32, final modularity) (ref:
    louvain_impl.cuh, dendrogram loop :71, contraction :224). A level is
    kept only if it raises the modularity by more than ``threshold``."""
    expects(g.is_symmetric, "louvain requires a symmetric graph")
    cur = g
    labels_full = torch.arange(g.num_vertices, dtype=torch.int64, device=g.device)
    best_q = modularity(g, labels_full, resolution)  # singletons
    for _level in range(max_level):
        labels, moves = _louvain_one_level(cur, resolution, max_sweeps=64)
        if moves == 0:
            break
        coarse, _ = coarsen_graph(cur, labels)
        # vertex -> its cluster's index in the coarse graph
        _, compact = torch.unique(labels, sorted=True, return_inverse=True)
        cand_full = compact[labels_full]
        q = modularity(g, cand_full, resolution)
        if q <= best_q + threshold:
            break
        labels_full, best_q, cur = cand_full, q, coarse
        if coarse.num_vertices <= 1:
            break
    return labels_full.to(VERTEX_DTYPE), float(best_q)


def leiden(
    g: Graph, max_level: int = 100, resolution: float = 1.0, threshold: float = 1e-7
) -> Tuple[torch.Tensor, float]:
    """Leiden clustering (Traag et al. 2019; ref: leiden_impl.cuh):
    (labels (V,) int32 in [0, communities), final modularity).

    Each level: Louvain local moving gives partition P (seeded by the
    previous level's communities); a refinement restarts from singletons
    and moves vertices only within their P community; the graph is
    aggregated on the refined partition while P seeds the next level."""
    expects(g.is_symmetric, "leiden requires a symmetric graph")
    cur = g
    refc = torch.arange(g.num_vertices, dtype=torch.int64, device=g.device)  # orig -> cur
    best_labels = refc
    best_q = modularity(g, refc, resolution)
    labels0 = None  # level 0 starts from singletons
    for level in range(max_level):
        p_lab, moves = _louvain_one_level(cur, resolution, 64, labels0=labels0)
        if moves == 0 and level > 0:
            break
        r_lab, _ = _louvain_one_level(cur, resolution, 32, constraint=p_lab)
        cand = p_lab.to(torch.int64)[refc]  # the move phase's partition, flattened
        q = modularity(g, cand, resolution)
        if q <= best_q + threshold:
            break
        best_q, best_labels = q, cand
        coarse, cluster_ids = coarsen_graph(cur, r_lab)
        _, compact_r = torch.unique(r_lab, sorted=True, return_inverse=True)
        refc = compact_r[refc]
        # seed the next level with P projected onto the refined clusters
        _, labels0 = torch.unique(p_lab[cluster_ids.to(torch.int64)], return_inverse=True)
        cur = coarse
        if coarse.num_vertices <= 1:
            break
    _, out = torch.unique(best_labels, return_inverse=True)
    return out.to(VERTEX_DTYPE), float(best_q)


# --------------------------------------------------- triangles and k-truss


def _undirected_edges(g: Graph):
    """Each edge of a symmetric graph once, as (src, dst) with src < dst,
    and its weight (None if unweighted)."""
    src, dst, w = decompress_to_edgelist(g)
    keep = src < dst
    return src[keep], dst[keep], None if w is None else w[keep]


def triangle_count(g: Graph) -> torch.Tensor:
    """Per-vertex triangle counts, int32 (ref: triangle_count_impl.cuh).

    The graph must be symmetric; self-loops are dropped. Edges are oriented
    towards the higher (degree, id) and wedges expanded in chunks
    (``prims/intersection.py``); the JAX package orients by id, which gives
    the same counts on a simple graph."""
    expects(g.is_symmetric, "triangle_count requires a symmetric graph")
    src, dst, _ = _undirected_edges(g)
    oriented = degree_oriented_adj(src, dst, g.num_vertices)
    return triangle_counts_per_vertex(oriented, g.num_vertices)


def ktruss(g: Graph, k: int) -> Graph:
    """Maximal k-truss subgraph (ref: community/legacy/ktruss.cu): drop
    every edge whose triangle support is below k - 2 until none is, then
    return the surviving edges as a symmetric graph. Support comes from
    the chunked wedge closing of ``prims/intersection.py`` on a degree
    orientation; the JAX package probes a (E, max degree) candidate tile."""
    expects(g.is_symmetric, "ktruss requires a symmetric graph")
    src, dst, w = _undirected_edges(g)
    oriented = degree_oriented_adj(src, dst, g.num_vertices, w)
    while oriented.num_edges:
        strong = edge_triangle_support(oriented) >= k - 2
        if bool(strong.all()):
            break
        # the surviving edges, oriented again by their new degrees
        oriented = degree_oriented_adj(
            oriented.majors[strong], oriented.minors[strong], g.num_vertices,
            None if oriented.weights is None else oriented.weights[strong],
        )
    return from_edgelist(
        oriented.majors, oriented.minors, oriented.weights, num_vertices=g.num_vertices,
        symmetrize=True, device=g.device,
    )


# ------------------------------------------------------ ECG and ego graph


def ecg(
    g: Graph,
    min_weight: float = 0.05,
    ensemble_size: int = 16,
    seed: int = 0,
    resolution: float = 1.0,
) -> Tuple[torch.Tensor, float]:
    """Ensemble clustering for graphs (ref: community/legacy/ecg.cu): one
    Louvain level on each of ``ensemble_size`` randomly perturbed
    weightings, edges reweighted by how often their ends share a cluster,
    then a full Louvain.

    The perturbations are drawn on the host by
    ``np.random.default_rng(seed)``, as in the JAX package, so both draw
    the same weights; they run on the graph's device."""
    expects(g.is_symmetric, "ecg requires a symmetric graph")
    src, dst, w = decompress_to_edgelist(g)
    e = src.numel()
    if w is None:
        w = torch.ones(e, dtype=WEIGHT_DTYPE, device=g.device)
    rng = np.random.default_rng(seed)
    co = torch.zeros(e, dtype=WEIGHT_DTYPE, device=g.device)
    s64, d64 = src.to(torch.int64), dst.to(torch.int64)
    for _ in range(ensemble_size):
        noise = torch.from_numpy(rng.uniform(0.5, 1.5, size=e).astype(np.float32))
        gp = from_edgelist(
            src, dst, w * noise.to(g.device), num_vertices=g.num_vertices,
            is_symmetric=True, device=g.device,
        )
        labels, _ = _louvain_one_level(gp, resolution, max_sweeps=16)
        co += (labels[s64] == labels[d64]).to(WEIGHT_DTYPE)
    new_w = min_weight + (1.0 - min_weight) * co / ensemble_size
    gw = from_edgelist(
        src, dst, new_w, num_vertices=g.num_vertices, is_symmetric=True, device=g.device
    )
    return louvain(gw, resolution=resolution)


def ego_graph(g: Graph, seed_vertex: int, radius: int = 1) -> Tuple[Graph, torch.Tensor]:
    """Subgraph induced by the vertices within ``radius`` hops of the seed:
    (subgraph, vertex_map) (ref: community/legacy/egonet.cu)."""
    from .traversal import INVALID_DISTANCE, bfs

    dist, _ = bfs(g, seed_vertex, depth_limit=radius)
    inside = torch.nonzero((dist != INVALID_DISTANCE) & (dist <= radius)).squeeze(1)
    return induced_subgraph(g, inside)


# --------------------------------------- spectral clustering and metrics


def _kmeans(x: np.ndarray, k: int, seed: int = 0, iters: int = 50) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=k, replace=False)]
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d.argmin(1)
        for c in range(k):
            pts = x[assign == c]
            if len(pts):
                centers[c] = pts.mean(0)
    return assign.astype(np.int32)


def _host_edges(g: Graph):
    src, dst, w = decompress_to_edgelist(g)
    w = np.ones(src.numel()) if w is None else w.cpu().numpy()
    return src.cpu().numpy(), dst.cpu().numpy(), w


def spectral_balanced_cut_clustering(
    g: Graph, num_clusters: int, num_eigenvectors: int = 2, seed: int = 0
) -> torch.Tensor:
    """Balanced-cut spectral clustering: eigenvectors of the normalized
    Laplacian, then k-means (ref: community/legacy/spectral_clustering.cu).

    Runs on the host by design, as in the JAX package ("HOST FALLBACK"
    there): scipy's ``eigsh`` and a numpy k-means, for the small graphs
    the legacy API targets; louvain and leiden are the on-device methods.
    The labels (int32) come back on the graph's device. Unlike the JAX
    function, ARPACK starts from a vector drawn from ``seed``, so a call
    repeats its result."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    src, dst, w = _host_edges(g)
    v = g.num_vertices
    a = sp.coo_matrix((w, (src, dst)), shape=(v, v)).tocsr()
    deg = np.asarray(a.sum(axis=1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = sp.eye(v) - sp.diags(dinv) @ a @ sp.diags(dinv)
    # a start vector from the seed: ARPACK's own is random per call, so
    # the JAX function's eigenvectors (and its clusters) vary between calls
    v0 = np.random.default_rng(seed).uniform(-1, 1, v)
    _, vecs = spla.eigsh(lap, k=min(num_eigenvectors + 1, v - 1), which="SM", v0=v0)
    emb = vecs[:, 1 : num_eigenvectors + 1]
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    return torch.from_numpy(_kmeans(emb, num_clusters, seed)).to(g.device)


def spectral_modularity_maximization_clustering(
    g: Graph, num_clusters: int, num_eigenvectors: int = 2, seed: int = 0
) -> torch.Tensor:
    """Modularity-maximization spectral clustering: the leading eigenvectors
    of B = A - k k^T / 2m, then k-means (ref: the same file).

    Runs on the host by design, as in the JAX package: a dense V x V numpy
    ``eigh``. The labels (int32) come back on the graph's device."""
    src, dst, w = _host_edges(g)
    v = g.num_vertices
    a = np.zeros((v, v))
    a[src, dst] = w
    deg = a.sum(1)
    b = a - np.outer(deg, deg) / max(deg.sum(), 1e-12)
    _, vecs = np.linalg.eigh((b + b.T) / 2)
    emb = vecs[:, -num_eigenvectors:]
    return torch.from_numpy(_kmeans(emb, num_clusters, seed)).to(g.device)


def analyze_clustering_modularity(g: Graph, labels) -> float:
    """ref: algorithms.hpp:818-919, the analyze_clustering family."""
    return modularity(g, labels)


def analyze_clustering_edge_cut(g: Graph, labels) -> float:
    """Total weight of the edges between clusters (each undirected edge
    once on a symmetric graph)."""
    labels = as_tensor(labels, torch.int64, g.device)

    def cut_op(s, d, sv, dv, w):
        diff = (sv != dv).to(WEIGHT_DTYPE)
        return diff if w is None else diff * w

    cut = transform_reduce_e(g, cut_op, src_values=labels, dst_values=labels)
    return float(cut) / (2.0 if g.is_symmetric else 1.0)


def analyze_clustering_ratio_cut(g: Graph, labels) -> float:
    """Sum over clusters of (weight of the cluster's outgoing cut edges) /
    (cluster size), in float64."""
    labels = as_tensor(labels, torch.int64, g.device)
    n_clusters = int(labels.max()) + 1 if labels.numel() else 0
    sizes = torch.bincount(labels, minlength=n_clusters)
    src, dst, w = decompress_to_edgelist(g)
    w = torch.ones(src.numel(), dtype=torch.float64, device=g.device) if w is None else w.double()
    ls, ld = labels[src.to(torch.int64)], labels[dst.to(torch.int64)]
    cross = ls != ld
    cut_per = torch.zeros(n_clusters, dtype=torch.float64, device=g.device)
    cut_per.index_add_(0, ls[cross], w[cross])
    return float((cut_per / sizes.clamp(min=1)).sum())
