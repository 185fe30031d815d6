"""Link prediction: Jaccard, Sorensen, overlap and cosine coefficients,
plain and weighted, and the all-pairs form.

Counterpart of ``cugraph_tpu/algos/link_prediction.py`` (ref:
cpp/src/link_prediction/similarity_impl.cuh, the similarity functor :72).
Pairs default to the endpoints of every edge, each undirected edge once
(u < v) on a symmetric graph. Every coefficient comes from one pass of
``per_v_pair_dst_nbr_intersection``, which expands each pair's endpoint
of lower degree a chunk at a time, where the JAX package tiles every pair
by the graph's largest degree. The coefficients are the JAX package's
float32 expressions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.convert import decompress_to_edgelist
from ..core.csr import Graph
from ..prims.intersection import per_v_pair_dst_nbr_intersection
from ..utils.device import as_tensor
from ..utils.dtypes import VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects


def _default_pairs(g: Graph) -> Tuple[torch.Tensor, torch.Tensor]:
    src, dst, _ = decompress_to_edgelist(g)
    if g.is_symmetric:
        keep = src < dst
        src, dst = src[keep], dst[keep]
    return src, dst


def _similarity(g: Graph, pairs, kind: str, use_weight: bool):
    expects(g.is_symmetric, f"{kind} requires a symmetric graph")
    if kind not in ("jaccard", "sorensen", "overlap", "cosine"):
        raise ValueError(kind)
    if pairs is None:
        v1, v2 = _default_pairs(g)
    else:
        v1 = as_tensor(pairs[0], VERTEX_DTYPE, g.device).reshape(-1)
        v2 = as_tensor(pairs[1], VERTEX_DTYPE, g.device).reshape(-1)
    if use_weight:
        expects(g.weighted, "weighted similarity requires edge weights")
        # vertex weight w_x = sum of x's edge weights; a pair's intersection
        # weighs the w_x of its common neighbours, an endpoint's size the
        # w_x of its own neighbours (ref similarity_impl.cuh weighted path).
        # The sums run in float64, as the intersection's does: a hub's sums
        # take ~10^4 terms, and float32 atomics in a varying order would
        # move the coefficient by ~1e-5 of itself from run to run.
        adj = g.csr()
        majors = adj.majors.long()
        vw = torch.zeros(adj.num_majors, dtype=torch.float64, device=g.device)
        vw.index_add_(0, majors, adj.weights.to(torch.float64))
        _, inter_f = per_v_pair_dst_nbr_intersection(g, v1, v2, vertex_weights=vw)
        nbr_wsum = torch.zeros_like(vw).index_add_(0, majors, vw[adj.minors.long()])
        nbr_wsum = nbr_wsum.to(WEIGHT_DTYPE)
        a, b = nbr_wsum[v1.long()], nbr_wsum[v2.long()]
    else:
        inter, _ = per_v_pair_dst_nbr_intersection(g, v1, v2)
        deg = g.out_degrees().to(WEIGHT_DTYPE)
        a, b = deg[v1.long()], deg[v2.long()]
        inter_f = inter.to(WEIGHT_DTYPE)

    if kind == "jaccard":
        denom = a + b - inter_f
    elif kind == "sorensen":
        denom = a + b
        inter_f = 2.0 * inter_f
    elif kind == "overlap":
        denom = torch.minimum(a, b)
    else:
        denom = torch.sqrt(a * b)
    coeff = torch.where(denom > 0, inter_f / torch.clamp(denom, min=1e-30), 0.0)
    return v1, v2, coeff


def jaccard(g: Graph, pairs=None, use_weight: bool = False):
    """Jaccard coefficients |N(u) ∩ N(v)| / |N(u) ∪ N(v)|. pairs: (v1, v2)
    arrays, default every edge u < v. Returns (v1, v2, coeff)."""
    return _similarity(g, pairs, "jaccard", use_weight)


def sorensen(g: Graph, pairs=None, use_weight: bool = False):
    """Sorensen coefficients 2 |N(u) ∩ N(v)| / (|N(u)| + |N(v)|)."""
    return _similarity(g, pairs, "sorensen", use_weight)


def overlap(g: Graph, pairs=None, use_weight: bool = False):
    """Overlap coefficients |N(u) ∩ N(v)| / min(|N(u)|, |N(v)|)."""
    return _similarity(g, pairs, "overlap", use_weight)


def cosine(g: Graph, pairs=None, use_weight: bool = False):
    """Cosine coefficients |N(u) ∩ N(v)| / sqrt(|N(u)| |N(v)|)."""
    return _similarity(g, pairs, "cosine", use_weight)


def all_pairs_similarity(g: Graph, kind: str = "jaccard", topk: Optional[int] = None):
    """``kind`` over every two-hop pair (u < v on a symmetric graph),
    unweighted; with ``topk``, the topk largest coefficients, ties in pair
    order (a stable sort, as the JAX package's)."""
    from .traversal import two_hop_neighbors

    v1, v2 = two_hop_neighbors(g)
    if g.is_symmetric:
        keep = v1 < v2
        v1, v2 = v1[keep], v2[keep]
    v1, v2, coeff = _similarity(g, (v1, v2), kind, False)
    if topk is not None:
        idx = torch.argsort(-coeff, stable=True)[: int(topk)]
        return v1[idx], v2[idx], coeff[idx]
    return v1, v2, coeff
