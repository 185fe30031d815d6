"""Dense-adjacency SpMM for small vertex sets.

Counterpart of ``cugraph_tpu/prims/dense_spmm.py``: for V up to 8192 (GNN
minibatch blocks) one dense (V, V) adjacency and one matmul aggregate every
destination. The JAX package computes it outside any Pallas kernel, so the
port uses ``torch.matmul``.
"""

from __future__ import annotations

from typing import Optional

import torch

DENSE_MAX_VERTICES = 8192


def dense_adj_for(graph, *, use_weights: bool = False) -> Optional[torch.Tensor]:
    """Dense (V, V) float32 in-adjacency on the graph's device, or None if
    V is 0 or above 8192: A[dst, src] = w, so A @ X sums incoming
    neighbour rows into each destination; multi-edges accumulate."""
    v = graph.num_vertices
    if v == 0 or v > DENSE_MAX_VERTICES:
        return None
    adj = graph.csc()
    w = adj.weights if use_weights else None
    if w is None:
        w = torch.ones(adj.num_edges, dtype=torch.float32, device=adj.minors.device)
    a = torch.zeros((v, v), dtype=torch.float32, device=adj.minors.device)
    a.index_put_((adj.majors.long(), adj.minors.long()), w, accumulate=True)
    return a


def dense_spmm(a: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """out[v, :] = sum over u of A[v, u] * features[u, :], in f32."""
    return torch.matmul(a, features.to(torch.float32)).to(features.dtype)
