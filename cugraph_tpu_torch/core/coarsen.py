"""Graph coarsening: relabel vertices by cluster and merge their edges.

Counterpart of ``cugraph_tpu/core/coarsen.py`` (ref:
cpp/src/structure/coarsen_graph_impl.cuh, used by Louvain through
graph_contraction, common_methods.hpp:85). The JAX package contracts on
the host in numpy; the port relabels and coalesces on the graph's device,
with the same sort order, so parallel edges merge in the same order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.device import as_tensor
from ..utils.dtypes import VERTEX_DTYPE
from .convert import decompress_to_edgelist
from .csr import Graph, from_edgelist
from .symmetrize import coalesce_edgelist


def coarsen_graph(g: Graph, labels) -> Tuple[Graph, torch.Tensor]:
    """Contract g by vertex labels; parallel edges merge with summed
    weights (1 for an unweighted edge).

    Returns (coarse_graph, cluster_ids): coarse vertex i is the cluster
    whose original label is cluster_ids[i] (sorted, int32). Intra-cluster
    edges stay as self-loops, which Louvain's modularity needs."""
    labels = as_tensor(labels, torch.int64, g.device)
    uniq, compact = torch.unique(labels, sorted=True, return_inverse=True)
    src, dst, w = decompress_to_edgelist(g)
    if w is None:
        w = torch.ones(src.numel(), dtype=torch.float32, device=g.device)
    csrc, cdst, cw = coalesce_edgelist(compact[src], compact[dst], w, "sum", device=g.device)
    coarse = from_edgelist(
        csrc, cdst, cw, num_vertices=uniq.numel(), is_symmetric=g.is_symmetric,
        device=g.device,
    )
    return coarse, uniq.to(VERTEX_DTYPE)
