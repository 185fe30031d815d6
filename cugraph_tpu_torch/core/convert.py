"""Structure transforms: decompress to an edge list, transpose, relabel,
induced subgraph.

Counterpart of ``cugraph_tpu/core/convert.py`` (ref:
cpp/src/structure/decompress_to_edgelist, transpose_graph_impl,
relabel_impl.cuh, induced_subgraph_impl.cuh; graph_view.hpp:778-782,
graph_functions.hpp:430,474). The edge list stays on the graph's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.device import as_tensor
from ..utils.dtypes import VERTEX_DTYPE
from .csr import Graph, from_edgelist


def decompress_to_edgelist(
    g: Graph,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(src, dst, weight) in the order of the CSR, or of the CSC when the
    graph was stored without a CSR."""
    if g.out_adj is not None:
        return g.out_adj.majors, g.out_adj.minors, g.out_adj.weights
    return g.in_adj.minors, g.in_adj.majors, g.in_adj.weights


def transpose(g: Graph) -> Graph:
    """Reverse every edge."""
    src, dst, w = decompress_to_edgelist(g)
    return from_edgelist(
        dst, src, w, num_vertices=g.num_vertices, is_symmetric=g.is_symmetric,
        device=g.device,
    )


def relabel(g: Graph, old_to_new) -> Graph:
    """Relabel vertex ids by a permutation map (ref: relabel_impl.cuh)."""
    src, dst, w = decompress_to_edgelist(g)
    old_to_new = as_tensor(old_to_new, torch.int64, g.device)
    return from_edgelist(
        old_to_new[src], old_to_new[dst], w, num_vertices=g.num_vertices,
        is_symmetric=g.is_symmetric, device=g.device,
    )


def induced_subgraph(
    g: Graph, vertices, relabel_result: bool = True
) -> Tuple[Graph, torch.Tensor]:
    """Subgraph induced by a vertex subset. Returns (subgraph, vertex_map):
    vertex_map holds the subset's ids, sorted and unique (int32), and with
    ``relabel_result`` subgraph vertex i is original vertex vertex_map[i]
    (ref: extract_induced_subgraphs, graph_functions.hpp:474, for one
    subgraph)."""
    vertices = torch.unique(as_tensor(vertices, torch.int64, g.device))
    member = torch.zeros(g.num_vertices, dtype=torch.bool, device=g.device)
    member[vertices] = True
    src, dst, w = decompress_to_edgelist(g)
    keep = member[src] & member[dst]
    src, dst = src[keep], dst[keep]
    if w is not None:
        w = w[keep]
    nv = g.num_vertices
    if relabel_result:
        old_to_new = torch.full((nv,), -1, dtype=VERTEX_DTYPE, device=g.device)
        old_to_new[vertices] = torch.arange(
            vertices.numel(), dtype=VERTEX_DTYPE, device=g.device
        )
        src, dst = old_to_new[src], old_to_new[dst]
        nv = vertices.numel()
    sub = from_edgelist(
        src, dst, w, num_vertices=nv, is_symmetric=g.is_symmetric, device=g.device
    )
    return sub, vertices.to(VERTEX_DTYPE)
