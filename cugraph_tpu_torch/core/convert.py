"""Structure transforms: decompress to an edge list, transpose.

Counterpart of ``cugraph_tpu/core/convert.py`` (ref:
cpp/src/structure/decompress_to_edgelist, transpose_graph_impl;
graph_view.hpp:778-782). The edge list stays on the graph's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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
