"""Minimum and maximum spanning tree (forest).

Counterpart of ``cugraph_tpu/algos/tree.py`` (ref: cpp/src/tree/mst.cu,
which delegates to raft's MST solver). It runs on the host by design, as
in the JAX package and as ``strongly_connected_components`` does here:
the edge list is copied to the host, scipy's MST runs on the same
multiset, in the same order, as the JAX package hands it (parallel edges
summed by ``tocsr``, as there), and the tree comes back on the graph's
device. O(V + E) host memory and time.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.convert import decompress_to_edgelist
from ..core.csr import Graph
from ..utils.dtypes import VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects


def _spanning_tree(g: Graph, maximum: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    import scipy.sparse as sp
    from scipy.sparse.csgraph import minimum_spanning_tree as scipy_mst

    expects(g.is_symmetric, "spanning tree requires a symmetric graph")
    src, dst, w = decompress_to_edgelist(g)
    src, dst = src.cpu().numpy(), dst.cpu().numpy()
    w = np.ones(len(src), np.float32) if w is None else w.cpu().numpy()
    sign = -1.0 if maximum else 1.0
    v = g.num_vertices
    m = sp.coo_matrix((sign * w.astype(np.float64), (src, dst)), shape=(v, v)).tocsr()
    t = scipy_mst(m).tocoo()
    return (
        torch.from_numpy(t.row.astype(np.int32)).to(g.device, VERTEX_DTYPE),
        torch.from_numpy(t.col.astype(np.int32)).to(g.device, VERTEX_DTYPE),
        torch.from_numpy((sign * t.data).astype(np.float32)).to(g.device, WEIGHT_DTYPE),
    )


def minimum_spanning_tree(g: Graph):
    """(src, dst, weight) of the minimum spanning forest's edges: int32,
    int32 and float32 tensors on the graph's device, one entry per tree
    edge. An unweighted graph counts 1 an edge."""
    return _spanning_tree(g, maximum=False)


def maximum_spanning_tree(g: Graph):
    """As ``minimum_spanning_tree``, for the largest total weight."""
    return _spanning_tree(g, maximum=True)
