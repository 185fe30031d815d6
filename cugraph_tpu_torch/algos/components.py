"""Connected components: WCC on the prims, SCC on the host.

Counterpart of ``cugraph_tpu/algos/components.py`` (ref:
cpp/src/components/weakly_connected_components_impl.cuh and
components/legacy/scc_matrix.cuh).

WCC is min-label propagation with pointer jumping: each round pushes the
smaller label across every edge in both directions, then short-cuts
chains twice with label[v] <- label[label[v]]. The JAX package runs the
rounds in one ``while_loop``; here they are a host loop that reads one
``any()`` a round. Labels are the smallest vertex id of each component.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.convert import decompress_to_edgelist
from ..core.csr import Graph
from ..prims.per_v import per_v_transform_reduce_incoming_e, per_v_transform_reduce_outgoing_e
from ..prims.reduce_ops import MINIMUM
from ..utils.dtypes import VERTEX_DTYPE


def _min_nbr_label(g: Graph, labels: torch.Tensor) -> torch.Tensor:
    pushed = per_v_transform_reduce_incoming_e(
        g, lambda s, d, sv, dv, w: sv, reduce_op=MINIMUM, src_values=labels
    )
    pulled = per_v_transform_reduce_outgoing_e(
        g, lambda s, d, sv, dv, w: dv, reduce_op=MINIMUM, dst_values=labels
    )
    return torch.minimum(pushed, pulled)


def weakly_connected_components(g: Graph) -> torch.Tensor:
    """Component label per vertex (int32): the smallest vertex id in its
    component (ref: weakly_connected_components_impl.cuh)."""
    labels = torch.arange(g.num_vertices, dtype=VERTEX_DTYPE, device=g.device)
    while True:
        new = torch.minimum(labels, _min_nbr_label(g, labels))
        new = new[new.to(torch.int64)]
        new = new[new.to(torch.int64)]
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            return labels


def strongly_connected_components(g: Graph) -> torch.Tensor:
    """SCC labels (int32), each the smallest vertex id in its component.

    Runs on the host by design, as in the JAX package ("HOST FALLBACK"
    there): scipy's strong ``connected_components`` over the edge list
    copied to the host, O(V + E) host memory and time, like the
    reference's legacy single-GPU path (scc_matrix.cuh). The labels come
    back on the graph's device."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    src, dst, _ = decompress_to_edgelist(g)
    v = g.num_vertices
    m = sp.coo_matrix(
        (np.ones(src.numel(), dtype=np.int8), (src.cpu().numpy(), dst.cpu().numpy())),
        shape=(v, v),
    ).tocsr()
    _, raw = connected_components(m, directed=True, connection="strong")
    first = np.full(raw.max() + 1, v, dtype=np.int32)
    np.minimum.at(first, raw, np.arange(v, dtype=np.int32))
    return torch.from_numpy(first[raw]).to(g.device)
