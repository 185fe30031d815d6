"""Frontier push prim: the SSSP frontier branch's relaxation.

Counterpart of ``cugraph_tpu/prims/frontier.py`` (ref:
cpp/src/prims/transform_reduce_v_frontier_outgoing_e_by_dst.cuh :337).
As in the JAX package the frontier is a dense boolean mask over vertices,
and "emit (dst, payload) and reduce by dst" is an edge-centric masked
segment reduction over the CSR. The JAX package's ``update_v_frontier`` is
an elementwise pass-through, so SSSP applies its update inline.

The e_op returns (keep, payload) from per-edge tensors:
    e_op(src_ids, dst_ids, src_value, dst_value, weight) -> (keep, payload)
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core.csr import Graph
from .per_v import _gather
from .reduce_ops import ReduceOp


def transform_reduce_v_frontier_outgoing_e_by_dst(
    g: Graph,
    frontier_mask: torch.Tensor,
    e_op: Callable,
    *,
    reduce_op: ReduceOp,
    src_values: Optional[torch.Tensor] = None,
    dst_values: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Push along the outgoing edges of frontier vertices and reduce the
    kept payloads by dst. Returns (touched (V,) bool: dst received a
    payload, reduced (V, ...): reduce_op over them, the identity where
    untouched)."""
    adj = g.csr()
    src_ids, dst_ids = adj.majors, adj.minors
    keep, payload = e_op(
        src_ids, dst_ids, _gather(src_values, src_ids), _gather(dst_values, dst_ids),
        adj.weights,
    )
    keep = keep & frontier_mask.index_select(0, src_ids)
    dst_kept = dst_ids[keep]
    reduced = reduce_op.segment(payload[keep], dst_kept, g.num_vertices)
    touched = torch.zeros(g.num_vertices, dtype=torch.bool, device=keep.device)
    touched[dst_kept] = True
    return touched, reduced
