"""per_v_transform_reduce_{incoming,outgoing}_e, the generalized SpMV/SpMM.

Counterpart of ``cugraph_tpu/prims/per_v.py`` (ref:
cpp/src/prims/per_v_transform_reduce_incoming_outgoing_e.cuh:1082,1144).
For every vertex, reduce an edge operator over its incoming (or outgoing)
edges: gather with ``index_select``, apply the e_op, reduce by major.

The e_op is a vectorized function of per-edge tensors:
    e_op(src_ids, dst_ids, src_value, dst_value, weight) -> per-edge value
where src_value/dst_value are the gathered per-vertex inputs (None if not
supplied) and weight is None for unweighted graphs. Values may be (E,) or
(E, F). This plain path is what the CUDA kernels are checked against.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.csr import CompressedAdj, Graph
from .reduce_ops import PLUS, ReduceOp


def _gather(values: Optional[torch.Tensor], ids: torch.Tensor):
    return None if values is None else values.index_select(0, ids)


def _per_v_transform_reduce(
    adj: CompressedAdj,
    majors_are_dst: bool,
    e_op: Callable,
    reduce_op: ReduceOp,
    src_values: Optional[torch.Tensor],
    dst_values: Optional[torch.Tensor],
) -> torch.Tensor:
    majors, minors = adj.majors, adj.minors
    src_ids, dst_ids = (minors, majors) if majors_are_dst else (majors, minors)
    e_vals = e_op(
        src_ids, dst_ids, _gather(src_values, src_ids), _gather(dst_values, dst_ids),
        adj.weights,
    )
    return reduce_op.segment(e_vals, majors, adj.num_majors)


def per_v_transform_reduce_incoming_e(
    g: Graph,
    e_op: Callable,
    *,
    reduce_op: ReduceOp = PLUS,
    src_values: Optional[torch.Tensor] = None,
    dst_values: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[v] = reduce_op over incoming edges of v of e_op (ref :1082); the
    identity where v has none."""
    return _per_v_transform_reduce(g.csc(), True, e_op, reduce_op, src_values, dst_values)


def per_v_transform_reduce_outgoing_e(
    g: Graph,
    e_op: Callable,
    *,
    reduce_op: ReduceOp = PLUS,
    src_values: Optional[torch.Tensor] = None,
    dst_values: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[v] = reduce_op over outgoing edges of v of e_op (ref :1144); the
    identity where v has none."""
    return _per_v_transform_reduce(g.csr(), False, e_op, reduce_op, src_values, dst_values)
