"""Vertex-array prims: transform_reduce_v, reduce_v, count_if_v.

Counterpart of ``cugraph_tpu/prims/vertex.py`` (ref:
cpp/src/prims/{transform_reduce_v.cuh, reduce_v.cuh, count_if_v.cuh}):
whole-array reductions on the values' device. The result stays a 0-dim
(or feature-shaped) tensor there; nothing is read on the host.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.csr import Graph
from .reduce_ops import PLUS, ReduceOp


def transform_reduce_v(
    g: Graph,
    v_op: Callable[[torch.Tensor, Any], torch.Tensor],
    values: Any = None,
    *,
    reduce_op: ReduceOp = PLUS,
    init: Any = None,
) -> torch.Tensor:
    """reduce(v_op(vertex_ids, values)) over all vertices."""
    ids = torch.arange(g.num_vertices, dtype=torch.int32, device=g.device)
    return reduce_op.reduce(v_op(ids, values), init)


def reduce_v(
    g: Graph, values: torch.Tensor, *, reduce_op: ReduceOp = PLUS, init: Any = None
) -> torch.Tensor:
    return transform_reduce_v(g, lambda ids, v: v, values, reduce_op=reduce_op, init=init)


def count_if_v(g: Graph, pred_op: Callable, values: Any = None) -> torch.Tensor:
    """Number of vertices where pred_op(ids, values) holds, int32."""
    return transform_reduce_v(g, lambda ids, v: pred_op(ids, v).to(torch.int32), values)
