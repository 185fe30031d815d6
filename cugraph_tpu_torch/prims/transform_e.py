"""Whole-edge-set prims: transform_e, transform_reduce_e, count_if_e,
extract_if_e.

Counterpart of ``cugraph_tpu/prims/transform_e.py`` (ref:
cpp/src/prims/transform_reduce_e.cuh, count_if_e.cuh, extract_if_e.cuh).
The port keeps exact edge lengths, so there is no padding to mask: every
per-edge array has ``num_edges`` entries, in the order of the CSR (or of
the CSC for a graph stored without a CSR).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.csr import Graph
from .per_v import _gather
from .reduce_ops import PLUS, ReduceOp


def _edge_args(g: Graph):
    """(adjacency, src ids, dst ids): the CSR, else the CSC."""
    if g.out_adj is not None:
        return g.out_adj, g.out_adj.majors, g.out_adj.minors
    return g.in_adj, g.in_adj.minors, g.in_adj.majors


def _edge_values(g: Graph, e_op: Callable, src_values, dst_values):
    adj, src_ids, dst_ids = _edge_args(g)
    return e_op(
        src_ids, dst_ids, _gather(src_values, src_ids), _gather(dst_values, dst_ids),
        adj.weights,
    )


def transform_e(
    g: Graph, e_op: Callable, *, src_values: Any = None, dst_values: Any = None
) -> torch.Tensor:
    """Per-edge transform -> (E, ...) tensor aligned with the edges."""
    return _edge_values(g, e_op, src_values, dst_values)


def transform_reduce_e(
    g: Graph,
    e_op: Callable,
    *,
    reduce_op: ReduceOp = PLUS,
    init: Any = None,
    src_values: Any = None,
    dst_values: Any = None,
) -> torch.Tensor:
    """Reduce e_op over all edges; feature axes survive (ref
    transform_reduce_e.cuh). Modularity and the clustering metrics use it."""
    return reduce_op.reduce(_edge_values(g, e_op, src_values, dst_values), init)


def count_if_e(
    g: Graph, pred_op: Callable, *, src_values: Any = None, dst_values: Any = None
) -> torch.Tensor:
    """Number of edges satisfying a predicate, int32 (ref count_if_e.cuh)."""

    def e_op(s, d, sv, dv, w):
        return pred_op(s, d, sv, dv, w).to(torch.int32)

    return transform_reduce_e(g, e_op, src_values=src_values, dst_values=dst_values)


def extract_if_e(
    g: Graph, pred_op: Callable, *, src_values: Any = None, dst_values: Any = None
) -> torch.Tensor:
    """Boolean keep-mask over the edges (ref extract_if_e.cuh); as in the
    JAX package, consumers compose masks instead of compacting."""
    return _edge_values(g, pred_op, src_values, dst_values).to(torch.bool)
