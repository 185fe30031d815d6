"""Keyed-aggregation prims, the Louvain substrate.

Counterpart of ``cugraph_tpu/prims/keyed.py`` (ref:
cpp/src/prims/transform_reduce_e_by_src_dst_key.cuh and
per_v_transform_reduce_dst_key_aggregated_outgoing_e.cuh, which use cuco
hash maps). Keys are dense ids, so "reduce by key" is a segment
reduction. The per-vertex aggregation by the destination's key sorts the
edges once by a packed int64 (src, key) and reduces adjacent runs; the
JAX package gets the same order from two stable argsorts (key, then src).
Ties keep the CSR's edge order in both, so the runs' sums add the same
terms in the same order.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from ..core.csr import Graph
from .reduce_ops import PLUS, ReduceOp
from .transform_e import _edge_args, _edge_values


def transform_reduce_e_by_src_key(
    g: Graph,
    src_keys: torch.Tensor,
    e_op: Callable,
    *,
    num_keys: int,
    reduce_op: ReduceOp = PLUS,
    src_values: Any = None,
    dst_values: Any = None,
) -> torch.Tensor:
    """Reduce e_op per key[src] -> dense (num_keys, ...) tensor."""
    _, src_ids, _ = _edge_args(g)
    e_vals = _edge_values(g, e_op, src_values, dst_values)
    return reduce_op.segment(e_vals, src_keys.index_select(0, src_ids), num_keys)


def transform_reduce_e_by_dst_key(
    g: Graph,
    dst_keys: torch.Tensor,
    e_op: Callable,
    *,
    num_keys: int,
    reduce_op: ReduceOp = PLUS,
    src_values: Any = None,
    dst_values: Any = None,
) -> torch.Tensor:
    """Reduce e_op per key[dst] -> dense (num_keys, ...) tensor."""
    _, _, dst_ids = _edge_args(g)
    e_vals = _edge_values(g, e_op, src_values, dst_values)
    return reduce_op.segment(e_vals, dst_keys.index_select(0, dst_ids), num_keys)


def aggregate_outgoing_e_by_dst_key(
    g: Graph, dst_keys: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Aggregate outgoing edge weights by (src, key[dst]) runs.

    Returns (srcs, keys, agg_weight, run_valid), each of E entries, in
    (src, key) order: where run_valid is True (the first edge of a run)
    the slot holds a unique (src, key) pair with its total weight; every
    slot of a run carries that total. Keys are int32 (any sign)."""
    adj = g.csr()
    keys = dst_keys.to(torch.int32).index_select(0, adj.minors)
    # (src, key) packed into an int64 that sorts like the pair: the key,
    # shifted by 2^31, fills the low 32 bits
    packed = (adj.majors.to(torch.int64) << 32) | (keys.to(torch.int64) + 2**31)
    packed, order = torch.sort(packed, stable=True)
    srcs = adj.majors.index_select(0, order)
    keys = keys.index_select(0, order)
    w = adj.weights
    w = (
        torch.ones(adj.num_edges, dtype=torch.float32, device=keys.device)
        if w is None
        else w.index_select(0, order)
    )
    first = torch.ones_like(packed, dtype=torch.bool)
    first[1:] = packed[1:] != packed[:-1]
    del packed
    run_id = torch.cumsum(first, 0) - 1
    agg = torch.zeros(adj.num_edges, dtype=torch.float32, device=keys.device)
    agg.index_add_(0, run_id, w)
    return srcs, keys, agg.index_select(0, run_id), first


def per_v_transform_reduce_dst_key_aggregated_outgoing_e(
    g: Graph,
    dst_keys: torch.Tensor,
    kv_op: Callable,
    *,
    reduce_op: ReduceOp,
    init: Any = None,
) -> torch.Tensor:
    """For each vertex: aggregate outgoing edge weights by the destination's
    key, transform each (vertex, key, aggregated weight) run with kv_op
    and reduce per vertex (ref prim of the same name).

    kv_op(src_ids, key_ids, agg_weight, run_valid) -> per-run value."""
    srcs, keys, agg, run_valid = aggregate_outgoing_e_by_dst_key(g, dst_keys)
    vals = kv_op(srcs, keys, agg, run_valid)
    out = reduce_op.segment(vals[run_valid], srcs[run_valid], g.num_vertices)
    if init is not None:
        out = reduce_op.combine(out, torch.as_tensor(init, dtype=out.dtype, device=out.device))
    return out
