"""GNN neighbourhood aggregation = SpMM over the graph's CSC.

Counterpart of ``cugraph_tpu/gnn/aggregators.py`` with the same branch
order: a dense matmul for V <= 8192, else the ``spmm_rows`` kernel; mean
divides by max(in_degree, 1); max is a plain ``scatter_reduce``.
"""

from __future__ import annotations

import torch

from ..core.csr import Graph
from ..prims.cuda import SpmmRowsFunction, spmm_rows
from ..prims.dense_spmm import dense_adj_for, dense_spmm
from ..prims.per_v import per_v_transform_reduce_incoming_e
from ..prims.reduce_ops import MAXIMUM


def _row_precision(features: torch.Tensor, precision: str) -> str:
    """The kernel mode for ``precision`` on the card ("bf16_pair" ->
    "bf16", "f32" -> "f32"). On the CPU the JAX package computes exact f32
    (its backend split at cugraph_tpu/prims/pallas/spmm_row.py:326-333), and
    so does the port."""
    if precision not in ("bf16_pair", "f32"):
        raise ValueError(f"unknown precision {precision!r}")
    if features.device.type == "cpu" or precision == "f32":
        return "f32"
    return "bf16"


def spmm_aggregate(
    g: Graph,
    features: torch.Tensor,
    *,
    op: str = "mean",
    use_weights: bool = False,
    precision: str = "bf16_pair",
) -> torch.Tensor:
    """out[v] = op over incoming neighbours' feature rows. op: sum|mean|max.

    precision (sparse path on the card): "bf16_pair" (default) rounds the
    operands to bf16 and accumulates in f32; "f32" is IEEE f32. The sparse
    path is differentiable in ``features``: its backward is ``spmm_rows``
    over the graph's CSR, in the same precision, so a graph stored without
    one raises when a gradient is asked for."""
    if op in ("sum", "mean"):
        a = dense_adj_for(g, use_weights=use_weights)
        if a is not None:
            agg = dense_spmm(a, features)
        else:
            x = features.to(torch.float32).contiguous()
            mode = _row_precision(features, precision)
            if torch.is_grad_enabled() and features.requires_grad:
                agg = SpmmRowsFunction.apply(x, g.csc(), g.csr(), mode, use_weights)
            else:
                agg = spmm_rows(g.csc(), x, precision=mode, use_weights=use_weights)
            agg = agg.to(features.dtype)
        if op == "mean":
            deg = g.in_degrees().to(features.dtype)
            agg = agg / torch.clamp(deg, min=1)[:, None]
        return agg
    if op == "max":

        def e_op(s, d, sv, dv, w):
            return sv * w[:, None] if (use_weights and w is not None) else sv

        agg = per_v_transform_reduce_incoming_e(
            g, e_op, reduce_op=MAXIMUM, src_values=features
        )
        # isolated vertices: -inf -> 0
        return torch.where(torch.isfinite(agg), agg, 0.0)
    raise ValueError(f"unknown op {op!r}")


def gcn_aggregate(g: Graph, features: torch.Tensor) -> torch.Tensor:
    """Symmetric-normalized aggregation: D^-1/2 (A+I) D^-1/2 X (Kipf-Welling)."""
    deg = g.in_degrees().to(features.dtype) + 1.0
    dinv = torch.rsqrt(deg)
    scaled = features * dinv[:, None]
    agg = spmm_aggregate(g, scaled, op="sum") + scaled  # +I self edge
    return agg * dinv[:, None]


def sage_aggregate(g: Graph, features: torch.Tensor, *, op: str = "mean") -> torch.Tensor:
    """GraphSAGE: concat(self, neighbour-agg)."""
    nbr = spmm_aggregate(g, features, op=op)
    return torch.cat([features, nbr], dim=-1)
