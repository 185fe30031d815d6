"""Core number and k-core.

Counterpart of ``cugraph_tpu/algos/cores.py`` (ref:
cpp/src/cores/core_number_impl.cuh, frontier peeling :227-235, and
k_core_impl.cuh).

Dense peeling: at level k, alive vertices whose residual degree is at
most k are dropped, and get core number k, until a round drops none;
then k grows by one, until no vertex is alive. The JAX package nests two
``while_loop``s; here they are host loops that read one ``any()`` an
inner round and one an outer round. ``core_number_rounds`` reports how
many inner rounds the last call took.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.convert import induced_subgraph
from ..core.csr import Graph
from ..prims.per_v import per_v_transform_reduce_incoming_e, per_v_transform_reduce_outgoing_e
from ..utils.error import expects

DEGREE_TYPES = ("incoming", "outgoing", "incoming_outgoing")


def _residual_degree(g: Graph, alive: torch.Tensor, degree_type: str) -> torch.Tensor:
    out = torch.zeros(g.num_vertices, dtype=torch.int32, device=g.device)
    if degree_type in ("outgoing", "incoming_outgoing"):
        out += per_v_transform_reduce_outgoing_e(
            g, lambda s, d, sv, dv, w: dv.to(torch.int32), dst_values=alive
        )
    if degree_type in ("incoming", "incoming_outgoing"):
        out += per_v_transform_reduce_incoming_e(
            g, lambda s, d, sv, dv, w: sv.to(torch.int32), src_values=alive
        )
    return out


def core_number(g: Graph, degree_type: str = "incoming_outgoing") -> torch.Tensor:
    """Core number per vertex (int32; degree_type as in the C API:
    incoming / outgoing / incoming_outgoing).

    As in the JAX package and cuGraph, incoming_outgoing on a symmetric
    graph counts each undirected edge twice, so core numbers are twice the
    undirected ones."""
    expects(degree_type in DEGREE_TYPES, f"invalid degree_type {degree_type!r}")
    alive = torch.ones(g.num_vertices, dtype=torch.bool, device=g.device)
    core = torch.zeros(g.num_vertices, dtype=torch.int32, device=g.device)
    k, rounds = 0, 0
    while bool(alive.any()):
        while True:
            drop = alive & (_residual_degree(g, alive, degree_type) <= k)
            rounds += 1
            if not bool(drop.any()):
                break
            core = torch.where(drop, k, core)
            alive &= ~drop
        k += 1
    core_number.rounds = rounds
    return core


core_number.rounds = 0


def k_core(
    g: Graph, k: int, core_numbers=None, degree_type: str = "incoming_outgoing"
) -> Tuple[Graph, torch.Tensor]:
    """The k-core subgraph: (subgraph, vertex_map) of the vertices whose
    core number is at least k (ref: k_core_impl.cuh)."""
    if core_numbers is None:
        core_numbers = core_number(g, degree_type)
    core_numbers = torch.as_tensor(core_numbers, device=g.device)
    return induced_subgraph(g, torch.nonzero(core_numbers >= k).squeeze(1))
