"""Distributed betweenness centrality by batch replication.

Counterpart of ``cugraph_tpu/dist/mg_centrality.py`` (ref: the reference
computes MG betweenness by replicating the graph to every worker and
splitting the source batch over them, the dask batch path of
python/cugraph/cugraph/centrality/betweenness_centrality.py). Brandes'
algorithm is independent from source to source: every rank holds the
same single-device ``Graph`` on its device, takes its slice of the
sources, runs the single-device ``_brandes_sums`` over it (its sweeps are
``spmm_rows`` launches on the card, a block of sources a launch), and the
per-vertex and per-edge sums merge by a SUM all-reduce over the world.

The sources come from the single-device rule (``sample_sources``), so an
MG run and a single-device run with the same k and seed take the same
sources; rank r (= i * C + j) takes the r-th of the rank count's equal
slices, as the JAX package lays its padded source grid. Results are (V,)
and (E,) tensors on the mesh's device, the same on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..algos.centrality import _brandes_sums, sample_sources
from ..core.csr import Graph
from ..utils.device import resolve_device
from ..utils.dtypes import WEIGHT_DTYPE
from ..utils.error import expects
from .mesh import Mesh2D


def _sources_grid(mesh: Mesh2D, v: int, k: Optional[int], seed: int, device) -> torch.Tensor:
    """This rank's sources: its slice of every vertex (k None) or of
    ``sample_sources``' k, cut in rank-count slices of ceil(n / P)."""
    sources = sample_sources(v, k, seed, device)
    per = -(-sources.numel() // (mesh.rows * mesh.cols))
    rank = mesh.i * mesh.cols + mesh.j
    return sources[rank * per:(rank + 1) * per]


def _mg_brandes_total(mesh: Mesh2D, g: Graph, sources: torch.Tensor, endpoints: bool,
                      with_edges: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The dependencies of this rank's sources, summed over every rank:
    (vertex sums (V,), edge sums (E,) or None). With ``endpoints`` each
    reachable (s, t) pair adds 1 to both ends."""
    bc, ebc, reached_by, reaches = _brandes_sums(g, sources, with_edges=with_edges)
    if endpoints:
        bc = bc + reached_by
        bc = bc.index_add(0, sources.long(), reaches.to(WEIGHT_DTYPE))
    dist.all_reduce(bc)
    if ebc is not None:
        dist.all_reduce(ebc)
    return bc, ebc


def _check(mesh: Mesh2D, g: Graph) -> None:
    dev = resolve_device(mesh.device)
    expects(g.device == dev, f"the graph is on {g.device}, the mesh's ranks on {dev}")


def mg_betweenness_centrality(
    mesh: Mesh2D,
    g: Graph,
    k: Optional[int] = None,
    normalized: bool = True,
    endpoints: bool = False,
    seed: int = 0,
) -> torch.Tensor:
    """Batch-replicated MG betweenness over the single-device ``Graph``
    that every rank holds on its device; the result and its scaling are
    those of ``algos.centrality.betweenness_centrality``."""
    _check(mesh, g)
    v = g.num_vertices
    mine = _sources_grid(mesh, v, k, seed, g.device)
    bc, _ = _mg_brandes_total(mesh, g, mine, endpoints, with_edges=False)
    if k is not None:
        bc = bc * (v / max(int(k), 1))
    if g.is_symmetric:
        bc = bc / 2.0
    if normalized and v > 2:
        denom = v * (v - 1) if endpoints else (v - 1) * (v - 2)
        if g.is_symmetric:
            denom = denom / 2.0
        bc = bc / denom
    return bc


def mg_edge_betweenness_centrality(
    mesh: Mesh2D,
    g: Graph,
    k: Optional[int] = None,
    normalized: bool = True,
    seed: int = 0,
) -> torch.Tensor:
    """Batch-replicated MG edge betweenness over the edges of g.csr(), in
    its order (E,); the JAX package returns its padded edge slots."""
    _check(mesh, g)
    v = g.num_vertices
    mine = _sources_grid(mesh, v, k, seed, g.device)
    _, ebc = _mg_brandes_total(mesh, g, mine, endpoints=False, with_edges=True)
    if k is not None:
        ebc = ebc * (v / max(int(k), 1))
    if g.is_symmetric:
        ebc = ebc / 2.0
    if normalized:
        denom = v * (v - 1)
        if g.is_symmetric:
            denom = denom / 2.0
        ebc = ebc / max(denom, 1)
    return ebc
