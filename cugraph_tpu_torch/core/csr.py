"""Graph containers: COO ingest -> CSR and CSC on the device.

Counterpart of ``cugraph_tpu/core/csr.py``. A ``Graph`` may carry both the
out-adjacency (CSR, major = src) and the in-adjacency (CSC, major = dst).
Edges are sorted by (major, minor) with a stable sort, so parallel edges
stay, keep their input order, and their weights follow.

The JAX package pads edge arrays to 128 lanes for XLA's static shapes; the
port keeps exact lengths, so every edge array has ``num_edges`` entries.
A symmetric graph shares one adjacency as its CSR and its CSC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.device import DeviceLike, as_tensor, resolve_device
from ..utils.dtypes import EDGE_DTYPE, VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects
from .symmetrize import symmetrize_edgelist


@dataclasses.dataclass(frozen=True)
class CompressedAdj:
    """One compressed adjacency (CSR if major == src, CSC if major == dst)."""

    offsets: torch.Tensor  # (num_majors + 1,) int32
    minors: torch.Tensor  # (num_edges,) int32, sorted by (major, minor)
    majors: torch.Tensor  # (num_edges,) int32, the major of each edge
    weights: Optional[torch.Tensor]  # (num_edges,) float32 or None
    num_majors: int
    num_minors: int
    num_edges: int
    # merge-path tile plans of the kernels, by items per tile, computed at
    # first use (prims/cuda/_partition.py); not an argument, not compared
    tile_plans: dict = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False
    )

    def degrees(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]


def _build_adj(
    majors: torch.Tensor,
    minors: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_majors: int,
    num_minors: int,
) -> CompressedAdj:
    """Sort edges by the packed int64 key major * num_minors + minor; the
    stable sort keeps parallel edges in input order."""
    key = majors.to(torch.int64) * max(num_minors, 1) + minors.to(torch.int64)
    _, order = torch.sort(key, stable=True)
    del key
    counts = torch.bincount(majors.to(torch.int64), minlength=num_majors)
    offsets = torch.zeros(num_majors + 1, dtype=EDGE_DTYPE, device=majors.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return CompressedAdj(
        offsets=offsets,
        minors=minors[order].contiguous(),
        majors=majors[order].contiguous(),
        weights=None if weights is None else weights[order].contiguous(),
        num_majors=int(num_majors),
        num_minors=int(num_minors),
        num_edges=int(majors.numel()),
    )


@dataclasses.dataclass(frozen=True)
class Graph:
    """Single-device graph.

    ``out_adj``: compressed by src (edges of a vertex = its outgoing edges).
    ``in_adj``:  compressed by dst (edges of a vertex = its incoming edges).
    Symmetric graphs share one structure for both.
    """

    out_adj: Optional[CompressedAdj]
    in_adj: Optional[CompressedAdj]
    num_vertices: int
    num_edges: int
    is_symmetric: bool = False

    @property
    def weighted(self) -> bool:
        adj = self.out_adj if self.out_adj is not None else self.in_adj
        return adj is not None and adj.weights is not None

    @property
    def device(self) -> torch.device:
        adj = self.out_adj if self.out_adj is not None else self.in_adj
        return adj.offsets.device

    def csr(self) -> CompressedAdj:
        """Out-adjacency (major = src)."""
        expects(self.out_adj is not None, "graph stored without out-adjacency")
        return self.out_adj

    def csc(self) -> CompressedAdj:
        """In-adjacency (major = dst); the shared adjacency of a symmetric
        graph stored without one."""
        if self.in_adj is not None:
            return self.in_adj
        expects(
            self.is_symmetric and self.out_adj is not None,
            "graph stored without in-adjacency; rebuild with store='both'",
        )
        return self.out_adj

    # ref: graph_view_t::compute_in_degrees/out_degrees, graph_view.hpp:671-686
    def out_degrees(self) -> torch.Tensor:
        return self.csr().degrees()

    def in_degrees(self) -> torch.Tensor:
        return self.csc().degrees()

    def out_weight_sums(self) -> torch.Tensor:
        return _weight_sums(self.csr())

    def in_weight_sums(self) -> torch.Tensor:
        return _weight_sums(self.csc())


def _weight_sums(adj: CompressedAdj) -> torch.Tensor:
    if adj.weights is None:
        # unweighted: the weight sum is the degree, an O(V) offsets diff
        return adj.degrees().to(WEIGHT_DTYPE)
    out = torch.zeros(adj.num_majors, dtype=WEIGHT_DTYPE, device=adj.weights.device)
    return out.index_add_(0, adj.majors, adj.weights)


def from_edgelist(
    src,
    dst,
    weight=None,
    *,
    num_vertices: Optional[int] = None,
    symmetrize: bool = False,
    store: str = "both",
    is_symmetric: Optional[bool] = None,
    multi: bool = False,
    device: DeviceLike = None,
) -> Graph:
    """Build a Graph from a COO edge list of contiguous int vertex ids.

    src, dst and weight may be numpy arrays, sequences or tensors; they are
    moved to ``device`` (default: the CUDA card) and compressed there.
    store: "both", "out" (CSR only) or "in" (CSC only).
    symmetrize=True unions each edge with its reciprocal (and coalesces
    duplicates unless ``multi``, ``core/symmetrize.py``); the graph is then
    symmetric, as it is when ``is_symmetric`` says so, and one adjacency
    serves as CSR and CSC.
    """
    expects(store in ("both", "out", "in"), f"unknown store {store!r}")
    dev = resolve_device(device)
    src = as_tensor(src, VERTEX_DTYPE, dev)
    dst = as_tensor(dst, VERTEX_DTYPE, dev)
    expects(src.shape == dst.shape and src.dim() == 1, "src/dst length mismatch")
    if weight is not None:
        weight = as_tensor(weight, WEIGHT_DTYPE, dev)
        expects(weight.shape == src.shape, "weight length mismatch")
    if src.numel():
        lo = int(torch.minimum(src.min(), dst.min()).item())
        hi = int(torch.maximum(src.max(), dst.max()).item())
    else:
        lo, hi = 0, -1
    if num_vertices is None:
        num_vertices = hi + 1
    expects(lo >= 0 and hi < num_vertices, "vertex id out of range [0, num_vertices)")
    if symmetrize:
        src, dst, weight = symmetrize_edgelist(src, dst, weight, multi=multi, device=dev)
    sym = bool(symmetrize or is_symmetric)
    out_adj = in_adj = None
    if store in ("both", "out"):
        out_adj = _build_adj(src, dst, weight, num_vertices, num_vertices)
    if store in ("both", "in"):
        if sym and out_adj is not None:
            in_adj = out_adj
        else:
            in_adj = _build_adj(dst, src, weight, num_vertices, num_vertices)
    return Graph(
        out_adj=out_adj,
        in_adj=in_adj,
        num_vertices=int(num_vertices),
        num_edges=int(src.numel()),
        is_symmetric=sym,
    )
