"""Distributed graph container and its construction, one rank at a time.

Counterpart of ``cugraph_tpu/dist/mg_graph.py`` (ref:
create_graph_from_edgelist_impl.cuh, renumber_edgelist_impl.cuh:96,
shuffle_wrappers.hpp:42,126). Every rank streams the same edge chunks and
keeps only the edges of its own blocks (the JAX package's multi-host
contract, without its exchange), then compresses them on its device with
the same ``_build_adj`` as the single-device graph.

Differences by design: the JAX package stores each rank's edges as
(C blocks, R src-row groups, g_pad) padded slabs, for XLA's static shapes
and its ring gather mode; the port keeps exact lengths in two compressed
adjacencies. Its vertex values are per-rank (vp, ...) tensors where the
JAX package holds (R, C, vp, ...) global arrays. The DCSR src-side arrays
(``src_nzd`` and the rest, JAX mg_graph.py:60-66) are derived from
``out_block`` at their first use (``src_dcsr``) and kept in
``MGGraph.cache``: its edges are already sorted by (span-local src, b * vp
+ local dst), which for the rank's mesh row i is the order of the global
dst (b * R + i) * vp + local dst, so no second pass over the edges is
made. They are unpadded; the JAX package's edge-slot stride ``d_pad`` is
kept for the edge ids, counted at ingest (every rank sees every edge).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..core.convert import decompress_to_edgelist
from ..core.csr import CompressedAdj, Graph, _build_adj
from ..core.symmetrize import symmetrize_edgelist
from ..utils.device import DeviceLike, as_tensor, resolve_device
from ..utils.dtypes import VERTEX_DTYPE, WEIGHT_DTYPE
from ..utils.error import expects
from .mesh import Mesh2D, all_gather_rows
from .partition import Partition2D

LANE = 128  # the JAX package pads edge slots to this many lanes


@dataclasses.dataclass(frozen=True)
class MGGraph:
    """One rank's share of a 2D-partitioned graph.

    ``in_block`` compresses this rank's edges by dst: major b * vp + local
    dst (C * vp majors, block after block), minor the src's index in the
    column span (R * vp minors). ``out_block`` holds the same edges
    compressed by that src (R * vp majors, C * vp minors). Both carry the
    weights of a weighted graph.
    """

    in_block: CompressedAdj
    out_block: CompressedAdj
    block_counts: torch.Tensor  # (C,) int64: edges of each block on this rank
    rows: int
    cols: int
    vp: int
    num_vertices: int
    num_edges: int  # global
    # the JAX package's edge slots a rank (mg_graph.py:330-333): the largest
    # local edge count over the ranks, rounded up to LANE
    d_pad: int
    is_symmetric: bool = False
    # the selected edges' frame of ``MGPropertyGraph.extract_subgraph``
    edge_data: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)
    # what is derived from the blocks once and kept: the ring's sub-blocks,
    # the DCSR arrays, the similarity paths' oriented adjacency
    cache: dict = dataclasses.field(default_factory=dict, init=False, compare=False, repr=False)

    @property
    def partition(self) -> Partition2D:
        return Partition2D(rows=self.rows, cols=self.cols,
                           num_vertices=self.num_vertices, vp=self.vp)

    @property
    def weighted(self) -> bool:
        return self.in_block.weights is not None


class SrcDcsr(NamedTuple):
    """The DCSR src-side adjacency of a rank (JAX mg_graph.py:60-66): the
    sources with at least one local edge, sorted (span-local ids), their
    offsets and the total, and each edge's global dst (int32) and weight
    (None unweighted) in that order."""

    src_nzd: torch.Tensor
    src_nzd_offsets: torch.Tensor
    src_csr_dsts: torch.Tensor
    src_csr_weights: Optional[torch.Tensor]


def src_dcsr(mesh: Mesh2D, mgg: MGGraph) -> SrcDcsr:
    """This rank's ``SrcDcsr``, derived from ``out_block`` at the first
    call and kept in ``mgg.cache``. No collective."""
    arrays = mgg.cache.get("dcsr")
    if arrays is None:
        blk, vp = mgg.out_block, mgg.vp
        nzd = torch.nonzero(blk.degrees() > 0).reshape(-1).to(VERTEX_DTYPE)
        minors = blk.minors
        arrays = mgg.cache["dcsr"] = SrcDcsr(
            src_nzd=nzd,
            src_nzd_offsets=torch.cat([blk.offsets[nzd.long()], blk.offsets[-1:]]),
            src_csr_dsts=((minors // vp * mgg.rows + mesh.i) * vp + minors % vp).to(VERTEX_DTYPE),
            src_csr_weights=blk.weights,
        )
    return arrays


ChunkSource = Union[
    Sequence[Tuple[object, object, Optional[object]]],
    Callable[[], Iterable[Tuple[object, object, Optional[object]]]],
]


def _chunk_iter(chunks: ChunkSource):
    if callable(chunks):
        return chunks()
    return iter(chunks)


def mg_renumber_map(
    chunks: ChunkSource, num_vertices: int, *, device: DeviceLike = None
) -> torch.Tensor:
    """Degree-descending renumber map from streamed edge chunks: one pass
    sums total degrees on ``device``, then a stable descending sort.
    Returns new_to_old (int32); memory O(V) whatever E."""
    dev = resolve_device(device)
    degrees = torch.zeros(num_vertices, dtype=torch.int64, device=dev)
    for chunk in _chunk_iter(chunks):
        for ids in chunk[:2]:
            degrees += torch.bincount(as_tensor(ids, torch.int64, dev), minlength=num_vertices)
    _, new_to_old = torch.sort(degrees, descending=True, stable=True)
    return new_to_old.to(VERTEX_DTYPE)


def distribute_edgelist_chunks(
    mesh: Mesh2D,
    chunks: ChunkSource,
    *,
    num_vertices: int,
    symmetrize: bool = False,
    is_symmetric: bool = False,
    renumber: bool = False,
) -> Union[MGGraph, Tuple[MGGraph, torch.Tensor]]:
    """Streamed 2D ingest: this rank's MGGraph from every rank's pass over
    the same chunks.

    chunks: a re-iterable sequence, or a zero-argument callable returning
    an iterator, of (src, dst, weight or None) numpy arrays or tensors
    with ids in [0, num_vertices). Every rank must see the same chunks.
    symmetrize=True emits both directions of each chunk's edges (no
    coalescing across chunks: parallel edges stay, as in the reference's
    multigraph ingest). renumber=True first takes a degree-counting pass
    (``mg_renumber_map``) and returns (graph, new_to_old).
    """
    r, c = mesh.rows, mesh.cols
    part = Partition2D.create(r, c, num_vertices)
    part.validate()
    vp, span = part.vp, r * part.vp
    dev = mesh.device

    old_to_new = new_to_old = None
    if renumber:
        new_to_old = mg_renumber_map(chunks, num_vertices, device=dev)
        old_to_new = torch.empty_like(new_to_old)
        old_to_new[new_to_old.long()] = torch.arange(
            num_vertices, dtype=VERTEX_DTYPE, device=dev)

    srcs, majors, weights = [], [], []
    block_counts = torch.zeros(c, dtype=torch.int64, device=dev)
    rank_counts = torch.zeros(r * c, dtype=torch.int64, device=dev)
    num_edges = 0
    for chunk in _chunk_iter(chunks):
        src = as_tensor(chunk[0], torch.int64, dev)
        dst = as_tensor(chunk[1], torch.int64, dev)
        w = chunk[2] if len(chunk) > 2 else None
        w = None if w is None else as_tensor(w, WEIGHT_DTYPE, dev)
        if src.numel():
            lo = int(torch.minimum(src.min(), dst.min()))
            hi = int(torch.maximum(src.max(), dst.max()))
            expects(lo >= 0 and hi < num_vertices,
                    "vertex id out of range [0, num_vertices)")
        if old_to_new is not None:
            src, dst = old_to_new[src].long(), old_to_new[dst].long()
        if symmetrize:
            src, dst = torch.cat([src, dst]), torch.cat([dst, src])
            w = None if w is None else torch.cat([w, w])
        num_edges += src.numel()
        i, j, b = part.edge_block(src, dst)
        rank_counts += torch.bincount(i * c + j, minlength=r * c)
        mine = (i == mesh.i) & (j == mesh.j)
        b = b[mine]
        srcs.append(src[mine] - mesh.j * span)
        majors.append(b * vp + dst[mine] % vp)
        weights.append(None if w is None else w[mine])
        block_counts += torch.bincount(b, minlength=c)

    src_l = torch.cat(srcs).to(VERTEX_DTYPE) if srcs else torch.empty(0, dtype=VERTEX_DTYPE, device=dev)
    maj_l = torch.cat(majors).to(VERTEX_DTYPE) if majors else torch.empty_like(src_l)
    w_l = None
    if any(w is not None for w in weights):
        # an unweighted chunk among weighted ones weighs 1, as in the JAX package
        w_l = torch.cat([
            torch.ones(s.numel(), dtype=WEIGHT_DTYPE, device=dev) if w is None else w
            for s, w in zip(srcs, weights)
        ])
    mgg = MGGraph(
        in_block=_build_adj(maj_l, src_l, w_l, c * vp, span),
        out_block=_build_adj(src_l, maj_l, w_l, span, c * vp),
        block_counts=block_counts,
        rows=r,
        cols=c,
        vp=vp,
        num_vertices=int(num_vertices),
        num_edges=int(num_edges),
        d_pad=-(-max(int(rank_counts.max()), 1) // LANE) * LANE,
        is_symmetric=bool(is_symmetric or symmetrize),
    )
    if renumber:
        return mgg, new_to_old
    return mgg


def distribute_edgelist(
    mesh: Mesh2D,
    src,
    dst,
    weight=None,
    *,
    num_vertices: Optional[int] = None,
    symmetrize: bool = False,
    is_symmetric: bool = False,
) -> MGGraph:
    """Single-shot ingest: one chunk through ``distribute_edgelist_chunks``.
    symmetrize=True unions each edge with its reciprocal and coalesces
    duplicates first (``core/symmetrize.py``)."""
    dev = mesh.device
    src = as_tensor(src, VERTEX_DTYPE, dev)
    dst = as_tensor(dst, VERTEX_DTYPE, dev)
    if symmetrize:
        src, dst, weight = symmetrize_edgelist(src, dst, weight, device=dev)
        is_symmetric = True
    if num_vertices is None:
        num_vertices = int(torch.maximum(src.max(), dst.max())) + 1 if src.numel() else 0
    return distribute_edgelist_chunks(
        mesh, [(src, dst, weight)], num_vertices=int(num_vertices),
        is_symmetric=is_symmetric,
    )


def distribute_graph(mesh: Mesh2D, g: Graph) -> MGGraph:
    """This rank's share of a single-device Graph that every rank holds."""
    src, dst, w = decompress_to_edgelist(g)
    return distribute_edgelist(
        mesh, src, dst, w, num_vertices=g.num_vertices, is_symmetric=g.is_symmetric,
    )


def shard_vertex_values(mesh: Mesh2D, mgg: MGGraph, values) -> torch.Tensor:
    """This rank's (vp, ...) slice of a global (V, ...) vertex array: range
    q = j*R + i, zero-padded past V, on the mesh's device."""
    values = torch.as_tensor(values)
    lo, hi = mgg.partition.range_of(mesh.i, mesh.j)
    out = torch.zeros((mgg.vp,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=mesh.device)
    hi = min(hi, mgg.num_vertices)
    if hi > lo:
        out[: hi - lo] = values[lo:hi].to(mesh.device)
    return out


def unshard_vertex_values(mgg: MGGraph, local: torch.Tensor) -> torch.Tensor:
    """The global (V, ...) array from every rank's (vp, ...) slice: an
    all-gather over the world (rank order i*C + j), reordered to range
    order q = j*R + i. Every rank must call it."""
    tail = tuple(local.shape[1:])
    by_rank = all_gather_rows(local).view((mgg.rows, mgg.cols, mgg.vp) + tail)  # [i, j]
    return by_rank.transpose(0, 1).reshape((-1,) + tail)[: mgg.num_vertices]
